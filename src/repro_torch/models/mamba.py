"""Mamba-2 (SSD: state-space duality, arXiv:2405.21060) mixer.
Counterpart of ``repro.models.mamba``.

Training and prefill use the chunked dual form: intra-chunk attention-like
products plus an inter-chunk state recurrence, a loop over the chunks.
Decode is the O(1) recurrent step.  ngroups = 1 (B/C shared across heads),
following the 130m config.

Shapes: d_inner = expand * d_model; H = d_inner / head_dim (P); state N.
State: h (B, H, P, N).  Conv state: (B, conv_width - 1, d_conv) where
d_conv = d_inner + 2N (the xBC channels), in the activation dtype.

Arithmetic runs in float32 for float32 and bfloat16 activations, as in the
JAX package, and in float64 for float64 ones (``_acc``), so a float64 run
is a reference for the float32 one.

One difference from the JAX package, in the backward pass only: the
intra-chunk decay L[t, j] = exp(cum_t - cum_j) is masked to t >= j
before the exp (``diff`` set to -inf above the diagonal).  The JAX
package takes ``where(t >= j, exp(diff), 0)``; above the diagonal
``diff`` is a positive sum of -dt * A that overflows exp to inf at full
width (A down to -24, 63 steps), and the backward multiplies a zero
cotangent by inf, a NaN.  The forward values are the same everywhere,
and so are the gradients wherever JAX's are finite.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.device import require_device


def mamba_dims(d_model: int, s: SSMConfig):
    d_inner = s.expand * d_model
    nheads = d_inner // s.head_dim
    d_conv = d_inner + 2 * s.state_dim
    return d_inner, nheads, d_conv


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The SSD's arithmetic dtype: float32, or float64 for float64."""
    return torch.promote_types(dtype, torch.float32)


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0), with no
    linear branch above a threshold (``F.softplus`` switches at 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def init_mamba_params(gen: torch.Generator, d_model: int, s: SSMConfig,
                      dtype) -> dict:
    """Random parameters drawn from ``gen`` on its device.  The draws
    differ from ``jax.random``'s; tests carry the JAX parameters across."""
    d_inner, H, d_conv = mamba_dims(d_model, s)
    dev = gen.device
    d_in_proj = 2 * d_inner + 2 * s.state_dim + H    # z, x, B, C, dt
    w_in = torch.randn((d_model, d_in_proj), generator=gen, device=dev)
    conv_w = torch.randn((s.conv_width, d_conv), generator=gen, device=dev)
    u = torch.rand((H,), generator=gen, device=dev)
    dt = torch.exp(u * float(np.log(s.dt_max) - np.log(s.dt_min))
                   + float(np.log(s.dt_min)))
    dt_bias = dt + torch.log(-torch.expm1(-dt))       # inverse softplus
    w_out = torch.randn((d_inner, d_model), generator=gen, device=dev)
    f32 = torch.float32
    return {
        "w_in": (w_in * float(1.0 / np.sqrt(d_model))).to(dtype),
        "conv_w": (conv_w * 0.1).to(dtype),
        "conv_b": torch.zeros((d_conv,), dtype=dtype, device=dev),
        "a_log": torch.log(torch.arange(1, H + 1, dtype=f32, device=dev)),
        "dt_bias": dt_bias.to(f32),
        "d_skip": torch.ones((H,), dtype=f32, device=dev),
        "norm": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "w_out": (w_out * float(1.0 / np.sqrt(d_inner))).to(dtype),
    }


def _split_in_proj(proj, d_inner, N, H):
    z = proj[..., :d_inner]
    xBC = proj[..., d_inner:2 * d_inner + 2 * N]
    dt = proj[..., 2 * d_inner + 2 * N:]
    return z, xBC, dt


def _causal_conv(xBC, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv over the sequence.  xBC: (B, S, Cc); conv_w:
    (W, Cc); conv_state: (B, W-1, Cc) trailing context (prefill chaining).
    The taps are summed in the JAX package's order, i = 0..W-1."""
    W = conv_w.shape[0]
    S = xBC.shape[1]
    if conv_state is None:
        pad = xBC.new_zeros((xBC.shape[0], W - 1) + tuple(xBC.shape[2:]))
    else:
        pad = conv_state.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)
    out = sum(xp[:, i:i + S] * conv_w[i] for i in range(W))
    new_state = xp[:, xp.shape[1] - (W - 1):]
    y = F.silu((out + conv_b).to(_acc(xBC.dtype))).to(xBC.dtype)
    return y, new_state


def _gated_rmsnorm(y, z, scale, eps=1e-5):
    y = y * F.silu(z.to(y.dtype))
    var = torch.mean(torch.square(y), dim=-1, keepdim=True)
    return y * torch.rsqrt(var + eps) * (1.0 + scale.to(y.dtype))


def ssd_forward(params: dict, x_in: torch.Tensor, s: SSMConfig,
                init_state: Optional[dict] = None,
                return_state: bool = False):
    """Chunked SSD.  x_in: (B, S, d_model) with S a multiple of the chunk
    size.  Returns y (B, S, d_model) and, with ``return_state``, the final
    {"h", "conv"} state."""
    B, S, d_model = x_in.shape
    d_inner, H, d_conv = mamba_dims(d_model, s)
    N, P, Q = s.state_dim, s.head_dim, s.chunk_size
    if S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"SSD chunk size {Q}")
    nc = S // Q
    f = _acc(x_in.dtype)

    proj = x_in @ params["w_in"]
    z, xBC, dt_raw = _split_in_proj(proj, d_inner, N, H)
    xBC, conv_state = _causal_conv(
        xBC, params["conv_w"], params["conv_b"],
        None if init_state is None else init_state["conv"])
    x = xBC[..., :d_inner].reshape(B, S, H, P).to(f)
    Bm = xBC[..., d_inner:d_inner + N].to(f)                     # (B,S,N)
    Cm = xBC[..., d_inner + N:].to(f)                            # (B,S,N)

    dt = _softplus(dt_raw.to(f) + params["dt_bias"].to(f))      # (B,S,H)
    A = -torch.exp(params["a_log"].to(f))                        # (H,)
    log_a = dt * A                                               # <= 0

    # chunk views
    xc = x.reshape(B, nc, Q, H, P)
    Bc = Bm.reshape(B, nc, Q, N)
    Cc = Cm.reshape(B, nc, Q, N)
    dtc = dt.reshape(B, nc, Q, H)
    cum = torch.cumsum(log_a.reshape(B, nc, Q, H), dim=2)        # inclusive
    chunk_decay = cum[:, :, -1]                                  # (B,nc,H)

    # intra-chunk (dual, attention-like) term:
    # L[t, j] = exp(cum_t - cum_j) for t >= j, masked BEFORE the exp
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # (B,nc,Q,Q,H)
    above = torch.ones((Q, Q), dtype=torch.bool, device=x.device).triu(1)
    L = torch.exp(diff.masked_fill(above[None, None, :, :, None],
                                   -torch.inf))
    cb = torch.einsum("bctn,bcjn->bctj", Cc, Bc)                 # (B,nc,Q,Q)
    scores = cb[..., None] * L * dtc[:, :, None, :, :]           # (B,nc,Q,Q,H)
    y_intra = torch.einsum("bctjh,bcjhp->bcthp", scores, xc)

    # each chunk's contribution to the state carried out of it:
    # sum_j exp(cum_end - cum_j) dt_j B_j x_j
    w_end = torch.exp(chunk_decay[:, :, None, :] - cum) * dtc    # (B,nc,Q,H)
    chunk_state = torch.einsum("bcjhp,bcjn->bchpn", xc * w_end[..., None],
                               Bc)

    # inter-chunk recurrence over the chunk index
    h = torch.zeros((B, H, P, N), dtype=f, device=x.device) \
        if init_state is None else init_state["h"].to(f)
    h_prevs = []
    decay = torch.exp(chunk_decay)
    for c in range(nc):
        h_prevs.append(h)                                        # entering c
        h = h * decay[:, c, :, None, None] + chunk_state[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                        # (B,nc,H,P,N)

    y_inter = torch.einsum("bctn,bchpn->bcthp", Cc, h_prevs) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(B, S, H, P)
    y = y + params["d_skip"].to(f)[None, None, :, None] * x
    y = _gated_rmsnorm(y.reshape(B, S, d_inner), z, params["norm"])
    out = y.to(x_in.dtype) @ params["w_out"]
    if return_state:
        return out, {"h": h, "conv": conv_state}
    return out


def mamba_decode_step(params: dict, x_in: torch.Tensor, state: dict,
                      s: SSMConfig):
    """Single-token recurrent step.  x_in: (B, d_model); state {"h",
    "conv"}.  Returns (y (B, d_model), new state); the state passed in is
    not written."""
    B, d_model = x_in.shape
    d_inner, H, d_conv = mamba_dims(d_model, s)
    N, P = s.state_dim, s.head_dim
    f = _acc(x_in.dtype)
    proj = x_in @ params["w_in"]
    z, xBC, dt_raw = _split_in_proj(proj, d_inner, N, H)
    # conv: append the token, take the last W window
    window = torch.cat([state["conv"].to(xBC.dtype), xBC[:, None]], dim=1)
    out = torch.einsum("bwc,wc->bc", window, params["conv_w"]) \
        + params["conv_b"]
    xBC = F.silu(out.to(f))
    new_conv = window[:, 1:]
    x = xBC[:, :d_inner].reshape(B, H, P)
    Bm = xBC[:, d_inner:d_inner + N]
    Cm = xBC[:, d_inner + N:]
    dt = _softplus(dt_raw.to(f) + params["dt_bias"].to(f))      # (B,H)
    A = -torch.exp(params["a_log"].to(f))
    a = torch.exp(dt * A[None])                                  # (B,H)
    h = state["h"].to(f) * a[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dt, Bm, x)
    y = torch.einsum("bn,bhpn->bhp", Cm, h)
    y = y + params["d_skip"].to(f)[None, :, None] * x
    y = _gated_rmsnorm(y.reshape(B, d_inner), z, params["norm"])
    out = y.to(x_in.dtype) @ params["w_out"]
    return out, {"h": h, "conv": new_conv}


def init_mamba_state(batch: int, d_model: int, s: SSMConfig, dtype,
                     device="cuda"):
    """Zero state on ``device``: h (B, H, P, N) float32, conv (B, W-1,
    d_conv) in ``dtype``."""
    device = require_device(device)
    d_inner, H, d_conv = mamba_dims(d_model, s)
    return {
        "h": torch.zeros((batch, H, s.head_dim, s.state_dim),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, d_conv), dtype=dtype,
                            device=device),
    }
