"""Decoder layers and period specs of the model track (counterpart of
``repro.models.blocks``): attention layers (``"A"``) with a dense MLP and
Mamba-2 layers (``"M"``).

Layers are grouped in "periods": the smallest repeating pattern of layer
kinds and MoE placement.  Params of one period are a dict ``{"layer_0":
{...}, ...}``; the full stack adds a leading period axis to every leaf,
as in the JAX package, and the forward passes take views of it.  MoE
layers (``repro.models.moe``) and the encoder-decoder's cross-attention
are not ported yet: they raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.plane import tree_map, tree_paths
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models.common import (apply_rope, dense_init, rms_norm,
                                       rope_frequencies)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str          # 'A' | 'M'
    use_moe: bool
    has_mlp: bool      # dense MLP present (False for mamba2 pure blocks)


def period_spec(cfg: ModelConfig) -> List[LayerSpec]:
    pat = cfg.layer_pattern
    moe_n = cfg.moe.every_n_layers if cfg.moe else 1
    plen = int(np.lcm(len(pat), moe_n)) if cfg.moe else len(pat)
    specs = []
    for i in range(plen):
        kind = pat[i % len(pat)]
        use_moe = cfg.moe is not None and (i % moe_n == moe_n - 1)
        has_mlp = (cfg.d_ff > 0) and not use_moe
        specs.append(LayerSpec(kind, use_moe, has_mlp))
    return specs


def num_periods(cfg: ModelConfig) -> int:
    plen = len(period_spec(cfg))
    if cfg.num_layers % plen:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not a "
                         f"whole number of {plen}-layer periods")
    return cfg.num_layers // plen


def check_ported(cfg: ModelConfig, spec: LayerSpec = None) -> None:
    """Raise ``NotImplementedError`` naming the module a config or layer
    needs that the port does not have yet."""
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder (encoder, cross-attention, "
            "repro.models.lm.encoder_forward) is not ported yet")
    for s in [spec] if spec is not None else period_spec(cfg):
        if s.use_moe:
            raise NotImplementedError(
                f"{cfg.name}: MoE layers (repro.models.moe) are not ported "
                "yet")


# ---------------------------------------------------------------- init ----

def init_attn_params(gen: torch.Generator, cfg: ModelConfig, dtype):
    d, Hq, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    wo = torch.randn((Hq, Dh, d), generator=gen, device=gen.device)
    p = {
        "wq": dense_init(gen, d, (Hq, Dh), dtype),
        "wk": dense_init(gen, d, (Hkv, Dh), dtype),
        "wv": dense_init(gen, d, (Hkv, Dh), dtype),
        "wo": (wo / float(np.sqrt(Hq * Dh))).to(dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((Dh,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.zeros((Dh,), dtype=dtype, device=gen.device)
    return p


def init_mlp_params(gen: torch.Generator, cfg: ModelConfig, dtype):
    d, f = cfg.d_model, cfg.d_ff
    p = {
        "w_in": dense_init(gen, d, (f,), dtype),
        "w_out": dense_init(gen, f, (d,), dtype),
    }
    if cfg.gated_mlp:
        p["w_gate"] = dense_init(gen, d, (f,), dtype)
    return p


def init_layer_params(gen: torch.Generator, cfg: ModelConfig,
                      spec: LayerSpec, dtype):
    check_ported(cfg, spec)
    d = cfg.d_model
    p = {"ln1": torch.zeros((d,), dtype=dtype, device=gen.device)}
    if spec.kind == "A":
        p["attn"] = init_attn_params(gen, cfg, dtype)
    else:
        p["mamba"] = mamba_lib.init_mamba_params(gen, d, cfg.ssm, dtype)
    if spec.has_mlp:
        p["ln2"] = torch.zeros((d,), dtype=dtype, device=gen.device)
        p["mlp"] = init_mlp_params(gen, cfg, dtype)
    return p


def init_period_params(gen: torch.Generator, cfg: ModelConfig, dtype):
    return {f"layer_{j}": init_layer_params(gen, cfg, spec, dtype)
            for j, spec in enumerate(period_spec(cfg))}


def init_stacked_params(gen: torch.Generator, cfg: ModelConfig, dtype):
    """Period params with a leading ``num_periods`` axis on every leaf,
    drawn period by period into the stacked tensors (so the stack is never
    held twice)."""
    n = num_periods(cfg)
    period = init_period_params(gen, cfg, dtype)
    stack = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), period)
    for i in range(n):
        if i:
            period = init_period_params(gen, cfg, dtype)
        for (_, s), (_, x) in zip(tree_paths(stack), tree_paths(period)):
            s[i].copy_(x)
    return stack


# --------------------------------------------------------------- apply ----

def _proj(x, w):
    """x (..., d) @ w (d, *out) -> (..., *out), in x's dtype."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(
        x.shape[:-1] + w.shape[1:])


def mlp_forward(p, x, cfg: ModelConfig):
    h = x @ p["w_in"]
    if cfg.gated_mlp:
        g = x @ p["w_gate"]
        h = F.silu(g.float()).to(x.dtype) * h
    else:   # jax.nn.gelu's default: the tanh approximation
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ p["w_out"]


def _qk_norm(p, q, k, cfg: ModelConfig):
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k


def attn_forward(p, x, cfg: ModelConfig, *, angles, q_block=512,
                 kv_block=512):
    """Full-sequence causal attention (prefill), with the config's sliding
    window.  x: (B, S, d).  Returns (y, (k, v)) with k, v (B, S, Hkv, Dh)
    after RoPE, as the cache holds them."""
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    q, k = _qk_norm(p, q, k, cfg)
    q = apply_rope(q, angles)
    k = apply_rope(k, angles)
    out = attn_lib.blocked_attention(q, k, v, window=cfg.sliding_window,
                                     q_block=q_block, kv_block=kv_block)
    B, S = x.shape[:2]
    y = out.reshape(B, S, -1) @ p["wo"].reshape(-1, cfg.d_model)
    return y, (k, v)


def attn_decode(p, x, cfg: ModelConfig, cache, pos: int, *, window=None):
    """One token per sequence.  x: (B, d); cache: {'k', 'v'} (B, S, Hkv,
    Dh); pos: the token's position, a Python int.  Writes the token's K/V
    into ``cache`` IN PLACE (slot pos % window for a rolling cache of
    ``window`` rows, else pos) and returns y (B, d).  Attention over the
    cache runs through ``ops.swa_decode_attention``: the kernel on a CUDA
    tensor, its plain version on a CPU one."""
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    q, k = _qk_norm(p, q, k, cfg)
    angle = rope_frequencies(cfg.head_dim, cfg.rope_theta,
                             torch.full((1,), pos, device=x.device))
    q = apply_rope(q[:, None], angle)[:, 0]
    k = apply_rope(k[:, None], angle)[:, 0]
    S = cache["k"].shape[1]
    rolling = window is not None and S == window
    slot = pos % window if rolling else pos
    if slot >= S:
        raise ValueError(f"position {pos} does not fit a {S}-row cache")
    cache["k"][:, slot] = k.to(cache["k"].dtype)
    cache["v"][:, slot] = v.to(cache["v"].dtype)
    cache_len = min(pos + 1, S)
    # the JAX package masks positions < cache_len - window; a cache of at
    # most `window` rows (all that init_cache and prefill make) never cuts
    if window is not None and not rolling and window < S:
        raise ValueError(f"a {S}-row cache wider than the {window}-row "
                         "window is not supported (init_cache makes at "
                         "most `window` rows)")
    out = ops.swa_decode_attention(q, cache["k"], cache["v"], cache_len)
    return out.reshape(x.shape[0], -1) @ p["wo"].reshape(-1, cfg.d_model)


def layer_forward(params, x, cfg: ModelConfig, spec: LayerSpec, *, angles,
                  ssm_state=None, return_ssm_state=False, q_block=512,
                  kv_block=512):
    """Full-sequence layer (training, prefill).  Returns (x, kv, state):
    (k, v) of an attention layer, else None; the Mamba layer's final
    {"h", "conv"} state with ``return_ssm_state``, else None.
    ``ssm_state`` starts a Mamba layer from a carried state."""
    check_ported(cfg, spec)
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    kv = new_state = None
    if spec.kind == "A":
        y, kv = attn_forward(params["attn"], h, cfg, angles=angles,
                             q_block=q_block, kv_block=kv_block)
    elif return_ssm_state:
        y, new_state = mamba_lib.ssd_forward(
            params["mamba"], h, cfg.ssm, init_state=ssm_state,
            return_state=True)
    else:
        y = mamba_lib.ssd_forward(params["mamba"], h, cfg.ssm,
                                  init_state=ssm_state)
    x = x + y
    if spec.has_mlp:
        h = rms_norm(x, params["ln2"], cfg.norm_eps)
        x = x + mlp_forward(params["mlp"], h, cfg)
    return x, kv, new_state


def layer_decode(params, x, cfg: ModelConfig, spec: LayerSpec, cache,
                 pos: int, *, window=None):
    """Single-token layer step; writes the layer's ``cache`` in place
    ({"k", "v"} of an attention layer, {"h", "conv"} of a Mamba one)."""
    check_ported(cfg, spec)
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    if spec.kind == "A":
        y = attn_decode(params["attn"], h, cfg, cache, pos, window=window)
    else:
        y, new = mamba_lib.mamba_decode_step(params["mamba"], h, cache,
                                             cfg.ssm)
        for k, t in new.items():
            cache[k].copy_(t)
    x = x + y
    if spec.has_mlp:
        h = rms_norm(x, params["ln2"], cfg.norm_eps)
        x = x + mlp_forward(params["mlp"], h, cfg)
    return x
