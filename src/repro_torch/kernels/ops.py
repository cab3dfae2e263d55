"""Kernel ops and their dispatch (counterpart of ``repro.kernels.ops``):
the plane level, which the round paths call, and the tree level, which
flattens a dict tree onto a plane, launches one kernel and unflattens.

Dispatch is decided by the tensors' device and nothing else: a CUDA tensor
launches the hand-written kernel (or the wrapper raises), a CPU tensor
runs the plain version from ``ref.py``.  There is no fall-back from one to
the other, no environment variable and no backend knob.

Weight contract: ``normalize_weights`` turns absolute dataset sizes D_i
into simplex weights, once; the kernel level takes normalized weights and
never normalizes again.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels import fedprox_update as _fp
from repro_torch.kernels import nova_aggregate as _na
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import robust_aggregate as _ra
from repro_torch.kernels import swa_decode_attention as _swa
from repro_torch.kernels.plane import spec_of

LAUNCHES = cuda.LAUNCHES   # launches per kernel, counted by the wrappers
reset_launches = cuda.reset_launches

ROBUST_MODES = ("trimmed_mean", "median")


def normalize_weights(weights: Sequence) -> torch.Tensor:
    """Absolute D_i -> simplex weights (f32, on the CPU unless ``weights``
    is a tensor elsewhere).  THE single normalization point."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    return w / torch.sum(w)


def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


def fedprox_plane(x, g, anchor, eta, mu):
    """Fused x <- x - eta*(g + mu*(x - anchor)) on (R, LANE) planes."""
    if _on_cpu(x):
        return _ref.fedprox_update_ref(x, g, anchor, eta, mu)
    return _fp.fedprox_update(x, g, anchor, eta, mu)


def fedprox_accum_plane(x, g, anchor, acc, coef, active, eta, mu):
    """Batched proximal step + eq.-10 accumulation on (G, R, LANE) planes
    (one launch per local iteration for a whole DPU group)."""
    coef = torch.as_tensor(coef, dtype=torch.float32, device=x.device)
    active = torch.as_tensor(active, dtype=torch.float32, device=x.device)
    if _on_cpu(x):
        return _ref.fedprox_accum_ref(x, g, anchor, acc, coef, active,
                                      eta, mu)
    return _fp.fedprox_accum(x, g, anchor, acc, coef, active, eta, mu)


def nova_aggregate_plane(x, d_stack, weights, theta_eta):
    """eq. 11 on planes.  ``weights`` must be normalized.  ``x`` may be
    (R, LANE) or (n_dpu, R, LANE) (stacked per-DPU replicas, every row
    updated alike)."""
    w = torch.as_tensor(weights, dtype=torch.float32, device=x.device)
    if _on_cpu(x):
        return _ref.nova_aggregate_ref(x, d_stack, w, theta_eta)
    if x.dim() == 3:
        return _na.nova_aggregate_stacked(x, d_stack, w, theta_eta)
    return _na.nova_aggregate(x, d_stack, w, theta_eta)


def trim_count(n_dpu: int, trim_frac: float) -> int:
    """Per-side trim count for an n_dpu stack: floor(n * frac), clamped so
    at least one value survives (2k < n)."""
    if not 0.0 <= trim_frac < 0.5:
        raise ValueError(f"trim_frac must be in [0, 0.5), got {trim_frac}")
    return min(int(n_dpu * trim_frac), (n_dpu - 1) // 2)


def robust_kwargs(n_dpu: int, mode: str, trim_frac: float) -> dict:
    """The kernel-level ``k`` / ``median`` of a robust mode over an n_dpu
    stack."""
    if mode not in ROBUST_MODES:
        raise ValueError(
            f"unknown robust mode {mode!r}; known: {ROBUST_MODES}")
    median = mode == "median"
    return {"k": 0 if median else trim_count(n_dpu, trim_frac),
            "median": median}


def robust_aggregate_plane(x, d_stack, theta_eta, *,
                           mode: str = "trimmed_mean",
                           trim_frac: float = 0.1):
    """Byzantine-robust eq. 11 on an (R, LANE) plane: x - theta_eta *
    reduce(d_stack), with a coordinate-wise trimmed mean
    (``mode="trimmed_mean"``) or median (``mode="median"``) over the DPU
    axis.  Unweighted by design."""
    kw = robust_kwargs(d_stack.shape[0], mode, trim_frac)
    if _on_cpu(x):
        return _ref.robust_aggregate_ref(x, d_stack, theta_eta, **kw)
    return _ra.robust_aggregate(x, d_stack, theta_eta, **kw)


def swa_decode_attention(q, k_cache, v_cache, cache_len: int):
    """Single-token GQA decode attention: q (B, Hq, D) over the positions
    < ``cache_len`` (a Python int) of the (B, S, Hkv, D) caches."""
    if _on_cpu(q):
        return _ref.swa_decode_attention_ref(q, k_cache, v_cache, cache_len)
    return _swa.swa_decode_attention(q, k_cache, v_cache, cache_len)


# ------------------------------------------------------- tree level -----

def fedprox_update(params, grads, anchor, eta, mu):
    """Fused x <- x - eta*(g + mu*(x - anchor)) over a whole dict tree:
    one launch on the f32 plane, leaves cast back to their dtypes."""
    spec = spec_of(params)
    out = fedprox_plane(spec.flatten(params), spec.flatten(grads),
                        spec.flatten(anchor), eta, mu)
    return spec.unflatten(out)


def nova_aggregate(x, d_list: Sequence, weights, theta_eta):
    """x <- x - theta_eta * sum_i w_i d_i over dict trees (eq. 11).

    ``weights``: absolute dataset sizes D_i, normalized here (the single
    normalization point of this path)."""
    spec = spec_of(x)
    d_stack = torch.stack([spec.flatten(d) for d in d_list], dim=0)
    out = nova_aggregate_plane(spec.flatten(x), d_stack,
                               normalize_weights(weights), theta_eta)
    return spec.unflatten(out)
