"""Plain PyTorch versions of the kernels (counterpart of
``repro.kernels.ref``): the CPU path and the oracles the CUDA kernels are
held against.  Math in float32, outputs cast back to the input dtypes."""
from __future__ import annotations

import numpy as np
import torch


def fedprox_update_ref(x, g, anchor, eta, mu):
    xf = x.float()
    out = xf - eta * (g.float() + mu * (xf - anchor.float()))
    return out.to(x.dtype)


def fedprox_accum_ref(x, g, anchor, acc, coef, active, eta, mu):
    """Batched proximal step + eq.-10 accumulation (fedprox_accum_2d).
    x, g, acc: (G, R, L); anchor: (R, L) or (G, R, L); coef/active: (G,)."""
    xf = x.float()
    gf = g.float()
    anc = anchor.float()
    if anc.dim() == 2:
        anc = anc.unsqueeze(0)
    act = active.float()[:, None, None]
    ak = coef.float()[:, None, None]
    x_new = xf - act * eta * (gf + mu * (xf - anc))
    acc_new = acc.float() + act * ak * gf
    return x_new.to(x.dtype), acc_new.to(acc.dtype)


def nova_aggregate_ref(x, d_stack, weights, theta_eta):
    """eq. 11: x - theta_eta * sum_i w_i d_i, w already normalized."""
    agg = torch.einsum("n,n...->...", weights.float(), d_stack.float())
    return (x.float() - theta_eta * agg).to(x.dtype)


def robust_reduce_ref(d_stack, *, k: int = 0, median: bool = False):
    """Coordinate-wise robust location estimate over the DPU axis (dim 0),
    in float32: the median (``median=True``; the mean of the two middle
    values for even n) or the k-trimmed mean (drop the k smallest and k
    largest per coordinate, which needs 0 <= 2k < n).  NaN sorts last, as
    in ``torch.sort``; the sort is stable, as ``jnp.sort`` is, so equal
    values (-0 and +0) keep DPU order.  A trimmed mean of one value is
    that value (its zero keeps its sign, as ``jnp.mean`` over one element
    leaves it); of more, ``torch.mean``, whose sum of zeros is +0.
    Unweighted by design: dataset-size weights are the lever a byzantine
    client inflates."""
    d = torch.sort(d_stack.float(), dim=0, stable=True).values
    n = d.shape[0]
    if median:
        mid = n // 2
        return d[mid] if n % 2 else 0.5 * (d[mid - 1] + d[mid])
    if not 0 <= 2 * k < n:
        raise ValueError(f"trim k={k} needs 0 <= 2k < n={n}")
    if n - 2 * k == 1:
        return d[k]
    return torch.mean(d[k:n - k], dim=0)


def robust_aggregate_ref(x, d_stack, theta_eta, *, k: int = 0,
                         median: bool = False):
    """eq. 11 with the weighted sum replaced by a robust reduce:
    x - theta_eta * robust_reduce(d_stack)."""
    red = robust_reduce_ref(d_stack, k=k, median=median)
    return (x.float() - theta_eta * red).to(x.dtype)


def swa_decode_attention_ref(q, k_cache, v_cache, cache_len):
    """Single-token GQA decode attention over positions < cache_len of a
    (B, S, Hkv, D) cache, in float32: q (B, Hq, D) -> (B, Hq, D) in q's
    dtype, the G = Hq / Hkv query heads of each KV head side by side."""
    B, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) / np.sqrt(D)
    pos = torch.arange(S, device=q.device)
    s = torch.where((pos < cache_len)[None, None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o.reshape(B, Hq, D).to(q.dtype)
