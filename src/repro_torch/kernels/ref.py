"""Plain PyTorch versions of the kernels (counterpart of
``repro.kernels.ref``): the CPU path and the oracles the CUDA kernels are
held against.  Math in float32, outputs cast back to the input dtypes."""
from __future__ import annotations

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
