"""Global aggregation at the floating aggregation DC (paper eq. 11).
Counterpart of ``repro.core.aggregation`` on parameter planes.

The aggregator receives scaled accumulated gradients D_i * d_i (BSs sum the
gradients of their associated UEs first, Sec. II-D), sums them, and applies

    x^{t+1} = x^t - (theta * eta / D^t) * sum_i D_i d_i.

Weight contract: every entry point here takes ABSOLUTE dataset sizes D_i
and normalizes them exactly once through :func:`normalize_weights`; the
kernel level (``kernels.ops.nova_aggregate_plane``) takes normalized
weights and never normalizes again.

Values are :class:`~repro_torch.kernels.plane.ParamPlane`\\ s (dict trees
are coerced to planes).
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch import tracing
from repro_torch.kernels import ops
from repro_torch.kernels.ops import normalize_weights
from repro_torch.kernels.plane import ParamPlane, as_plane


def _stack_planes(planes: Sequence) -> torch.Tensor:
    return torch.stack([as_plane(p).data for p in planes], dim=0)


def bs_relay_sum(scaled_gradients: Sequence, groups: Sequence[Sequence[int]]):
    """Sum scaled gradients per BS group (keeps the uplink payload one model
    wide per BS, Sec. II-D footnote 2).  Returns one summed ParamPlane per
    non-empty group."""
    out = []
    for g in groups:
        if not g:
            continue
        acc = as_plane(scaled_gradients[g[0]])
        data = acc.data
        for i in g[1:]:
            data = data + as_plane(scaled_gradients[i]).data
        out.append(acc.with_data(data))
    return out


def aggregate(x_t, d_list: List, weights: Sequence[float], *, theta: float,
              eta: float) -> ParamPlane:
    """eq. (11).  weights: absolute D_i; normalized here (once)."""
    x_t = as_plane(x_t)
    w = normalize_weights(weights)
    out = ops.nova_aggregate_plane(x_t.data, _stack_planes(d_list), w,
                                   theta * eta)
    return x_t.with_data(out)


def fedavg_aggregate(local_params: List, weights: Sequence[float]):
    """Plain FedAvg: weighted average of local models (absolute weights)."""
    stack = _stack_planes(local_params)
    w = normalize_weights(weights).to(stack.device)
    return as_plane(local_params[0]).with_data(
        torch.einsum("n,nrl->rl", w, stack))


def fednova_aggregate(x_t, d_list: List, weights: Sequence[float],
                      gammas: Sequence[float], *, eta: float):
    """FedNova (Wang et al. 2020): x^{t+1} = x^t - eta * tau_eff * sum p_i d_i
    with tau_eff = sum_i p_i gamma_i (momentum-free case).  Absolute
    weights; this is eq. 11 with theta = tau_eff."""
    p = normalize_weights(weights)
    tau_eff = float(torch.sum(p * torch.as_tensor(gammas,
                                                  dtype=torch.float32)))
    return aggregate(x_t, d_list, weights, theta=tau_eff, eta=eta)


# ------------------------------------------- byzantine-robust counters --

def robust_aggregate(x_t, d_list: List, *, theta: float, eta: float,
                     mode: str = "trimmed_mean", trim_frac: float = 0.1):
    """eq. 11 with the weighted sum replaced by a coordinate-wise trimmed
    mean / median over the d_i stack, the byzantine counter
    (``EngineOptions.robust_agg``).  Takes NO weights: the D_i a
    compromised client reports are not trusted.  Traced as a
    ``robust.aggregate`` span with the stack's n, the plane's rows R and
    the per-side trim k (0 for the median)."""
    x_t = as_plane(x_t)
    stack = _stack_planes(d_list)
    token = tracing.begin("robust.aggregate")
    if token is not None:
        k = ops.robust_kwargs(stack.shape[0], mode, trim_frac)["k"]
        for key, v in (("n", stack.shape[0]), ("R", stack.shape[1]),
                       ("k", k)):
            tracing.annotate(token, key, v)
    try:
        out = ops.robust_aggregate_plane(x_t.data, stack, theta * eta,
                                         mode=mode, trim_frac=trim_frac)
    finally:
        tracing.end(token)
    return x_t.with_data(out)


def robust_fedavg_aggregate(local_params: List, *,
                            mode: str = "trimmed_mean",
                            trim_frac: float = 0.1):
    """Robust FedAvg: the coordinate-wise trimmed mean / median of the
    local models (Yin et al. 2018), through the same kernel with x = 0 and
    theta_eta = -1, so x_new = reduce(stack)."""
    stack = _stack_planes(local_params)
    zero = torch.zeros(stack.shape[1:], dtype=stack.dtype,
                       device=stack.device)
    return as_plane(local_params[0]).with_data(
        ops.robust_aggregate_plane(zero, stack, -1.0, mode=mode,
                                   trim_frac=trim_frac))
