"""Non-convex constraint vector C(w) <= 0 of problem P (dualized in Alg. 2).
Counterpart of ``repro.solver.constraints``:

  * delay coupling (50)-(53): per-UE / per-DC aggregation-path delays must
    fit within the delta^A / delta^R decision variables
  * binary enforcement (63)-(65) on the relaxed indicators

Convex constraints (boxes / simplexes, eqs. 45-49, 54-62) live in the
projection sets D_d (variables.project).
"""
from __future__ import annotations

import torch

from repro_torch.network import costs as C


def constraint_vector(w, net, D_bar):
    """Concatenated residual vector; feasibility <=> all entries <= 0."""
    costs = C.network_costs(w, net, D_bar)
    c50 = costs["d_n_A"] + costs["d_n_P"] - w["delta_A"]           # (N,)
    c51 = costs["d_s_D"] + costs["d_s_P"] + costs["d_s_A"] \
        - w["delta_A"]                                             # (S,)
    c52 = costs["d_b_R"] + costs["d_b_B"] - w["delta_R"]           # (B,)
    c53 = costs["d_s_R"] - w["delta_R"]                            # (S,)
    b63 = torch.sum(w["I_s"] * (1 - w["I_s"]))[None]               # (1,)
    b64 = torch.sum(w["I_nb"] * (1 - w["I_nb"]), dim=1)            # (N,)
    b65 = torch.sum(w["I_bn"] * (1 - w["I_bn"]), dim=0)            # (N,)
    return torch.cat([c50, c51, c52, c53, b63, b64, b65])


def _dims_of(net_or_dims):
    """A Network / NetView or a bare (N, B, S) tuple."""
    if isinstance(net_or_dims, tuple):
        return net_or_dims
    return net_or_dims.dims


def num_constraints(net):
    N, B, S = _dims_of(net)
    return N + S + B + S + 1 + N + N


def constraint_scale(net, device=None):
    """Row scaling for conditioning: delay rows are O(10-100) seconds, the
    binary-enforcement rows are O(1)."""
    N, B, S = _dims_of(net)
    return torch.cat([
        torch.full((N + S,), 1e-2, device=device),    # (50)-(51) vs delta_A
        torch.full((B + S,), 1e-1, device=device),    # (52)-(53) vs delta_R
        torch.ones((1 + 2 * N,), device=device),      # (63)-(65)
    ])


def max_violation(w, net, D_bar) -> float:
    return float(torch.max(constraint_vector(w, net, D_bar)))
