"""Algorithm 1: successive convex solver for network-aware CE-FL.
Counterpart of ``repro.solver.sca`` (its ``"jit"`` backend).

Each outer iteration convexifies P at w^l (proximal surrogate), solves the
surrogate with the distributed primal-dual method (Algorithm 2 + consensus
Algorithm 3), and moves w^{l+1} = w^l + zeta (w_hat - w^l) (eq. 81).

The solve runs in eager torch on the device of ``D_bar``:
the network's rate arrays, the ML constants' arrays and the consensus
weights are moved there once, and every outer step stays there; the host
reads one objective and one violation per outer step, as the reference
does.  The reference's numpy oracle (``backend="ref"``, its
``solver/ref.py``) stays in the JAX package as the reference's own check.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.core.convergence import MLConstants
from repro_torch.network.costs import as_f32, network_costs
from repro_torch.solver import constraints as K
from repro_torch.solver import variables as V
from repro_torch.solver.consensus import consensus_weights
from repro_torch.solver.objective import (ObjectiveWeights,
                                          apply_required_deltas, objective,
                                          objective_breakdown)
from repro_torch.solver.primal_dual import PDHyper, make_surrogate


@dataclasses.dataclass
class SCAResult:
    w: Dict
    w_rounded: Dict
    objective_history: list
    violation_history: list
    breakdown: dict
    iterations: int
    pd_iterations: List[int] = dataclasses.field(default_factory=list)


def _consts_scalars(consts: MLConstants):
    return (float(consts.L), float(consts.zeta1), float(consts.zeta2),
            float(consts.F0_gap))


def _on_device(net, D_bar, consts):
    """(NetView, D_bar, MLConstants) with every array on ``D_bar``'s
    device (the CPU for a numpy ``D_bar``)."""
    D = as_f32(D_bar)
    dev = D.device
    nv = V.NetView.from_network(net, dev)
    c = dataclasses.replace(consts,
                            theta_i=as_f32(consts.theta_i).to(dev),
                            sigma_i=as_f32(consts.sigma_i).to(dev))
    return nv, D, c


def _outer_step(spec: V.WSpec, hyper: PDHyper, ow: ObjectiveWeights, cs,
                distributed: bool, zeta: float, gamma_cap: float = 20.0):
    """One SCA outer iteration: the Algorithm-2 solve, the eq.-81 step, the
    projection, the required delays and the objective."""
    surrogate = make_surrogate(spec, hyper, ow, cs, distributed=distributed,
                               gamma_cap=gamma_cap)

    def step(w, Lambda, net, D_bar, consts, scale_flat, W_cons):
        w_hat, Lambda, pd_iters, max_viol = surrogate(
            w, Lambda, net, D_bar, consts.theta_i, consts.sigma_i,
            scale_flat, W_cons)
        w_new = w + zeta * (w_hat - w)                          # eq. (81)
        w_phys = V.project(spec.unflatten(w_new * scale_flat), net,
                           gamma_cap=gamma_cap)
        w_phys = apply_required_deltas(w_phys, net, D_bar)
        obj = objective(w_phys, net, D_bar, consts, ow)
        return (spec.flatten(w_phys) / scale_flat, Lambda, obj, max_viol,
                pd_iters)

    return step


def select_aggregator(w: Dict, net, D_bar, consts, ow) -> int:
    """Exact discrete rounding of the floating-aggregator indicator I_s:
    enumerate the S one-hot candidates, each with its own required delay
    budgets, and return the index that minimizes the true objective.  On
    ``D_bar``'s device."""
    nv, D, c = _on_device(net, D_bar, consts)
    dev = D.device
    w = {k: as_f32(v).to(dev) for k, v in w.items()}
    S = int(w["I_s"].shape[0])
    objs = []
    for s in range(S):
        ws = dict(w)
        ws["I_s"] = V.one_hot(s, S, device=dev)
        ws = apply_required_deltas(ws, nv, D)
        objs.append(objective(ws, nv, D, c, ow))
    return int(torch.argmin(torch.stack(objs)))


def solve(net, D_bar, consts: MLConstants, ow: ObjectiveWeights,
          *, zeta: float = 0.5, max_outer: int = 20, tol: float = 1e-4,
          pd: Optional[PDHyper] = None, distributed: bool = True,
          w0: Optional[Dict] = None, seed: int = 0,
          backend: str = "jit") -> SCAResult:
    """Solve problem P at the current network state, on ``D_bar``'s
    device.  ``backend``: only ``"jit"``, the name of the reference's
    batched solver that this one ports."""
    del seed
    if backend == "ref":
        raise ValueError(
            "solver backend 'ref' is the JAX package's numpy oracle "
            "(repro.solver.ref); it is the reference's own check and is not "
            "ported: use backend='jit'")
    if backend != "jit":
        raise ValueError(f"unknown solver backend {backend!r} "
                         "(expected 'jit')")
    pd = pd or PDHyper()
    nv, D, c = _on_device(net, D_bar, consts)
    dev = D.device
    spec = V.WSpec(nv.dims)
    scale_flat = V.Scaler(nv).flat(spec)
    n_nodes = net.node_count() if distributed else 1
    W_cons = (as_f32(consensus_weights(net.adjacency)).to(dev)
              if distributed else torch.zeros((1, 1), device=dev))
    Lambda = torch.zeros((n_nodes, K.num_constraints(spec.dims)),
                         device=dev)

    # feasible start — the same construction as the reference
    if w0 is not None:
        w0 = {k: as_f32(v).to(dev) for k, v in w0.items()}
    w_phys = V.project(w0 if w0 is not None else V.init_w(nv, D), nv)
    w_phys = apply_required_deltas(w_phys, nv, D, slack=1.05)
    w = spec.flatten(w_phys) / scale_flat

    step = _outer_step(spec, pd, ow, _consts_scalars(c), distributed, zeta)
    hist = [float(objective(w_phys, nv, D, c, ow))]
    viol, pd_iters = [], []
    ell = 0
    for ell in range(max_outer):
        w, Lambda, obj, max_viol, its = step(w, Lambda, nv, D, c,
                                             scale_flat, W_cons)
        obj = float(obj)
        viol.append(float(max_viol))
        pd_iters.append(int(its))
        improved = hist[-1] - obj
        hist.append(obj)
        if 0 <= improved < tol * max(1.0, abs(hist[0])):
            break
    w_phys = spec.unflatten(w * scale_flat)
    w_rounded = V.round_indicators(w_phys)
    cst = network_costs(w_rounded, nv, D)
    w_rounded["delta_A"] = cst["delta_A_req"]
    w_rounded["delta_R"] = cst["delta_R_req"]
    return SCAResult(
        w=w_phys, w_rounded=w_rounded, objective_history=hist,
        violation_history=viol,
        breakdown=objective_breakdown(w_rounded, nv, D, c, ow),
        iterations=ell + 1, pd_iterations=pd_iters)
