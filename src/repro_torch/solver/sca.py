"""Algorithm 1: successive convex solver for network-aware CE-FL.
Counterpart of ``repro.solver.sca`` (its ``"jit"`` backend).

Each outer iteration convexifies P at w^l (proximal surrogate), solves the
surrogate with the distributed primal-dual method (Algorithm 2 + consensus
Algorithm 3), and moves w^{l+1} = w^l + zeta (w_hat - w^l) (eq. 81).

The solve runs in torch on the device of ``D_bar``: the network's rate
arrays, the ML constants' arrays and the consensus weights are moved
there once, and every outer step stays there; the host reads the
objective, the violation and the primal-dual count of each outer step in
one copy, as the reference reads them.  On the CPU each outer step runs
eagerly.  On a CUDA device the outer step is captured once as a CUDA
graph per shape and constants (:data:`GRAPH_CACHE` kept, least recently
used dropped first) and replayed: the same ``step`` function, launched
without thousands of eager dispatches.  The reference's numpy oracle
(``backend="ref"``, its ``solver/ref.py``) stays in the JAX package as
the reference's own check.
"""
from __future__ import annotations

import collections
import dataclasses
import warnings
from typing import TYPE_CHECKING, Dict, List, Optional

import torch

from repro_torch import tracing
from repro_torch.network.costs import as_f32, network_costs
from repro_torch.solver import constraints as K
from repro_torch.solver import variables as V
from repro_torch.solver.consensus import consensus_weights
from repro_torch.solver.objective import (ObjectiveWeights,
                                          apply_required_deltas, objective,
                                          objective_breakdown)
from repro_torch.solver.primal_dual import PDHyper, make_surrogate

if TYPE_CHECKING:     # core imports the solver (through its strategies)
    from repro_torch.core.convergence import MLConstants


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


_GAMMA_CAP = 20.0


def _outer_step(spec: V.WSpec, hyper: PDHyper, ow: ObjectiveWeights, cs,
                distributed: bool, zeta: float,
                gamma_cap: float = _GAMMA_CAP):
    """One SCA outer iteration: the Algorithm-2 solve, the eq.-81 step, the
    projection, the required delays and the objective.  ``step`` returns
    (w, Lambda, reads), ``reads`` the (objective, max violation,
    primal-dual iterations) the host reads, stacked for one copy."""
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
        return (spec.flatten(w_phys) / scale_flat, Lambda,
                torch.stack([obj, max_viol, pd_iters.to(obj.dtype)]))

    return step


GRAPH_CACHE = 4     # captured outer steps kept, least recently used first out
_graphs: collections.OrderedDict = collections.OrderedDict()


def _inputs(nv, D, c, scale_flat, W_cons, w, Lambda) -> list:
    """The outer step's tensor arguments, in one order."""
    return [getattr(nv, a) for a in V.NetView.ARRAYS] + [
        D, c.theta_i, c.sigma_i, scale_flat, W_cons, w, Lambda]


class _GraphStep:
    """One outer step captured as a CUDA graph.  Its static inputs are
    copies of the step's tensor arguments, which :meth:`load` overwrites
    for each solve; the graph writes the step's ``w`` and ``Lambda`` back
    into its inputs, so each replay carries on from the last, and leaves
    (obj, max_viol, pd iterations) in ``reads``."""

    def __init__(self, step, nv, D, c, *args):
        self.static = [t.clone() for t in _inputs(nv, D, c, *args)]
        *rates, D, theta_i, sigma_i, scale_flat, W_cons, self.w, \
            self.Lambda = self.static
        inputs = (self.w, self.Lambda, V.NetView(nv.cfg, nv.dims, rates), D,
                  dataclasses.replace(c, theta_i=theta_i, sigma_i=sigma_i),
                  scale_flat, W_cons)
        # the graph reads these cached constants: hold them while it lives
        self.owner = V.owner_tensors(nv.dims, D.device)
        side = torch.cuda.Stream(D.device)
        side.wait_stream(torch.cuda.current_stream(D.device))
        with torch.cuda.stream(side):
            step(*inputs)           # warm-up off the capture, as required
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=side):
                w, Lambda, self.reads = step(*inputs)
                self.w.copy_(w)
                self.Lambda.copy_(Lambda)
        torch.cuda.current_stream(D.device).wait_stream(side)

    def load(self, *args) -> None:
        for dst, src in zip(self.static, _inputs(*args)):
            dst.copy_(src)

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        return self.reads


def _graph_step(key, step, args):
    """(the captured step for ``key`` loaded with ``args``, 1 if it was
    captured now, else 0); the step is None where its capture failed."""
    if key in _graphs:
        _graphs.move_to_end(key)
        g = _graphs[key]
        if g is not None:
            g.load(*args)
        return g, 0
    try:
        g = _GraphStep(step, *args)
    except RuntimeError as e:
        warnings.warn(f"CUDA graph capture of the SCA outer step failed "
                      f"({e}); it runs eagerly", RuntimeWarning)
        g = None
    _graphs[key] = g
    if len(_graphs) > GRAPH_CACHE:
        _graphs.popitem(last=False)
    return g, int(g is not None)


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
    batched solver that this one ports.

    Traced as ``sca.solve``, counting ``pd_live`` (the primal-dual
    iterations that moved the duals) against ``pd_run`` (those run, the
    frozen ones too), and the outer steps run as ``graph_replays`` or
    ``eager_outer``, with ``graph_captures``; an ``sca.outer`` span for
    each outer step's enqueue and an ``sca.sync`` span for each host
    read."""
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
    with tracing.span("sca.solve"):
        res = _solve(net, D_bar, consts, ow, zeta=zeta, max_outer=max_outer,
                     tol=tol, pd=pd, distributed=distributed, w0=w0)
        tracing.count("pd_live", sum(res.pd_iterations))
        tracing.count("pd_run", res.iterations * pd.max_iters)
    return res


def _solve(net, D_bar, consts, ow, *, zeta, max_outer, tol, pd, distributed,
           w0) -> SCAResult:
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

    cs = _consts_scalars(c)
    step = _outer_step(spec, pd, ow, cs, distributed, zeta)
    graph, captured = None, 0
    if dev.type == "cuda" and max_outer > 0:
        args = (nv, D, c, scale_flat, W_cons, w, Lambda)
        # every number the step reads as a Python number, and the shapes
        key = (spec.dims, dev, pd, ow, cs, distributed, zeta, _GAMMA_CAP,
               dataclasses.astuple(net.cfg),
               tuple(t.shape for t in _inputs(*args)))
        graph, captured = _graph_step(key, step, args)
    obj0 = objective(w_phys, nv, D, c, ow)
    with tracing.span("sca.sync"):
        hist = [float(obj0)]
    viol, pd_iters = [], []
    ell = 0
    for ell in range(max_outer):
        with tracing.span("sca.outer"):
            if graph is not None:
                reads = graph.replay()
            else:
                w, Lambda, reads = step(w, Lambda, nv, D, c, scale_flat,
                                        W_cons)
        with tracing.span("sca.sync"):
            obj, max_viol, its = reads.tolist()
        viol.append(max_viol)
        pd_iters.append(int(its))
        improved = hist[-1] - obj
        hist.append(obj)
        if 0 <= improved < tol * max(1.0, abs(hist[0])):
            break
    steps = ell + 1 if max_outer > 0 else 0
    replays = 0
    if graph is not None:
        w, replays = graph.w, steps
    tracing.count("graph_replays", replays)
    tracing.count("graph_captures", captured)
    tracing.count("eager_outer", steps - replays)
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
