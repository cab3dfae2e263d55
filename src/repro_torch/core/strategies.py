"""Built-in decision strategies (paper Sec. IV + VI-B baselines).
Counterpart of ``repro.core.strategies``, registered under the same names:

  cefl         — Algorithm 1 (SCA over problem P), warm-started from the
                 previous round's plan, solved on the engine's device
  greedy_data  — datapoint-greedy floating aggregator (Sec. VI-B2)
  greedy_rate  — data-rate-greedy floating aggregator (eq. 100)
  fixed:<s>    — always aggregate at DC s
  fednova      — conventional FedL, FedNova aggregation (no offloading)
  fedavg       — conventional FedL, model averaging (no offloading)

The heuristic strategies decide on the CPU; ``cefl`` runs the SCA solve
and the aggregator enumeration on ``ctx.device`` (the engine's), and its
plan comes back to the CPU as every plan does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import DecisionContext, RoundPlan, \
    register_strategy
from repro_torch.network.costs import as_f32
from repro_torch.solver import greedy as greedy_mod
from repro_torch.solver import sca
from repro_torch.solver.objective import apply_required_deltas
from repro_torch.solver.variables import NetView, one_hot, round_indicators


def _heuristic_base(net, D_bar, opts):
    """Shared non-aggregation decisions for the greedy/fixed baselines."""
    base = dict(greedy_mod.heuristic_base(net, D_bar))
    base["gamma"] = torch.full_like(base["gamma"], float(opts.gamma_default))
    base["m"] = torch.full_like(base["m"], opts.m_default)
    return base


@register_strategy("cefl")
class CEFLStrategy:
    """Network-aware CE-FL: successive convex approximation over P."""
    aggregation = "cefl"
    proximal = True

    def decide(self, net, D_bar, ctx: DecisionContext) -> RoundPlan:
        opts = ctx.opts
        dev = torch.device(ctx.device) if ctx.device is not None \
            else as_f32(D_bar).device
        D = as_f32(D_bar).to(dev)
        # warm start from the previous plan.  Its indicators are rounded
        # one-hots: mix them back toward the simplex interior so the
        # relaxed SCA iterate isn't pinned at the previous vertex when the
        # network has moved on.
        w0 = None
        if ctx.prev_plan is not None:
            w0 = {k: v.to(dev) for k, v in ctx.prev_plan.to_w().items()}
            for k, ax in (("I_s", 0), ("I_nb", 1), ("I_bn", 0)):
                x = w0[k]
                w0[k] = 0.5 * x + 0.5 / x.shape[ax]
        res = sca.solve(net, D, ctx.consts, ctx.ow,
                        max_outer=opts.solver_outer,
                        distributed=opts.distributed_solver, w0=w0,
                        backend=opts.solver_backend)
        # floating aggregation point: exact enumeration over the rounded
        # plan (argmax of a near-uniform relaxed I_s is noise)
        w = dict(res.w_rounded)
        s = sca.select_aggregator(w, net, D, ctx.consts, ctx.ow)
        w["I_s"] = one_hot(s, w["I_s"].shape[0], device=dev)
        w = apply_required_deltas(w, NetView.from_network(net, dev), D)
        return RoundPlan.from_w(w)


class _GreedyBase:
    aggregation = "cefl"
    proximal = True

    def _pick(self, net, D_bar):
        raise NotImplementedError

    def decide(self, net, D_bar, ctx: DecisionContext) -> RoundPlan:
        base = _heuristic_base(net, D_bar, ctx.opts)
        w = greedy_mod.fixed_aggregator(net, D_bar, self._pick(net, D_bar),
                                        base)
        return RoundPlan.from_w(round_indicators(w))


@register_strategy("greedy_data")
class GreedyDataStrategy(_GreedyBase):
    def _pick(self, net, D_bar):
        return int(np.argmax(greedy_mod.subnet_datapoints(net, D_bar)))


@register_strategy("greedy_rate")
class GreedyRateStrategy(_GreedyBase):
    def _pick(self, net, D_bar):
        return int(np.argmax(greedy_mod.e2e_rate(net).mean(axis=0)))


@register_strategy("fixed")
class FixedStrategy(_GreedyBase):
    """Always aggregate at DC ``s`` — spec string ``fixed:<s>``."""

    def __init__(self, s_idx=""):
        if s_idx == "":
            raise ValueError("fixed strategy needs a DC index: 'fixed:<s>'")
        self.s_idx = int(s_idx)

    def _pick(self, net, D_bar):
        return self.s_idx


class _ConventionalFedL:
    """Conventional FedL baseline (Sec. VI-B1): no offloading, everything
    trained at the UEs, fixed aggregator DC 0, homogeneous settings."""
    proximal = False

    def decide(self, net, D_bar, ctx: DecisionContext) -> RoundPlan:
        base = _heuristic_base(net, D_bar, ctx.opts)
        w = dict(greedy_mod.fixed_aggregator(net, D_bar, 0, base))
        w["rho_nb"] = torch.zeros_like(w["rho_nb"])
        w = apply_required_deltas(round_indicators(w), net, D_bar)
        return RoundPlan.from_w(w)


@register_strategy("fednova")
class FedNovaStrategy(_ConventionalFedL):
    aggregation = "fednova"


@register_strategy("fedavg")
class FedAvgStrategy(_ConventionalFedL):
    aggregation = "fedavg"
