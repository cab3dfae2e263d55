"""Built-in decision strategies (paper Sec. VI-B baselines).  Counterpart of
``repro.core.strategies``, registered under the same names:

  greedy_data  — datapoint-greedy floating aggregator (Sec. VI-B2)
  greedy_rate  — data-rate-greedy floating aggregator (eq. 100)
  fixed:<s>    — always aggregate at DC s
  fednova      — conventional FedL, FedNova aggregation (no offloading)
  fedavg       — conventional FedL, model averaging (no offloading)

The network-aware ``cefl`` strategy (the SCA solver) is not ported yet;
``get_strategy("cefl")`` raises the registry's KeyError.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import DecisionContext, RoundPlan, \
    register_strategy
from repro_torch.solver import greedy as greedy_mod
from repro_torch.solver.objective import apply_required_deltas
from repro_torch.solver.variables import round_indicators


def _heuristic_base(net, D_bar, opts):
    """Shared non-aggregation decisions for the greedy/fixed baselines."""
    base = dict(greedy_mod.heuristic_base(net, D_bar))
    base["gamma"] = torch.full_like(base["gamma"], float(opts.gamma_default))
    base["m"] = torch.full_like(base["m"], opts.m_default)
    return base


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
