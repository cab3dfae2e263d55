"""Deprecated dict-based CE-FL entry points, kept as thin shims
(counterpart of ``repro.core.cefl``).

The orchestration loop lives in the typed API:

  * :mod:`repro_torch.core.api`        — RoundPlan / RoundReport /
                                         RunResult, DecisionStrategy
                                         protocol + registry
  * :mod:`repro_torch.core.strategies` — the built-in strategies
  * :mod:`repro_torch.core.engine`     — Engine + Sim/Mesh executors

New code should construct an :class:`~repro_torch.core.engine.Engine`
directly.  Both shims take the port's ``device`` (``"cuda"`` unless the
caller asks for the CPU).
"""
from __future__ import annotations

import warnings
from typing import Dict

import torch

from repro_torch.core.api import EngineOptions
from repro_torch.core.api import EngineOptions as CEFLOptions  # noqa: F401
from repro_torch.core.api import DecisionContext, RoundPlan, get_strategy
from repro_torch.core.convergence import MLConstants
from repro_torch.core.engine import Engine, SimExecutor
from repro_torch.core.engine import realize_offloading  # noqa: F401
from repro_torch.device import require_device
from repro_torch.solver.objective import ObjectiveWeights


def decide(strategy: str, net, D_bar, consts, ow, opts, w_prev=None, *,
           device="cuda") -> Dict:
    """Deprecated: resolve ``strategy`` through the registry and return the
    decision as a plain dict (old call sites).  Use
    ``api.get_strategy(name).decide(net, D_bar, ctx)`` instead."""
    warnings.warn("core.cefl.decide is deprecated; use "
                  "repro.core.api.get_strategy", DeprecationWarning,
                  stacklevel=2)
    prev = RoundPlan.from_w(w_prev) if isinstance(w_prev, dict) else w_prev
    ctx = DecisionContext(round=0, consts=consts, ow=ow, opts=opts,
                          prev_plan=prev, device=require_device(device))
    return get_strategy(strategy).decide(
        net, torch.as_tensor(D_bar, dtype=torch.float32), ctx).to_w()


def run_cefl(net, online_datasets, *, init_params, loss_fn, eval_fn,
             consts: MLConstants, ow: ObjectiveWeights,
             opts: EngineOptions, device="cuda") -> Dict:
    """Deprecated shim over :class:`~repro_torch.core.engine.Engine`.

    Returns the legacy history dict (``RunResult.to_history()``).
    """
    warnings.warn(
        "run_cefl is deprecated; use repro.core.engine.Engine — "
        "Engine(net, opts.strategy, consts=..., ow=..., opts=...)"
        ".run(...).to_history() is equivalent", DeprecationWarning,
        stacklevel=2)
    engine = Engine(net, opts.strategy, consts=consts, ow=ow, opts=opts,
                    executor=SimExecutor(), device=device)
    return engine.run(online_datasets, init_params=init_params,
                      loss_fn=loss_fn, eval_fn=eval_fn).to_history()
