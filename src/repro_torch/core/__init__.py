"""Counterpart of ``repro.core``: the typed orchestration API, the engine
and its executors, FedProx local training, aggregation, the convergence
bound and the constants estimation.  Submodules first, names after (the
engine imports the solver and the scenarios, which import core
submodules)."""
from repro_torch.core import (  # noqa: F401
    aggregation, api, cefl, convergence, drift, engine, estimation, fedprox,
    round_step, strategies,
)
from repro_torch.core.api import (  # noqa: F401
    DecisionContext, DecisionStrategy, EngineOptions, RoundPlan, RoundReport,
    RunResult, available_strategies, get_strategy, register_strategy,
)
from repro_torch.core.cefl import CEFLOptions, run_cefl  # noqa: F401
from repro_torch.core.convergence import MLConstants  # noqa: F401
from repro_torch.core.engine import (  # noqa: F401
    Engine, MeshExecutor, SimExecutor, realize_offloading,
)
from repro_torch.core.round_step import (  # noqa: F401
    CEFLHyper, build_cefl_round_step, make_dpu_meta,
)
