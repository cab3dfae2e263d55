"""Counterpart of ``repro.scenario``: per-round evolution of the CE-FL
world (mobility, handover, mesh churn, drift schedules, adversaries)."""
from repro_torch.scenario import presets  # noqa: F401  (registers the presets)
from repro_torch.scenario.adversary import (  # noqa: F401
    ByzantineUpdate, Dropout, LabelPoison, Straggler,
)
from repro_torch.scenario.base import (  # noqa: F401
    Scenario, ScenarioEvents, StaticScenario, available_scenarios,
    get_scenario, register_scenario,
)
from repro_torch.scenario.drift_schedules import (  # noqa: F401
    ArrivalBurst, JoinLeave, LabelRotation,
)
from repro_torch.scenario.dynamic import DynamicScenario  # noqa: F401
from repro_torch.scenario.mobility import (  # noqa: F401
    FieldLayout, GaussMarkov, MobilityModel, RandomWaypoint,
    layout_from_network,
)
