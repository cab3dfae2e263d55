"""Declarative experiments: specs, presets, the ``run`` entry point and
the JSONL trace.  Counterpart of ``repro.experiments``.

    from repro_torch import experiments
    result = experiments.run("quickstart", device="cpu")

``python -m repro_torch.experiments run quickstart`` is the command-line
front door (on the card unless ``--device cpu``).
"""
from repro_torch.experiments import presets  # noqa: F401  (registers)
from repro_torch.experiments.build import (  # noqa: F401
    ExperimentContext, build_context, clear_context_cache,
)
from repro_torch.experiments.run import run, sweep  # noqa: F401
from repro_torch.experiments.spec import (  # noqa: F401
    ConstsSpec, DataSpec, EngineSpec, ExperimentSpec, ModelSpec,
    NetworkSpec, ObjectiveSpec, available_experiments, from_json,
    get_experiment, register_experiment, to_json,
)
from repro_torch.experiments.trace import (  # noqa: F401
    TraceSink, read_trace, round_record,
)
