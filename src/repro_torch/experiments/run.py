"""The experiment entry point ``run(spec)``.  Counterpart of
``repro.experiments.run``.

    from repro_torch import experiments

    result = experiments.run("quickstart", device="cpu")   # one run

``sweep`` (every seed of a spec grid, batched across seeds, with
checkpoints and resume) is ROADMAP queue 1 item 4 and raises until then.
"""
from __future__ import annotations

from typing import Optional, Union

from repro_torch.core.api import RunResult
from repro_torch.experiments.build import build_context
from repro_torch.experiments.spec import ExperimentSpec, get_experiment
from repro_torch.experiments.trace import TraceSink, round_record

SpecLike = Union[str, dict, ExperimentSpec]


def run(spec: SpecLike, *, seed: Optional[int] = None, device="cuda",
        trace: Optional[TraceSink] = None, callbacks=()) -> RunResult:
    """Run ONE seed of a spec (default: the first of ``spec.seeds``)
    through the orchestration engine on ``device`` (``"cuda"`` by
    default; a CPU run must be asked for)."""
    spec = get_experiment(spec)
    seed = spec.run_seeds[0] if seed is None else int(seed)
    ctx = build_context(spec, device=device)
    engine = ctx.make_engine(seed, callbacks=callbacks)
    if trace is not None:
        @engine.on_round_end
        def _write(rep):
            trace.write(round_record(spec.name, seed, rep,
                                     executor="engine"))
    return engine.run(ctx.make_ues(seed), init_params=ctx.p0,
                      loss_fn=ctx.loss_fn, eval_fn=ctx.eval_fn)


def sweep(*args, **kwargs):
    """Every seed of a spec grid: not ported yet (ROADMAP queue 1 item 4,
    multi-seed sweeps and resume).  Loop over :func:`run` meanwhile."""
    raise NotImplementedError(
        "repro_torch.experiments.sweep is ROADMAP queue 1 item 4 (multi-seed "
        "sweeps and resume); call run(spec, seed=s) for each seed")
