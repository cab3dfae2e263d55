"""The experiment entry points: ``run(spec)`` and ``sweep(specs)``.
Counterpart of ``repro.experiments.run``.

    from repro_torch import experiments

    result = experiments.run("quickstart", device="cpu")     # one run
    result = experiments.run("lm_smoke", device="cpu")       # LM training
    sweep = experiments.sweep("sweep_smoke", device="cpu")   # all seeds
    sweep = experiments.sweep([spec_a, spec_b], device="cpu")  # a grid
    sweep.stats()

``sweep`` executes every seed of every spec in round lockstep, each seed
through its own engine as ``run`` has it
(:class:`~repro_torch.experiments.sweep.SequentialSweepExecutor`).
``checkpoint_dir`` / ``checkpoint_every`` add full-state snapshots;
``resume=True`` continues a killed sweep to results identical to an
uninterrupted one.  Both run on ``device`` (``"cuda"`` by default; a CPU
run must be asked for).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence, Union

from repro_torch.core.api import RunResult
from repro_torch.experiments.build import build_context
from repro_torch.experiments.lm import run_lm
from repro_torch.experiments.spec import ExperimentSpec, get_experiment
from repro_torch.experiments.sweep import (SequentialSweepExecutor,
                                           SweepResult)
from repro_torch.experiments.trace import TraceSink, round_record

SpecLike = Union[str, dict, ExperimentSpec]


def run(spec: SpecLike, *, seed: Optional[int] = None, device="cuda",
        trace: Optional[TraceSink] = None, callbacks=()) -> RunResult:
    """Run ONE seed of a spec (default: the first of ``spec.seeds``)
    through the orchestration engine on ``device`` (``"cuda"`` by
    default; a CPU run must be asked for); LM specs dispatch to the
    mesh-native LM trainer."""
    spec = get_experiment(spec)
    if spec.model.kind == "lm":
        if callbacks:
            raise ValueError("per-round callbacks are not supported for "
                             "lm specs (the mesh loop owns the rounds)")
        if seed is None and len(spec.run_seeds) != 1:
            raise ValueError(
                f"lm specs run one seed at a time; spec has seeds "
                f"{spec.run_seeds}: pass seed=... or set a single seed")
        seed = spec.run_seeds[0] if seed is None else int(seed)
        result = run_lm(spec, seed=seed, device=device)
        if trace is not None:
            for rep in result.reports:
                trace.write(round_record(spec.name, seed, rep,
                                         executor="lm"))
        return result
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


def sweep(specs: Union[SpecLike, Sequence[SpecLike]], *, device="cuda",
          trace: Optional[TraceSink] = None,
          checkpoint_dir=None, checkpoint_every: int = 0,
          resume: bool = False,
          stop_after: Optional[int] = None) -> SweepResult:
    """Run every seed of one spec, or of a whole spec grid, on ``device``
    and return a typed :class:`SweepResult`.

    With multiple specs, each spec's seeds are swept in turn;
    checkpoints go to ``checkpoint_dir/<spec.name>``.
    """
    if isinstance(specs, (str, dict, ExperimentSpec)):
        specs = [specs]
    specs = [get_experiment(s) for s in specs]
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"sweep specs must have unique names: {names}")
    result: Optional[SweepResult] = None
    for spec in specs:
        if spec.model.kind != "classifier":
            raise ValueError(
                f"sweep supports classifier specs; run {spec.name!r} "
                f"(kind={spec.model.kind!r}) through run()")
        ckpt = None
        if checkpoint_dir is not None:
            ckpt = checkpoint_dir if len(specs) == 1 else \
                os.path.join(checkpoint_dir, spec.name)
        ex = SequentialSweepExecutor(checkpoint_dir=ckpt,
                                     checkpoint_every=checkpoint_every,
                                     resume=resume, stop_after=stop_after)
        ctx = build_context(spec, device=device)
        part = ex.run_sweep(ctx, trace=trace)
        result = part if result is None else result.merged(part)
    return result
