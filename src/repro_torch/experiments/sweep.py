"""Multi-seed sweeps: K seeded runs in round lockstep.  Counterpart of
``repro.experiments.sweep``.

:class:`SequentialSweepExecutor` drives K per-run
:class:`~repro_torch.core.engine.LoopState`s through the calls a solo
``Engine.run`` makes (``begin_round``, ``execute_round``,
``finish_round``): scenario ticks, solver decisions, offloading, the numpy
and torch random streams and the device round, each run through its own
``Engine`` and ``SimExecutor``.  So every per-seed result equals
``experiments.run(spec, seed=s)`` bit for bit.

It writes per-round JSONL records through a
:class:`~repro_torch.experiments.trace.TraceSink` and checkpoints /
resumes full run state through ``repro_torch.experiments.runstate``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.api import RunResult
from repro_torch.experiments import runstate
from repro_torch.experiments.build import ExperimentContext
from repro_torch.experiments.spec import to_json
from repro_torch.experiments.trace import TraceSink, round_record
from repro_torch.kernels.plane import as_tree


@dataclasses.dataclass(frozen=True)
class RunKey:
    experiment: str
    seed: int


@dataclasses.dataclass
class SweepResult:
    """What ``sweep`` returns: per-run results plus aggregate stats."""
    runs: List[Tuple[RunKey, RunResult]]

    def __len__(self) -> int:
        return len(self.runs)

    @property
    def seeds(self) -> List[int]:
        return [k.seed for k, _ in self.runs]

    def result(self, seed: int, experiment: Optional[str] = None) \
            -> RunResult:
        for k, r in self.runs:
            if k.seed == seed and (experiment is None
                                   or k.experiment == experiment):
                return r
        raise KeyError((experiment, seed))

    def series(self, field: str) -> Dict[RunKey, list]:
        return {k: r.series(field) for k, r in self.runs}

    def stats(self) -> Dict[str, dict]:
        """Aggregate statistics per experiment name: mean/std/min/max of
        final accuracy, mean cumulative energy/delay, mean final loss."""
        by_name: Dict[str, list] = {}
        for k, r in self.runs:
            by_name.setdefault(k.experiment, []).append(r)
        out = {}
        for name, results in by_name.items():
            accs = np.array([r.final.acc for r in results], float)
            out[name] = {
                "runs": len(results),
                "final_acc_mean": float(accs.mean()),
                "final_acc_std": float(accs.std()),
                "final_acc_min": float(accs.min()),
                "final_acc_max": float(accs.max()),
                "final_loss_mean": float(np.mean(
                    [r.final.loss for r in results])),
                "cum_energy_mean": float(np.mean(
                    [r.final.cum_energy for r in results])),
                "cum_delay_mean": float(np.mean(
                    [r.final.cum_delay for r in results])),
                "rounds": int(np.mean([len(r) for r in results])),
            }
        return out

    def merged(self, other: "SweepResult") -> "SweepResult":
        return SweepResult(runs=self.runs + other.runs)


@dataclasses.dataclass
class _Run:
    """One seeded run inside a sweep: its engine, streams, loop state."""
    seed: int
    engine: object
    ues: list
    state: object


class SequentialSweepExecutor:
    """The round-lockstep loop over a spec's seeds; each run's device work
    goes through its own ``SimExecutor``.

    ``checkpoint_dir`` / ``checkpoint_every`` enable full-state snapshots
    every N rounds; ``resume=True`` restores the latest snapshot (a spec
    mismatch raises).  ``stop_after`` ends the loop after that many
    rounds *with* a snapshot: the tested kill point of the kill-and-resume
    guarantee.
    """

    def __init__(self, *, checkpoint_dir=None, checkpoint_every: int = 0,
                 resume: bool = False, stop_after: Optional[int] = None):
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.resume = resume
        self.stop_after = stop_after
        if (checkpoint_every or stop_after or resume) \
                and not checkpoint_dir:
            raise ValueError("checkpointing/resume needs checkpoint_dir")

    # ------------------------------------------------------ lifecycle --

    def _init_runs(self, ctx: ExperimentContext) -> List[_Run]:
        runs = []
        for seed in ctx.spec.run_seeds:
            engine = ctx.make_engine(seed)
            ues = ctx.make_ues(seed)
            state = engine.init_loop(ues, init_params=ctx.p0,
                                     loss_fn=ctx.loss_fn,
                                     eval_fn=ctx.eval_fn)
            runs.append(_Run(seed=seed, engine=engine, ues=ues,
                             state=state))
        return runs

    def _maybe_resume(self, ctx, runs: List[_Run]) -> None:
        if not (self.resume and self.checkpoint_dir
                and os.path.exists(os.path.join(self.checkpoint_dir,
                                                "manifest.json"))):
            return
        state, reports, spec_json, _ = runstate.load_sweep_state(
            self.checkpoint_dir)
        if spec_json != to_json(ctx.spec):
            raise ValueError(
                f"checkpoint in {self.checkpoint_dir} was written by a "
                f"different spec; refusing to resume")
        for run in runs:
            key = str(run.seed)
            if key not in state:
                raise ValueError(f"checkpoint has no state for seed "
                                 f"{run.seed}")
            runstate.restore_run(run, state[key], reports[key],
                                 run.engine)

    def _save(self, ctx, runs: List[_Run], round_idx: int) -> None:
        if self.checkpoint_dir:
            runstate.save_sweep_state(self.checkpoint_dir, runs,
                                      spec_json=to_json(ctx.spec),
                                      round_idx=round_idx)

    # ----------------------------------------------------- round loop --

    def run_sweep(self, ctx: ExperimentContext, *,
                  trace: Optional[TraceSink] = None) -> SweepResult:
        trace = trace or TraceSink(None)
        runs = self._init_runs(ctx)
        self._maybe_resume(ctx, runs)
        rounds = ctx.spec.engine.rounds
        while True:
            active = [r for r in runs
                      if r.state.t < rounds and not r.state.stopped]
            if not active:
                break
            t = active[0].state.t
            if any(r.state.t != t for r in active):
                raise RuntimeError("lockstep sweep requires equal round "
                                   "indices")
            staged = [r.engine.begin_round(r.state, r.ues)
                      for r in active]
            self._device_phase(ctx, active, staged)
            for run in active:
                rep = run.state.reports[-1]
                trace.write(round_record(ctx.spec.name, run.seed, rep,
                                         executor="sequential"))
            done = t + 1
            if self.checkpoint_every and done % self.checkpoint_every == 0:
                self._save(ctx, runs, done)
            if self.stop_after is not None and done >= self.stop_after:
                self._save(ctx, runs, done)
                break
        return SweepResult(runs=[
            (RunKey(ctx.spec.name, r.seed),
             RunResult(reports=r.state.reports,
                       params=as_tree(r.state.params)))
            for r in runs])

    def _device_phase(self, ctx, active: List[_Run], staged) -> None:
        """Each active run's staged round on the device, then its
        finish, as ``Engine.run`` has them."""
        for run, st in zip(active, staged):
            mean_loss, acc = run.engine.execute_round(run.state, st)
            run.engine.finish_round(run.state, st, mean_loss, acc)
