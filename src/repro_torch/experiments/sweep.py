"""Multi-seed sweep executors: K seeded runs, one batched device axis.
Counterpart of ``repro.experiments.sweep``.

Both executors drive K per-run :class:`~repro_torch.core.engine.LoopState`s
through the SAME ``Engine.begin_round`` / ``finish_round`` host path
(scenario ticks, solver decisions, offloading, the numpy and torch
random streams: per run, as a solo ``Engine.run`` has them) and differ
only in how the device work executes:

* :class:`SequentialSweepExecutor`: each run's round goes through its own
  ``SimExecutor.run_round``.  Every per-seed result equals
  ``experiments.run(spec, seed=s)`` bit for bit.
* :class:`VmapSweepExecutor`: a (gamma, m, bucket) DPU group that more
  than one run holds in a round trains in ONE group on the leading axis
  of the parameter plane (``fedprox.train_multi_staged``: each element
  proximal to its own run's global model, one ``fedprox_accum`` launch
  per group and step), and those runs' eval runs once over their stacked
  planes (``torch.func.vmap`` of the eval function on
  ``spec.unflatten_batched``).  A run that shares no group with another
  runs its round as the sequential executor does, so the executor
  merges only where a merge saves launches.

Randomness.  A run's mini-batch draws come from its own
``torch.Generator``, one ``torch.rand((gamma, D_i))`` per DPU in the order
``SimExecutor`` draws them (``engine.dpu_groups``); the vmap executor
makes those draws per run, in that order, before it concatenates across
runs, and each run's Gaussian corruption noise after them, as
``SimExecutor`` does.  So both executors feed every element the same
mini-batches.

What is exact between the two executors: the run's structure (plans,
aggregators, ``dc_points``, handovers, active UEs, energy, delay).  The
parameters, losses and accuracy are the same math per element, but the
classifier's ``torch.bmm`` (``models/classifier.py``) runs over the
cross-run group, whose batch count differs from a run's own group, and a
BLAS may pick its algorithm by batch count; likewise the batched eval.
So they agree to float rounding (tests hold them at ``rtol 1e-6``), and
bit for bit where the counts match (one seed).

Both executors write per-round JSONL records through a
:class:`~repro_torch.experiments.trace.TraceSink` and checkpoint / resume
full run state through ``repro_torch.experiments.runstate``.
"""
from __future__ import annotations

import dataclasses
import os
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import fedprox
from repro_torch.core.api import RunResult, weighted_mean
from repro_torch.core.engine import (SimExecutor, dpu_groups, fused_theta,
                                     fuses, live_dpus)
from repro_torch.experiments import runstate
from repro_torch.experiments.build import ExperimentContext
from repro_torch.experiments.spec import to_json
from repro_torch.experiments.trace import TraceSink, round_record
from repro_torch.kernels.plane import as_plane, as_tree


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


class _LockstepSweep:
    """Shared round-lockstep loop; subclasses provide the device phase.

    ``checkpoint_dir`` / ``checkpoint_every`` enable full-state snapshots
    every N rounds; ``resume=True`` restores the latest snapshot (a spec
    mismatch raises).  ``stop_after`` ends the loop after that many
    rounds *with* a snapshot: the tested kill point of the kill-and-resume
    guarantee.
    """

    executor_name = "sequential"

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
                                         executor=self.executor_name))
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
        raise NotImplementedError


class SequentialSweepExecutor(_LockstepSweep):
    """Per-run device work through each run's own SimExecutor: the
    bit-exactness oracle against ``experiments.run``."""

    executor_name = "sequential"

    def _device_phase(self, ctx, active, staged) -> None:
        for run, st in zip(active, staged):
            mean_loss, acc = run.engine.execute_round(run.state, st)
            run.engine.finish_round(run.state, st, mean_loss, acc)


@dataclasses.dataclass
class _Member:
    """One live (run k, DPU position j) element of a cross-run group,
    with its staged mini-batch draws (``(gamma, bucket)`` columns)."""
    k: int
    j: int
    data: dict
    D: int
    idx: torch.Tensor
    wts: torch.Tensor


class VmapSweepExecutor(_LockstepSweep):
    """The K runs' device work merged across runs where their groups
    match.

    A (gamma, m, bucket) DPU group that more than one run holds this
    round trains once for all of them: one ``fedprox.train_multi_staged``
    call (per-element anchor = that run's global plane).  A run that holds
    no such group runs its round through its own ``SimExecutor``, as the
    sequential executor does, so when no group is shared (the ``cefl``
    strategy's per-DPU settings) the two executors do the same work.  A
    run that takes part in a merge trains its other groups on its own
    from its staged draws and then finishes as ``SimExecutor`` would: one
    fusable group takes the fused round's eq. 10 + eq. 11
    (``fedprox._aggregate_group``), any other round
    ``SimExecutor._aggregate_results``.  The merged runs' eval is ONE call
    over their stacked planes.  Host-side decisions (scenario, solver,
    offloading) stay per run, so the run structure matches the sequential
    executor exactly.
    """

    executor_name = "vmap"

    def _device_phase(self, ctx, active, staged) -> None:
        plans = []
        for run, st in zip(active, staged):
            live = live_dpus(st.datasets)
            run_groups = dpu_groups(st.plan, live) if live else {}
            plans.append((live, run_groups, fuses(
                run_groups, run.engine.aggregation, st.events.corrupted,
                run.engine.opts.robust_agg)))
        holders = Counter(key for _, g, _ in plans for key in g)
        merged = [k for k, (_, g, _) in enumerate(plans)
                  if any(holders[key] > 1 for key in g)]
        outcome = {}                          # k -> (mean_loss, acc)
        for k, (run, st) in enumerate(zip(active, staged)):
            if k not in merged:
                outcome[k] = run.engine.execute_round(run.state, st)
        if merged:
            outcome.update(self._merged_rounds(
                ctx, [active[k] for k in merged],
                [staged[k] for k in merged], [plans[k] for k in merged],
                merged))
        for k, (run, st) in enumerate(zip(active, staged)):
            run.engine.finish_round(run.state, st, *outcome[k])

    @staticmethod
    def _merged_rounds(ctx, runs, staged, plans, keys):
        """Train, aggregate and evaluate the runs that share groups;
        returns ``{key: (mean_loss, acc)}`` per run."""
        dev = ctx.device
        eng0 = runs[0].engine
        eta, mu = eng0.opts.eta, eng0.mu_effective
        # 1. per run, in SimExecutor's order: each group's draws
        groups = {}
        for k, (run, (live, run_groups, _)) in enumerate(zip(runs, plans)):
            for (gamma, m, bucket), idxs in run_groups.items():
                Ds = [len(live[j][1]["y"]) for j in idxs]
                idx, wts = fedprox._draw_indices(
                    run.state.generator, Ds, bucket, gamma, m, dev)
                groups.setdefault((gamma, m, bucket), []).extend(
                    _Member(k, j, live[j][1], D, idx[:, c], wts[:, c])
                    for c, (j, D) in enumerate(zip(idxs, Ds)))
        # 2. one training call per group, across runs
        trained = [dict() for _ in runs]      # k -> {j: (row, acc, result)}
        for (gamma, m, _bucket), members in groups.items():
            spec = as_plane(runs[members[0].k].state.params).spec
            Ds = [mb.D for mb in members]
            p_stack, acc, losses = fedprox.train_multi_staged(
                torch.stack([as_plane(runs[mb.k].state.params).data
                             for mb in members]), spec, ctx.loss_fn,
                fedprox._stack_data([mb.data for mb in members], Ds, dev),
                torch.stack([mb.idx for mb in members], dim=1),
                torch.stack([mb.wts for mb in members], dim=1),
                gamma=gamma, eta=eta, mu=mu)
            results = fedprox._group_results(
                spec, p_stack, acc, losses, Ds, gamma=gamma, m_frac=m,
                eta=eta, mu=mu)
            for row, (mb, res) in enumerate(zip(members, results)):
                trained[mb.k][mb.j] = (row, acc, res)
        # 3. per run: the fused finish, or SimExecutor's
        mean_losses = []
        for k, (run, st) in enumerate(zip(runs, staged)):
            live, run_groups, fused = plans[k]
            engine, opts = run.engine, run.engine.opts
            anchor = as_plane(run.state.params)
            if fused:
                (gamma, _m, _b), idxs = next(iter(run_groups.items()))
                rows = [trained[k][j] for j in idxs]
                acc = rows[0][1]
                run_acc = acc[torch.tensor([r for r, _, _ in rows],
                                           device=acc.device)]
                Ds = [res.num_examples for _, _, res in rows]
                new = fedprox._aggregate_group(
                    anchor.data, run_acc,
                    fedprox.a_coefficients(gamma, eta, mu),
                    torch.tensor(Ds, dtype=torch.float32),
                    fused_theta(engine.aggregation, opts.theta, gamma)
                    * eta)
                run.state.params = anchor.with_data(new)
                mean_losses.append(weighted_mean(
                    [res.loss for _, _, res in rows], Ds))
                continue
            run.state.params, mean_loss, _ = \
                SimExecutor._aggregate_results(
                    anchor, [trained[k][j][2] for j in range(len(live))],
                    live, agg=engine.aggregation, eta=eta,
                    theta=opts.theta, generator=run.state.generator,
                    corrupt=st.events.corrupted,
                    robust_agg=opts.robust_agg, trim_frac=opts.trim_frac)
            mean_losses.append(mean_loss)
        # 4. ONE eval over the merged runs' stacked planes (the eval
        # cadence is spec-level, so every run evals on the same rounds)
        if eng0.should_eval(staged[0].t):
            planes = [as_plane(r.state.params) for r in runs]
            stacked = torch.stack([p.data for p in planes])
            with torch.no_grad():
                accs = torch.func.vmap(ctx.eval_fn)(
                    planes[0].spec.unflatten_batched(stacked))
            accs = [float(a) for a in accs.cpu()]
        else:
            accs = [r.state.last_acc for r in runs]
        return {key: (loss, acc) for key, loss, acc
                in zip(keys, mean_losses, accs)}


_EXECUTORS = {
    "sequential": SequentialSweepExecutor,
    "vmap": VmapSweepExecutor,
}


def get_sweep_executor(name, **kw) -> _LockstepSweep:
    if isinstance(name, _LockstepSweep):
        if any(v for v in kw.values()):
            raise ValueError(
                "cannot combine a pre-configured executor instance with "
                f"executor kwargs {sorted(k for k, v in kw.items() if v)}; "
                "pass the executor name and the kwargs, or configure the "
                "instance itself")
        return name
    try:
        cls = _EXECUTORS[name]
    except KeyError:
        raise KeyError(f"unknown sweep executor {name!r}; available: "
                       f"{sorted(_EXECUTORS)}") from None
    return cls(**kw)
