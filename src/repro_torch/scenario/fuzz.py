"""Property-based scenario fuzzer: engine invariants on random draws.
Counterpart of ``repro.scenario.fuzz``.

Every draw is a full :class:`~repro_torch.experiments.spec.ExperimentSpec`
(scenario: mobility x channel x drift x adversary, via the preset
registry including the randomly composed ``fuzzmix:<seed>`` axis; x
strategy x robust aggregation x engine hyper-parameters x run seed),
drawn from a numpy ``RandomState`` exactly as the JAX package draws it,
and every draw must satisfy the engine's standing invariants:

1. **determinism**: re-running the same spec+seed reproduces the whole
   metric/plan trace bit-exactly;
2. **conservation**: every datapoint a UE observed lands at exactly one
   DPU after ``realize_offloading`` (checked every round);
4. **finiteness**: the parameter plane is finite after every round
   (``torch.isfinite``), and the round loss is finite whenever any UE
   contributed data;
5. **resume**: killing the run at the midpoint, checkpointing through
   ``repro_torch.experiments.runstate``, and restoring into a FRESH
   engine reproduces the remaining rounds bit-exactly.

The JAX package's invariant 3, no-retrace (a replay triggers no XLA
compile), has no counterpart: the port compiles nothing per shape (its
kernels build once, at first use, for every shape), so there is nothing
a replay could recompile.  The numbering keeps the reference's.

Failing draws serialize the exact ExperimentSpec JSON + seed to
``--out`` so any failure is a one-command replay::

    python -m repro_torch.scenario.fuzz --n 25 --seed 0 --device cpu
    python -m repro_torch.scenario.fuzz --replay fuzz_out/failing_draw_3.json

``--break-invariant determinism`` is the gate's selftest: it runs one
draw whose replay deliberately mutates the seed and exits 0 only if the
violation is caught and serialized.  ``--device`` is ``cuda`` unless
given; a CUDA run without a card raises.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
from typing import List, Optional

import numpy as np
import torch

from repro_torch.experiments import presets as _presets  # noqa: F401
from repro_torch.experiments import runstate
from repro_torch.experiments.build import build_context
from repro_torch.experiments.spec import (ConstsSpec, DataSpec, EngineSpec,
                                          ExperimentSpec, ModelSpec,
                                          NetworkSpec, from_json, to_json)
from repro_torch.kernels.plane import as_plane

SCENARIO_POOL = (
    "static", "campus_walk", "campus_walk:fast", "vehicular",
    "flash_crowd", "label_shift", "label_shift:2", "churn",
    "byzantine", "byzantine:0.34", "poisoned", "stragglers",
    # the composed axis: mobility x channel x drift x adversary in one
    # registry string, so failing compositions replay through the spec
    "fuzzmix",
)
STRATEGY_POOL = ("cefl", "greedy_data", "greedy_rate", "fixed:0",
                 "fednova", "fedavg")
ROBUST_POOL = ("none", "none", "trimmed_mean", "median")   # none-weighted


class InvariantViolation(AssertionError):
    """One engine invariant failed on one draw."""

    def __init__(self, invariant: str, detail: str):
        super().__init__(f"[{invariant}] {detail}")
        self.invariant = invariant
        self.detail = detail


# ---------------------------------------------------------- drawing -----

def draw_spec(rng: np.random.RandomState, *, rounds: int = 3) \
        -> ExperimentSpec:
    """One random experiment cell, sized for fuzzing: fixed tiny
    model/network dims with the scenario / strategy / robust-agg / seed
    axes randomized (the reference's draws, in its order)."""
    scenario = SCENARIO_POOL[rng.randint(len(SCENARIO_POOL))]
    if scenario == "fuzzmix":
        scenario = f"fuzzmix:{rng.randint(0, 1000)}"
    return ExperimentSpec(
        name="fuzz_draw",
        model=ModelSpec(input_shape=(8, 8, 1), hidden=(16,)),
        data=DataSpec(pool=2000, mean_arrivals=120.0, std_arrivals=12.0,
                      eval_examples=200),
        network=NetworkSpec(num_ue=4, num_bs=2, num_dc=2),
        consts=ConstsSpec(mode="fixed", L=5.0, theta=2.0, sigma=3.0),
        engine=EngineSpec(
            rounds=rounds,
            eta=float(rng.choice([0.05, 0.1])),
            solver_outer=2,
            reoptimize_every=int(rng.choice([1, 2])),
            eval_every=int(rng.choice([1, 2])),
            robust_agg=ROBUST_POOL[rng.randint(len(ROBUST_POOL))],
            trim_frac=float(rng.choice([0.1, 0.25]))),
        strategy=STRATEGY_POOL[rng.randint(len(STRATEGY_POOL))],
        scenario=scenario,
        seeds=(int(rng.randint(0, 2 ** 16)),))


# ------------------------------------------------------ the invariants --

def _trace_of(reports) -> List[tuple]:
    """The comparable bit-exact trace of a run."""
    return [(r.round, r.loss, r.acc, r.aggregator, r.dc_points,
             r.handovers, r.active_ues, r.energy, r.delay)
            for r in reports]


@dataclasses.dataclass
class _FuzzRun:
    """``runstate``-compatible run shim (same attrs as ``sweep._Run``)."""
    seed: int
    engine: object
    ues: list
    state: object


def _new_run(ctx, seed: int) -> _FuzzRun:
    engine = ctx.make_engine(seed)
    ues = ctx.make_ues(seed)
    state = engine.init_loop(ues, init_params=ctx.p0, loss_fn=ctx.loss_fn,
                             eval_fn=ctx.eval_fn)
    return _FuzzRun(seed=seed, engine=engine, ues=ues, state=state)


def _run_rounds(ctx, seed: int, *, stop_at: Optional[int] = None,
                run: Optional[_FuzzRun] = None) -> _FuzzRun:
    """Drive (or continue) one engine run through the decomposed loop
    (begin_round / execute_round / finish_round), checking conservation
    and finiteness every round."""
    run = run or _new_run(ctx, seed)
    engine, state = run.engine, run.state
    rounds = engine.opts.rounds if stop_at is None \
        else min(stop_at, engine.opts.rounds)
    while state.t < rounds and not state.stopped:
        staged = engine.begin_round(state, run.ues)
        got = sum(len(d["y"]) for d in staged.datasets if d is not None)
        want = int(staged.D_bar.sum())
        if got != want:
            raise InvariantViolation(
                "conservation",
                f"round {staged.t}: {got} datapoints at DPUs vs "
                f"{want} observed (realize_offloading leak)")
        mean_loss, acc = engine.execute_round(state, staged)
        engine.finish_round(state, staged, mean_loss, acc)
        if not bool(torch.isfinite(as_plane(state.params).data).all()):
            raise InvariantViolation(
                "finiteness",
                f"params after round {staged.t}: non-finite values")
        if staged.events.active_ues > 0 and not np.isfinite(mean_loss):
            raise InvariantViolation(
                "finiteness",
                f"round {staged.t}: non-finite loss {mean_loss} with "
                f"{staged.events.active_ues} active UEs")
    return run


def check_draw(spec: ExperimentSpec, *, mutate_seed: bool = False,
               device="cuda") -> None:
    """Assert every engine invariant on one draw on ``device``; raises
    :class:`InvariantViolation`.  ``mutate_seed`` deliberately replays
    under a different seed: the determinism invariant must then fail (the
    ``--break-invariant`` selftest)."""
    ctx = build_context(spec, device=device)
    seed = spec.run_seeds[0]

    # run A: the reference trace
    ref_trace = _trace_of(_run_rounds(ctx, seed).state.reports)

    # run B: the same seed, bit-exact
    replay_seed = seed + 1 if mutate_seed else seed
    rep = _run_rounds(ctx, replay_seed)
    if _trace_of(rep.state.reports) != ref_trace:
        raise InvariantViolation(
            "determinism",
            f"seed {replay_seed} replay trace diverged from seed {seed} "
            f"reference (scenario={spec.scenario}, "
            f"strategy={spec.strategy})")

    # run C: kill at the midpoint, checkpoint, restore into a FRESH
    # engine, finish; the suffix must match the reference trace
    k = max(1, spec.engine.rounds // 2)
    half = _run_rounds(ctx, seed, stop_at=k)
    with tempfile.TemporaryDirectory() as tmp:
        runstate.save_sweep_state(tmp, [half], spec_json=to_json(spec),
                                  round_idx=k)
        state_d, reports_d, _, _ = runstate.load_sweep_state(tmp)
    resumed = _new_run(ctx, seed)
    runstate.restore_run(resumed, state_d[str(seed)], reports_d[str(seed)],
                         resumed.engine)
    _run_rounds(ctx, seed, run=resumed)
    if _trace_of(resumed.state.reports) != ref_trace:
        raise InvariantViolation(
            "resume",
            f"kill-and-resume at round {k} diverged from the straight "
            f"run (scenario={spec.scenario}, strategy={spec.strategy})")


# ----------------------------------------------------- fuzz campaign ----

def _write_artifact(out_dir: str, index: int, spec: ExperimentSpec,
                    err: InvariantViolation, fuzz_seed: int) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"failing_draw_{index}.json")
    with open(path, "w") as fh:
        json.dump({"spec": spec.to_dict(),
                   "seed": spec.run_seeds[0],
                   "invariant": err.invariant,
                   "detail": err.detail,
                   "draw_index": index,
                   "fuzz_seed": fuzz_seed}, fh, indent=1)
    return path


def replay_command(path: str, device="cuda") -> str:
    return (f"PYTHONPATH=src python -m repro_torch.scenario.fuzz --replay "
            f"{path} --device {device}")


def run_fuzz(n: int, seed: int, out_dir: str, *, rounds: int = 3,
             mutate_seed: bool = False, progress=print,
             device="cuda") -> List[str]:
    """Run ``n`` draws on ``device``; returns the artifact paths of
    failing draws."""
    rng = np.random.RandomState(seed)
    artifacts = []
    for i in range(n):
        spec = draw_spec(rng, rounds=rounds)
        label = (f"draw {i}: scenario={spec.scenario} "
                 f"strategy={spec.strategy} "
                 f"robust={spec.engine.robust_agg} seed={spec.run_seeds[0]}")
        try:
            check_draw(spec, mutate_seed=mutate_seed, device=device)
        except InvariantViolation as e:
            path = _write_artifact(out_dir, i, spec, e, seed)
            artifacts.append(path)
            progress(f"[fuzz] FAIL {label}\n       {e}\n"
                     f"       replay: {replay_command(path, device)}")
        else:
            progress(f"[fuzz] ok   {label}")
    return artifacts


def replay(path: str, device="cuda") -> None:
    """Re-run one serialized failing draw (raises on violation)."""
    with open(path) as fh:
        artifact = json.load(fh)
    spec = from_json(json.dumps(artifact["spec"]))
    print(f"[fuzz] replaying {path}: invariant={artifact['invariant']} "
          f"scenario={spec.scenario} strategy={spec.strategy} "
          f"seed={artifact['seed']}")
    check_draw(spec, device=device)
    print("[fuzz] replay passed (the failure did not reproduce)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.scenario.fuzz", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n", type=int, default=10, help="number of draws")
    p.add_argument("--seed", type=int, default=0, help="campaign seed")
    p.add_argument("--rounds", type=int, default=3,
                   help="engine rounds per draw")
    p.add_argument("--out", default="fuzz_out",
                   help="failing-draw artifact directory")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; a CPU run must be "
                        "asked for: --device cpu)")
    p.add_argument("--replay", dest="replay_path", default=None,
                   help="re-run one serialized failing draw and exit")
    p.add_argument("--break-invariant", choices=("determinism",),
                   default=None,
                   help="selftest: deliberately violate an invariant and "
                        "verify the fuzzer catches + serializes it")
    args = p.parse_args(argv)

    if args.replay_path:
        try:
            replay(args.replay_path, device=args.device)
        except InvariantViolation as e:
            print(f"[fuzz] replay FAILED: {e}")
            return 1
        return 0

    if args.break_invariant:
        artifacts = run_fuzz(1, args.seed, args.out, rounds=args.rounds,
                             mutate_seed=True, device=args.device)
        if not artifacts:
            print("[fuzz] selftest FAILED: the mutated-seed replay was "
                  "NOT caught")
            return 1
        print(f"[fuzz] selftest ok: broken {args.break_invariant} caught "
              f"and serialized to {artifacts[0]}")
        return 0

    artifacts = run_fuzz(args.n, args.seed, args.out, rounds=args.rounds,
                         device=args.device)
    if artifacts:
        print(f"[fuzz] {len(artifacts)}/{args.n} draws FAILED; artifacts "
              f"in {args.out}/")
        for a in artifacts:
            print(f"  {replay_command(a, args.device)}")
        return 1
    print(f"[fuzz] all {args.n} draws passed every engine invariant")
    return 0


if __name__ == "__main__":
    sys.exit(main())
