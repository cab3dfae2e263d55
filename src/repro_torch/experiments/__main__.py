"""CLI for the declarative experiment API.  Counterpart of
``python -m repro.experiments``.

    python -m repro_torch.experiments list
    python -m repro_torch.experiments show quickstart
    python -m repro_torch.experiments run quickstart            # on the card
    python -m repro_torch.experiments run quickstart --device cpu
    python -m repro_torch.experiments run campus_walk_vs_fixed \\
        --set strategy=fixed:0 --seeds 0,1 --set engine.rounds=10
    python -m repro_torch.experiments run sweep_smoke --device cpu \
        --trace out/trace.jsonl
    python -m repro_torch.experiments run sweep_smoke --device cpu \
        --checkpoint out/ck --stop-after 2
    python -m repro_torch.experiments run sweep_smoke --device cpu \
        --checkpoint out/ck --resume
    python -m repro_torch.experiments validate paper_table1 --device cpu
    python -m repro_torch.experiments run lm_smoke --device cpu

``NAME`` is a preset (``list`` shows them) or a path to a spec JSON
(written by ``show`` / ``--dump``).  ``--set`` takes dotted spec paths.
``run`` runs every seed as a lockstep sweep; a single seed with an
``engine.mesh_shape``, and no checkpoint flag, runs through the engine
with per-round lines.
``--checkpoint DIR`` keeps full-state snapshots (every
``--checkpoint-every`` rounds, and at ``--stop-after N``); ``--resume``
continues from the snapshot and appends to the ``--trace`` file.
An LM spec (``lm_smoke``, ``lm_mamba2_130m``) runs its one seed through
``experiments.lm.run_lm``.  ``--device`` is ``cuda`` unless given, and a
CUDA run without a card raises.

The sharded round runs under torchrun, every rank the same loop and rank
0 alone printing and writing the trace; ``--backend`` names the
torch.distributed backend (gloo for ranks that share a card, nccl for a
card per rank)::

    torchrun --nproc-per-node 4 -m repro_torch.experiments run quickstart \
        --set mesh_shape=2,2 --backend gloo
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch
import torch.distributed as dist

from repro_torch.device import require_device
from repro_torch.experiments import (TraceSink, available_experiments,
                                     build_context, from_json,
                                     get_experiment, run as run_one, sweep,
                                     to_json)
from repro_torch.experiments.lm import lm_config


def _load_spec(name: str):
    if name.endswith(".json") or os.path.sep in name:
        with open(name) as f:
            return from_json(f.read())
    return get_experiment(name)


# --set keys that name a nested spec field by its last part
_SHORT_KEYS = {"mesh_shape": "engine.mesh_shape",
               "sanitize": "engine.sanitize"}


def _apply_overrides(spec, args):
    updates = {}
    for kv in args.set or []:
        k, _, v = kv.partition("=")
        if not _:
            raise SystemExit(f"--set needs key=value, got {kv!r}")
        updates[_SHORT_KEYS.get(k, k)] = v
    if args.seeds:
        updates["seeds"] = tuple(
            int(s) for s in args.seeds.replace(",", " ").split())
    if args.rounds is not None:
        updates["engine.rounds"] = args.rounds
    if args.strategy:
        updates["strategy"] = args.strategy
    if args.scenario:
        updates["scenario"] = args.scenario
    return spec.override(**updates) if updates else spec


def _cmd_list(args):
    for name in available_experiments():
        spec = get_experiment(name)
        print(f"{name:22s} kind={spec.model.kind:10s} "
              f"strategy={spec.strategy:12s} scenario={spec.scenario:16s} "
              f"rounds={spec.engine.rounds:<4d} seeds={list(spec.seeds)}")
    return 0


def _cmd_show(args):
    spec = _apply_overrides(_load_spec(args.name), args)
    print(to_json(spec))
    return 0


def _join_group(args) -> bool:
    """Under torchrun (``WORLD_SIZE`` set) join the default group with
    ``--backend`` and put this rank on card LOCAL_RANK mod the card count
    for a CUDA ``--device``.  Returns whether this call started the
    group (and must destroy it)."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    if args.backend is None:
        raise SystemExit("a torchrun launch needs --backend gloo (ranks "
                         "sharing a card, or the CPU) or --backend nccl "
                         "(one card per rank)")
    if torch.device(args.device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
    dist.init_process_group(args.backend, init_method="env://")
    return True


def _cmd_run(args):
    started = _join_group(args)
    try:
        return _run(args, lead=not dist.is_initialized()
                    or dist.get_rank() == 0)
    finally:
        if started:
            dist.destroy_process_group()


def _run(args, lead: bool):
    """``run``; only the ``lead`` rank (rank 0, or the only process)
    prints, dumps and writes the trace: every rank runs the same loop."""
    spec = _apply_overrides(_load_spec(args.name), args)
    if args.dump and lead:
        with open(args.dump, "w") as f:
            f.write(to_json(spec))
    if (args.checkpoint_every or args.stop_after or args.resume) \
            and not args.checkpoint:
        raise SystemExit("--checkpoint-every/--stop-after/--resume need "
                         "--checkpoint <dir>")
    if spec.model.kind == "lm" and (args.checkpoint or args.resume
                                    or args.stop_after):
        raise SystemExit(
            "--checkpoint/--resume/--stop-after apply to classifier "
            "sweeps; for lm specs use repro_torch.experiments.lm.run_lm("
            "spec, checkpoint=...) directly")
    # append on resume: the pre-kill rounds are already in the file
    trace = TraceSink(args.trace, append=args.resume) \
        if args.trace and lead else None
    out = print if lead else (lambda *a, **k: None)
    # a sharded spec of one seed runs through the engine, whose executor
    # shards the fused round
    engine_run = len(spec.run_seeds) == 1 and not args.checkpoint \
        and spec.engine.mesh_shape is not None
    try:
        if spec.model.kind == "lm":
            res = run_one(spec, device=args.device, trace=trace)
            out(f"final loss {res.final.loss:.4f}")
            return 0
        if engine_run:
            out(_HEADER)
            res = run_one(spec, device=args.device, trace=trace,
                          callbacks=(lambda r: out(_round_line(r)),))
            out(_final_line(spec.name, spec.run_seeds[0], res))
            return 0
        result = sweep(spec, device=args.device, trace=trace,
                       checkpoint_dir=args.checkpoint,
                       checkpoint_every=args.checkpoint_every,
                       resume=args.resume, stop_after=args.stop_after)
    finally:
        if trace:
            trace.close()
    for key, res in result.runs:
        out(_final_line(key.experiment, key.seed, res))
    out("\naggregate stats:")
    out(json.dumps(result.stats(), indent=1))
    return 0


_HEADER = "round  acc    loss   aggregator  energy(J)  delay(s)"


def _round_line(r) -> str:
    return (f"{r.round:5d}  {r.acc:.3f}  {r.loss:6.3f}  "
            f"DC{r.aggregator:<9d} {r.energy:9.2f} {r.delay:9.2f}")


def _final_line(name, seed, res) -> str:
    f = res.final
    return (f"[{name} seed={seed}] rounds={len(res)} acc={f.acc:.3f} "
            f"loss={f.loss:.3f} E={f.cum_energy:.1f}J "
            f"delay={f.cum_delay:.1f}s "
            f"aggregators={res.series('aggregator')}")


def _cmd_validate(args):
    spec = _apply_overrides(_load_spec(args.name), args)
    back = from_json(to_json(spec))
    if back != spec:
        raise SystemExit("spec JSON round-trip failed")
    if spec.model.kind == "lm":
        require_device(args.device)
        lm_config(spec.model)
    else:
        build_context(spec, device=args.device)
    print(f"spec {spec.name!r} OK (json round-trip + context build)")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.experiments")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="available presets")
    for cmd in ("show", "run", "validate"):
        p = sub.add_parser(cmd)
        p.add_argument("name", help="preset name or spec JSON path")
        p.add_argument("--set", action="append", metavar="PATH=VALUE",
                       help="dotted spec override, e.g. engine.rounds=4")
        p.add_argument("--seeds", help="comma-separated seed list")
        p.add_argument("--rounds", type=int)
        p.add_argument("--strategy")
        p.add_argument("--scenario")
        if cmd in ("run", "validate"):
            p.add_argument("--device", default="cuda",
                           help="torch device (default cuda; a CPU run "
                                "must be asked for: --device cpu)")
        if cmd == "run":
            p.add_argument("--trace", help="JSONL trace output path")
            p.add_argument("--dump", help="write the resolved spec JSON")
            p.add_argument("--checkpoint", help="full-state snapshot dir")
            p.add_argument("--checkpoint-every", type=int, default=0)
            p.add_argument("--resume", action="store_true")
            p.add_argument("--stop-after", type=int, default=None,
                           help="stop (with snapshot) after N rounds")
            p.add_argument("--backend", choices=("gloo", "nccl"),
                           help="torch.distributed backend of a torchrun "
                                "launch: gloo when ranks share a card (or "
                                "run on the CPU), nccl when each rank owns "
                                "one")
    args = ap.parse_args(argv)
    if args.cmd == "list":
        return _cmd_list(args)
    return {"show": _cmd_show, "run": _cmd_run,
            "validate": _cmd_validate}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
