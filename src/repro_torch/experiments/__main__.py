"""CLI for the declarative experiment API.  Counterpart of
``python -m repro.experiments``.

    python -m repro_torch.experiments list
    python -m repro_torch.experiments show quickstart
    python -m repro_torch.experiments run quickstart            # on the card
    python -m repro_torch.experiments run quickstart --device cpu
    python -m repro_torch.experiments run campus_walk_vs_fixed \\
        --set strategy=fixed:0 --seeds 0,1 --set engine.rounds=10
    python -m repro_torch.experiments validate paper_table1 --device cpu

``NAME`` is a preset (``list`` shows them) or a path to a spec JSON
(written by ``show`` / ``--dump``).  ``--set`` takes dotted spec paths.
``run`` runs each seed in turn through the engine; ``--device`` is
``cuda`` unless given, and a CUDA run without a card raises.  The
reference's sweep executors, checkpoints and resume are ROADMAP queue 1
item 4.
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.experiments import (TraceSink, available_experiments,
                                     build_context, from_json,
                                     get_experiment, run as run_one, to_json)


def _load_spec(name: str):
    if name.endswith(".json") or os.path.sep in name:
        with open(name) as f:
            return from_json(f.read())
    return get_experiment(name)


def _apply_overrides(spec, args):
    updates = {}
    for kv in args.set or []:
        k, _, v = kv.partition("=")
        if not _:
            raise SystemExit(f"--set needs key=value, got {kv!r}")
        updates[k] = v
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
        try:
            spec = get_experiment(name)
        except NotImplementedError as e:
            print(f"{name:22s} not ported: {e}")
            continue
        print(f"{name:22s} kind={spec.model.kind:10s} "
              f"strategy={spec.strategy:12s} scenario={spec.scenario:16s} "
              f"rounds={spec.engine.rounds:<4d} seeds={list(spec.seeds)}")
    return 0


def _cmd_show(args):
    spec = _apply_overrides(_load_spec(args.name), args)
    print(to_json(spec))
    return 0


def _cmd_run(args):
    spec = _apply_overrides(_load_spec(args.name), args)
    if args.dump:
        with open(args.dump, "w") as f:
            f.write(to_json(spec))
    trace = TraceSink(args.trace) if args.trace else None
    try:
        for seed in spec.run_seeds:
            _print_header()
            res = run_one(spec, seed=seed, device=args.device, trace=trace,
                          callbacks=(_print_round,))
            _print_final(spec.name, seed, res)
    finally:
        if trace:
            trace.close()
    return 0


def _print_header():
    print("round  acc    loss   aggregator  energy(J)  delay(s)")


def _print_round(r):
    print(f"{r.round:5d}  {r.acc:.3f}  {r.loss:6.3f}  DC{r.aggregator:<9d}"
          f" {r.energy:9.2f} {r.delay:9.2f}")


def _print_final(name, seed, res):
    f = res.final
    print(f"[{name} seed={seed}] rounds={len(res)} acc={f.acc:.3f} "
          f"loss={f.loss:.3f} E={f.cum_energy:.1f}J "
          f"delay={f.cum_delay:.1f}s aggregators={res.series('aggregator')}")


def _cmd_validate(args):
    spec = _apply_overrides(_load_spec(args.name), args)
    back = from_json(to_json(spec))
    if back != spec:
        raise SystemExit("spec JSON round-trip failed")
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
    args = ap.parse_args(argv)
    if args.cmd == "list":
        return _cmd_list(args)
    return {"show": _cmd_show, "run": _cmd_run,
            "validate": _cmd_validate}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
