"""Mobility demo: watch the floating aggregation point actually float
(counterpart of ``examples/mobility_demo.py``).

Runs the registered ``campus_walk_vs_fixed`` spec (random-waypoint UE
mobility -> fresh Shannon rates -> handovers -> data re-concentration)
under the network-aware ``cefl`` strategy and under a ``fixed:0``
baseline — two cells of one declarative spec grid.  CE-FL's aggregation
point migrates to chase the data/rate concentration while the baseline
stays put; every handover and migration is recorded on the per-round
:class:`~repro_torch.core.api.RoundReport`.

  python -m repro_torch.examples.mobility_demo
  python -m repro_torch.examples.mobility_demo --scenario vehicular
  python -m repro_torch.examples.mobility_demo --device cpu
"""
import argparse

from repro_torch import experiments as E
from repro_torch.scenario import available_scenarios


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--scenario", default="campus_walk",
                    choices=available_scenarios())
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (a CPU run must be asked for)")
    args = ap.parse_args(argv)

    base = E.get_experiment("campus_walk_vs_fixed").override(**{
        "scenario": args.scenario, "engine.rounds": args.rounds,
        "seeds": (args.seed,)})
    specs = [base.override(**{"name": "cefl", "strategy": "cefl"}),
             base.override(**{"name": "fixed", "strategy": "fixed:0"})]
    results = {}
    for spec in specs:
        print(f"== {spec.strategy} under scenario {args.scenario!r} ==")
        res = E.sweep(spec, device=args.device).result(args.seed)
        results[spec.name] = res
        print("round | agg DC | moved | handovers           | active UEs")
        for r in res.reports:
            ho = " ".join(f"{u}:{a}->{b}" for u, a, b in r.handovers)
            print(f"{r.round:5d} | DC {r.aggregator}   | "
                  f"{'MOVE ' if r.aggregator_moved else '  .  '} | "
                  f"{ho:19s} | {r.active_ues}")
        print()

    cefl, fixed = results["cefl"], results["fixed"]
    migrations = sum(r.aggregator_moved for r in cefl.reports)
    handovers = sum(len(r.handovers) for r in cefl.reports)
    print(f"cefl:    {migrations} aggregation-point migrations, "
          f"{handovers} UE handovers, final acc {cefl.final.acc:.3f}")
    print(f"fixed:0: {sum(r.aggregator_moved for r in fixed.reports)} "
          f"migrations (stays at DC 0), final acc {fixed.final.acc:.3f}")
    if migrations < 1:
        raise AssertionError("expected the floating aggregator to migrate")
    if handovers < 1:
        raise AssertionError("expected at least one UE handover")
    if any(r.aggregator_moved for r in fixed.reports):
        raise AssertionError("the fixed:0 aggregator moved")
    print("OK: the aggregation point floats under cefl and stays put "
          "under fixed:0")
    return results


if __name__ == "__main__":
    main()
