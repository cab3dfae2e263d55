"""End-to-end driver: parameter estimation (Algs. 4-6) -> network-aware
CE-FL vs FedNova vs FedAvg with per-strategy accuracy / energy / delay
(Tables I-II style) — expressed as a declarative spec grid: one base
spec (estimated constants included), three strategy overrides, one
``experiments.sweep`` call.  Counterpart of
``examples/cefl_vs_baselines.py``.

  python -m repro_torch.examples.cefl_vs_baselines [--rounds 20] [--full]
  python -m repro_torch.examples.cefl_vs_baselines --device cpu
"""
import argparse

from repro_torch import experiments as E
from repro_torch.experiments.spec import (ConstsSpec, DataSpec, EngineSpec,
                                          ExperimentSpec, ModelSpec,
                                          NetworkSpec)

STRATEGIES = ("cefl", "fednova", "fedavg")


def base_spec(full: bool, rounds: int) -> ExperimentSpec:
    if full:
        net, img, hidden, arrivals = (20, 10, 5), (28, 28, 1), \
            (200, 100), 2000.0
    else:
        net, img, hidden, arrivals = (8, 4, 3), (14, 14, 1), (64,), 400.0
    return ExperimentSpec(
        name="cefl_vs_baselines",
        model=ModelSpec(input_shape=img, hidden=hidden),
        data=DataSpec(pool=20000, mean_arrivals=arrivals,
                      std_arrivals=arrivals / 10, eval_examples=1000),
        network=NetworkSpec(num_ue=net[0], num_bs=net[1], num_dc=net[2]),
        consts=ConstsSpec(mode="estimate", estimate_iters=3),
        engine=EngineSpec(rounds=rounds, eta=0.1, solver_outer=3,
                          reoptimize_every=3),
        strategy="cefl", scenario="static", seeds=(0,))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--full", action="store_true",
                    help="paper-size network (20 UE / 10 BS / 5 DC) and "
                         "28x28 images")
    ap.add_argument("--device", default="cuda",
                    help="torch device (a CPU run must be asked for)")
    args = ap.parse_args(argv)

    base = base_spec(args.full, args.rounds)
    print("[1/3] building context (one-shot Algs. 4-6 estimation) ...")
    ctx = E.build_context(base, device=args.device)
    c = ctx.consts
    print(f"    L={c.L:.2f} zeta1={c.zeta1:.2f} zeta2={c.zeta2:.2f} "
          f"Theta~{c.theta_i.mean():.2f} sigma~{c.sigma_i.mean():.2f}")

    print("[2/3] running CE-FL and baselines ...")
    specs = [base.override(**{"name": strat, "strategy": strat})
             for strat in STRATEGIES]
    result = E.sweep(specs, device=args.device)
    finals = {}
    for strat in STRATEGIES:
        res = result.result(0, strat)
        finals[strat] = res.final
        print(f"    {strat:8s} acc {res.final.acc:.3f}  "
              f"loss {res.final.loss:.3f}  "
              f"E {res.final.cum_energy:9.1f} J  "
              f"delay {res.final.cum_delay:8.1f} s")

    print("[3/3] summary (CE-FL savings vs baselines at final round):")
    for baseline in ("fednova", "fedavg"):
        e0 = finals[baseline].cum_energy
        e1 = finals["cefl"].cum_energy
        print(f"    energy vs {baseline}: {100 * (1 - e1 / e0):+.1f}%")
    return result


if __name__ == "__main__":
    main()
