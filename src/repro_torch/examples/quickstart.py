"""Quickstart: CE-FL on a synthetic edge network (counterpart of
``examples/quickstart.py``).

One declarative spec — the registered ``quickstart`` preset — builds the
6-UE / 3-BS / 2-DC network, streams non-iid online data to the UEs, lets
the network-aware solver pick offloading + the floating aggregation DC
each round, and trains the paper's image classifier cooperatively at
UEs+DCs.  Equivalent CLI:

  python -m repro_torch.experiments run quickstart

This script is the library-API version of the same run:

  python -m repro_torch.examples.quickstart                # on the card
  python -m repro_torch.examples.quickstart --device cpu
"""
import argparse

from repro_torch import experiments


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (a CPU run must be asked for)")
    args = ap.parse_args(argv)

    spec = experiments.get_experiment("quickstart")
    print(f"spec: {spec.name} — {spec.network.num_ue} UEs / "
          f"{spec.network.num_bs} BSs / {spec.network.num_dc} DCs, "
          f"strategy={spec.strategy}, {spec.engine.rounds} rounds")
    print("\nround  acc    loss   aggregator  energy(J)  delay(s)")

    def show(r):
        print(f"{r.round:5d}  {r.acc:.3f}  {r.loss:.3f}  "
              f"DC{r.aggregator:<9d} {r.energy:9.2f} {r.delay:9.2f}")

    result = experiments.run(spec, callbacks=(show,), device=args.device)

    final = result.final
    print(f"\nfinal accuracy {final.acc:.3f}; "
          f"total energy {final.cum_energy:.1f} J, "
          f"total delay {final.cum_delay:.1f} s")
    return result


if __name__ == "__main__":
    main()
