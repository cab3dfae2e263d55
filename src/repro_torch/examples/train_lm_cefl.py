"""Train an LM with the mesh-native CE-FL round — the ``lm_smoke`` /
``lm_mamba2_130m`` presets run through the spec API (counterpart of
``examples/train_lm_cefl.py``).  With no flags this trains the reduced
mamba2 smoke model; ``--full`` trains mamba2-130m at full width and
depth and writes its checkpoint to ``results/ckpt_mamba2_cefl`` under
the working directory:

  python -m repro_torch.examples.train_lm_cefl                   # smoke
  python -m repro_torch.examples.train_lm_cefl --full            # 130M
  python -m repro_torch.examples.train_lm_cefl --device cpu

Equivalent CLI:  python -m repro_torch.experiments run lm_smoke
"""
import argparse

from repro_torch.experiments import get_experiment
from repro_torch.experiments.lm import run_lm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="full mamba2-130m (~130M params), 200 rounds")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (a CPU run must be asked for)")
    args = ap.parse_args(argv)
    if args.full:
        spec = get_experiment("lm_mamba2_130m")
        if args.steps:
            spec = spec.override(**{"engine.rounds": args.steps})
        return run_lm(spec, checkpoint="results/ckpt_mamba2_cefl",
                      device=args.device)
    spec = get_experiment("lm_smoke").override(
        **{"engine.rounds": args.steps or 30, "model.gamma": 2})
    return run_lm(spec, device=args.device)


if __name__ == "__main__":
    main()
