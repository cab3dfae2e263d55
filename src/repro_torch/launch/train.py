"""CE-FL LM training launcher: an argparse shim over
``repro_torch.experiments.lm.run_lm``.  Counterpart of
``repro.launch.train``, with the same flags plus ``--device``.

    python -m repro_torch.launch.train --arch mamba2-130m \\
        --steps 20 --batch 8 --seq 256 [--reduced] [--gamma 2]
    python -m repro_torch.launch.train --reduced --device cpu

is the same run as

    python -m repro_torch.experiments run lm_smoke \\
        --set model.arch=mamba2-130m --set engine.rounds=20 ...

``--device`` is ``cuda`` unless given; a CUDA run without a card raises.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    """Parse the flags, train, and return the per-round losses."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--n-dpu", type=int, default=2)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--gamma", type=int, default=1)
    ap.add_argument("--eta", type=float, default=3e-2)
    ap.add_argument("--mu", type=float, default=0.01)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-sized config variant")
    ap.add_argument("--tree", action="store_true",
                    help="run the per-leaf tree round instead of the "
                         "flat-plane kernel path")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; a CPU run must be "
                         "asked for: --device cpu)")
    args = ap.parse_args(argv)

    from repro_torch.experiments import get_experiment
    from repro_torch.experiments.lm import run_lm

    spec = get_experiment("lm_smoke").override(**{
        "name": "launch.train",
        "model.arch": args.arch,
        "model.reduced": args.reduced,
        "model.batch": args.batch,
        "model.seq": args.seq,
        "model.n_dpu": args.n_dpu,
        "model.n_micro": args.n_micro,
        "model.gamma": args.gamma,
        "engine.rounds": args.steps,
        "engine.eta": args.eta,
        "engine.mu": args.mu,
        "seeds": (args.seed,),
    })
    result = run_lm(spec, checkpoint=args.checkpoint,
                    use_plane=not args.tree, device=args.device)
    return [r.loss for r in result.reports]


if __name__ == "__main__":
    main()
