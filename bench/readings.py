"""The readings that a cell's limits are set from, at the cell's own size.

    python3 bench/readings.py --workload <name> --seeds 1,2,3 \
        --modes program,control,half_batch

For each seed, in one process: the cell's set-up (which drives the
rounds the reference follows) and no measured window, then the compared
numbers of each mode: ``program`` (the program's run), ``control`` (the
reference a precision below the configuration's in the program's place)
and ``half_batch`` (the reference with half of each mini-batch left out,
a planted fault).  One JSON line per seed and mode on standard output.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", default="program,control,half_batch")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from bench import run
    from bench.trace import Tracer

    if not torch.cuda.is_available():
        run.fail("the readings are taken on a CUDA device", 3)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, _, config, workload = run.load_cell(args.workload)
    driver = importlib.import_module(f"bench.drivers.{workload['driver']}")
    for seed in (int(s) for s in args.seeds.split(",")):
        r = driver.make(config, workload, seed, torch.device("cuda"),
                        Tracer(False))
        r.setup()
        r.close_program()
        torch.cuda.empty_cache()
        for mode in args.modes.split(","):
            t0 = time.perf_counter()
            out = r.readings(mode)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "mode": mode, "readings": out,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
        del r
    return 0


if __name__ == "__main__":
    sys.exit(main())
