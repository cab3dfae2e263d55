"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is looked up by name in ``BENCHMARK.json``; its configuration
(``bench/configs/<config>.json``), its traffic and driver
(``bench/workloads/<name>.json``) and its per-layer metrics
(``bench/layer_metrics/<metric>.py``) are found by name.  The run makes
its inputs from the seed, sets up and warms the program, measures rounds
back to back for ``--seconds``, then checks what the timed path produced
against the plain reference (``bench/reference/``).  With ``--trace 0``
the result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from a profiled window.  The last line of
standard output is the result, one JSON object.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden
    (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def fail(msg: str, code: int):
    print(f"bench: {msg}", file=sys.stderr)
    sys.exit(code)


def load_cell(name: str):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        fail(f"no workload {name!r} in BENCHMARK.json", 2)
    cell = cells[name]
    config = json.loads((BENCH / "configs" /
                         f"{cell['config']}.json").read_text())
    workload = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    return spec, cell, config, workload


def cell_metrics(entries: list, cell: str, moves=None) -> list:
    """The metrics of ``entries`` that ``cell`` reports."""
    return [m for m in entries if cell in m.get("workloads", [cell])
            and (moves is None or m["moves"] in moves)]


def read_layer_metric(name: str, data):
    path = BENCH / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_layer_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(data)


def judge(readings: dict, limits: dict):
    """Each compared number beside its limit; correct when every number
    is at or under its limit."""
    missing = sorted(set(limits) - set(readings))
    if missing:
        fail(f"no reading for the limits {missing}", 5)
    checks = {k: [readings[k], limits[k]] for k in limits}
    ok = all(v <= lim for v, lim in checks.values())
    return ok, checks


def measure(name: str, seed: int, seconds: float, trace: bool, *, spec,
            cell, config, workload, device) -> dict:
    """Set up, warm, measure and check one run of cell ``name`` on
    ``device``; returns the result (the last line's object)."""
    import torch
    from bench.trace import Tracer, assemble, breakdown

    on_card = device.type == "cuda"
    if on_card:
        from repro_torch.kernels import cuda as kernels
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        built = kernels.build()
        print(f"bench: kernel build {max([s for s, _ in built.values()]):.3f}"
              " s", file=sys.stderr)
    tracer = Tracer(trace)
    driver = importlib.import_module(f"bench.drivers.{workload['driver']}")
    run = driver.make(config, workload, seed, device, tracer)
    run.setup()
    peak = 0
    if on_card:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - T_START
    print(f"bench: set-up {setup_s:.3f} s", file=sys.stderr)

    tracer.patch_kernels()
    tracer.start_profiler()
    times, failed = [], 0
    w0 = time.perf_counter()
    t = 0
    while True:
        r0 = time.perf_counter()
        tracer.begin_round(t)
        failed += not run.round()
        tracer.end_round()
        r1 = time.perf_counter()
        tracer.add_span("round", r0, r1)
        times.append(r1 - r0)
        t += 1
        if r1 - w0 >= seconds:
            break
    window_s = r1 - w0
    records = tracer.stop_profiler()
    tracer.unpatch()
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    peak = max(peak, window_peak)
    found = forbidden_modules()
    if found:
        fail(f"forbidden modules loaded: {found}", 4)

    e2e = dict(run.e2e(times, window_s), setup_s=setup_s,
               lm_peak_mem_gib=window_peak / 2 ** 30)
    device_info = {"platform": "gpu" if on_card else device.type,
                   "kind": torch.cuda.get_device_name(0) if on_card
                   else "cpu", "count": cell["chips"],
                   "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": len(times), "failed": failed}
    if trace:
        rounds = [s for s in tracer.spans if s.name == "round"]
        data = assemble(tracer, records, rounds, config, workload)
        if not data.records:
            fail("the traced window holds no device record", 6)
        moves = {m["name"] for m in cell_metrics(spec["end_to_end"], name)}
        metrics = {}
        for m in cell_metrics(spec["per_layer"], name, moves):
            value = read_layer_metric(m["name"], data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=data.busy_s(), window_s=data.window_s)
        result["breakdown"] = breakdown(data, run.host_spans)
        print(f"bench: profiler completeness {data.completeness}",
              file=sys.stderr)
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(spec["end_to_end"], name)}

    run.close_program()
    if on_card:
        torch.cuda.empty_cache()
    ok, checks = judge(run.readings(), workload["limits"])
    result.update(correct=ok, metrics=metrics, device=device_info,
                  checks=checks)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec, cell, config, workload = load_cell(args.workload)
    # every cache of the program stays inside the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    # one process with one host thread a pool: idle pool threads spin on
    # the shared host and spread the host-bound rounds
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("the program (src/repro_torch) is not in this checkout", 3)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        fail(f"{args.workload} needs {cell['chips']} CUDA device(s); "
             f"found {torch.cuda.device_count()}", 3)
    result = measure(args.workload, args.seed, args.seconds,
                     bool(args.trace), spec=spec, cell=cell, config=config,
                     workload=workload, device=torch.device("cuda"))
    found = forbidden_modules()
    if found:
        fail(f"forbidden modules loaded: {found}", 4)
    for name, (value, limit) in result["checks"].items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
