#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of CE-FL (``src/repro_torch``) on one NVIDIA
card and check it: the CE-FL rounds, the front door with the ``cefl``
strategy and the LM serving path.

    python3 chip_smoke.py            # from the repo root, on a machine with
                                     # one CUDA card, nvcc and nvidia-smi

Phases (any failure exits non-zero; nothing is caught and swallowed):

1. build   — compile every kernel of ``src/repro_torch/kernels/csrc`` for
             sm_90a, one nvcc per source, all started together.
2. path    — the main path at the paper's width: the 20-UE / 10-BS / 5-DC
             network, the 28x28x1 -> 200 -> 100 -> 10 classifier (random
             weights from a seed), a 48,000-image pool with N(2000, 200)
             arrivals per UE per round and 1,000 eval examples; 3 rounds
             of ``greedy_data`` and 2 rounds of ``fednova`` through the
             engine on ``device="cuda"``.  The launch counters are set to
             0 just before and read just after; every kernel of the path
             must have launched exactly as often as the rounds' DPU groups
             say, and the groups give the shapes of those launches.
             Losses must be finite, final accuracy above chance.
3. threat  — the adversarial path in the same world: ``byzantine`` (4 of
             20 UEs sign-flip their updates x4) under ``greedy_data`` with
             the trimmed mean (trim 0.2) for 3 rounds, under ``fedavg``
             with the median (robust FedAvg) for 2, and ``stragglers``
             (mobility, handover, dropout, 4x slower compute) under
             ``fednova`` with the median for 2.  Counters are set to 0
             just before and read just after; every round must launch
             ``robust_aggregate`` once, ``nova_aggregate`` never and
             ``fedprox_accum`` gamma times per DPU group.  Losses finite,
             final accuracies above chance.
3b. mesh   — the mesh round at paper width in the same world:
             ``Engine(..., executor=MeshExecutor())``, 3 rounds of
             ``greedy_data`` and 2 of ``fednova``.  Counters are set to 0
             just before and read just after; every round must launch
             ``fedprox_accum`` gamma_max times (per-DPU anchor, all live
             DPUs at once) and ``nova_aggregate_stacked`` once, and no
             other kernel.  Losses finite, final accuracies above chance;
             per round n, bucket, gamma_max, staged bytes, times and peak
             memory; a profiled mesh round.
3c. api    — the tree-level kernel ops on the paper classifier's tree,
             f32 and bf16 leaves: ``ops.fedprox_update`` and
             ``ops.nova_aggregate`` (absolute weights) launch one kernel
             each and agree with the plain per-leaf result.
6. serve   — (runs after 3c) the LM serving path at full width and
             depth: starcoder2-15b in bf16, random weights made on the card
             from a seed, through ``repro_torch.serve.serve``: 8 requests
             of 512-token prompts, then 2 of 4096 (a full rolling window),
             32 greedy tokens each, cache 4096.  Counters are set to 0
             just before each run and read just after; each must launch
             ``swa_decode_attention`` 40 x 31 = 1,240 times and no other
             kernel.  Logits finite, tokens in the vocab; prefill seconds,
             decode ms per step, tokens/s, peak memory, and a profiled
             decode step.  The weights are freed after it.
7. cefl    — (runs after 6) the front door, ``repro_torch.experiments.run``,
             with the ``cefl`` strategy: ``paper_table1`` at paper width
             (20/10/5 network, the (176, 1024) plane, constants estimated
             on the card, ``solver_outer=4``, ``reoptimize_every=3``) cut
             to 4 rounds and one seed (two SCA solves), then
             ``quickstart`` whole (8 rounds).  The SCA solve and the
             aggregator enumeration run on the card.  Counters are set to
             0 just before and read just after; every round must launch
             ``fedprox_accum`` gamma times per DPU group and
             ``nova_aggregate`` once, every plan must validate and the
             aggregation point be one of the S DCs.  Per round: plan
             seconds (SCA solve, ``select_aggregator``, the rest), outer
             and primal-dual iterations, device-round seconds; the
             estimation's seconds.  Then one paper-width SCA solve,
             centralized and distributed, card against CPU to
             ``tests/test_solver_diff.py``'s bar, and one profiled solve.
4. kernels — each hand-written kernel against its plain PyTorch version on
             the same card tensors, at every shape the paths launched it
             with and at extra cases, with the tolerance stated below
             (signed-zero stacks at n = 5, 25, 64 compared by sign;
             ``nova_aggregate`` and its stacked form at 12,289 and 20,000
             DPUs); then each is timed with CUDA events (median of 30
             launches, L2 flushed before each) beside its plain version,
             its bound and a one-call PyTorch yardstick where one exists;
             ``robust_aggregate``'s network and radix select are timed
             against each other at n = 33-100 (the crossover),
             and ``swa_decode_attention`` must show one kernel per call.
             The kernels line reports the largest group the paths
             launched.  Each kernel's main row is timed a second way, as
             a run of 200 launches between one event pair (``RunTimer``),
             beside an empty kernel under both timers.
5. check   — one fused round and one mesh round at paper width on the card
             against the same staged round on the CPU (plain versions),
             to the stated tolerance; starcoder2-15b at full width with 2
             layers in f32, prefill and 8 decode steps, card against CPU.

Its last lines: the card's ``name, power.limit`` as nvidia-smi prints
them, one JSON line with every kernel's numbers, and the result line
``{"ok": true, "device": {...}}``.  Longer output (the per-shape table,
the profile of one round) goes to ``chiprun_out/chip_smoke/``.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke"

# The H100 SXM's published peaks (NVIDIA data sheet): memory rate in B/s,
# float32 rate outside the tensor cores and dense bf16 tensor-core rate in
# FLOP/s, keyed on the name torch reports.  Other cards raise until a run
# on them adds their entry.
CARDS = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12, 989e12)}

REPLACES = {
    "fedprox_accum": ("src/repro_torch/kernels/csrc/fedprox_accum.cu",
                      "src/repro/kernels/fedprox_update.py:135"),
    "nova_aggregate": ("src/repro_torch/kernels/csrc/nova_aggregate.cu",
                       "src/repro/kernels/nova_aggregate.py:85"),
    "robust_aggregate": ("src/repro_torch/kernels/csrc/robust_aggregate.cu",
                         "src/repro/kernels/robust_aggregate.py:52"),
    "nova_aggregate_stacked": (
        "src/repro_torch/kernels/csrc/nova_aggregate.cu",
        "src/repro/kernels/nova_aggregate.py:156"),
    "fedprox_update": ("src/repro_torch/kernels/csrc/fedprox_update.cu",
                       "src/repro/kernels/fedprox_update.py:95"),
    "swa_decode_attention": (
        "src/repro_torch/kernels/csrc/swa_decode_attention.cu",
        "src/repro/kernels/swa_decode_attention.py:55"),
}

# The threat path: (scenario, strategy, robust mode, rounds).
THREAT_RUNS = [("byzantine", "greedy_data", "trimmed_mean", 3),
               ("byzantine", "fedavg", "median", 2),
               ("stragglers", "fednova", "median", 2)]
TRIM_FRAC = 0.2


def log(*args):
    print(*args, flush=True)


def card_rates(name: str):
    if name not in CARDS:
        raise RuntimeError(f"no published rates for card {name!r}")
    return CARDS[name]


def ptxas_summary(log_text: str):
    """(function, "N registers; stack / spill line") per function in
    nvcc's ``-Xptxas=-v`` output, kernels named by their template
    arguments (e.g. ``robust_aggregate_kernel<float, 32>``; a bool
    argument shows as 0 or 1)."""
    import re
    out, fn = [], None
    for ln in log_text.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
            t = re.search(r"([a-z_]+_kernel)I(\w+?)(?:L[ib](\d+)E)?E", fn)
            if t:
                dt = {"f": "float", "13__nv_bfloat16": "bf16"}.get(
                    t.group(2), t.group(2))
                fn = f"{t.group(1)}<{dt}" + (
                    f", {t.group(3)}>" if t.group(3) else ">")
            out.append([fn, ""])
        elif fn is not None and ("stack frame" in ln or "registers" in ln):
            out[-1][1] += ("; " if out[-1][1] else "") + \
                ln.replace("ptxas info    :", "").strip()
    return [tuple(x) for x in out]


def smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------- timing -----

class Timer:
    """Median device time of one call, by CUDA events around it.  Before
    each call the 50 MB L2 is flushed (a 256 MiB write) and the stream is
    held by a short device-side sleep, so the call is queued before the
    start event runs and the interval holds device work only."""

    def __init__(self, dev):
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)

    def __call__(self, fn, iters=30, warmup=3) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(1_000_000)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


L2_BYTES = 50 * 10**6


class RunTimer:
    """Device time per launch over a run of many launches between one event
    pair.  The launches rotate
    over copies of the inputs whose bytes together exceed twice the 50 MB
    L2, so each launch finds its inputs cold, as ``Timer``'s flush does;
    the stream is held by a device-side sleep while the host enqueues the
    run, so the interval holds back-to-back device work and no host time.
    Median over ``reps`` runs."""

    def __call__(self, fn, make_args, nbytes, launches=200, reps=3) -> float:
        copies = max(2, -(-2 * L2_BYTES // max(int(nbytes), 1)))
        args = [make_args() for _ in range(copies)]
        for a in args[:2]:
            fn(*a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(launches):
            fn(*args[i % copies])
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        # hold the stream for 1.5x the host's enqueue time plus 2 ms (at
        # up to 2 GHz; a slower clock holds longer)
        cycles = int((1.5 * host_s + 2e-3) * 2e9)
        per = []
        for _ in range(reps):
            torch.cuda._sleep(cycles)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for i in range(launches):
                fn(*args[i % copies])
            e.record()
            torch.cuda.synchronize()
            per.append(s.elapsed_time(e) / launches)
        del args
        return statistics.median(per)


def run_column(dev, main_rows, timer, run_timer):
    """The second time column of the kernels' main rows (``RunTimer``), at
    each row's shape on fresh random inputs, and the floor of both timers:
    an empty kernel (``torch.cuda._sleep(0)``) under each.  Returns
    {kernel: ms per launch} and the floors."""
    from repro_torch.kernels import fedprox_update as kfp
    from repro_torch.kernels import nova_aggregate as kna
    from repro_torch.kernels import robust_aggregate as kra
    from repro_torch.kernels import swa_decode_attention as kswa
    from repro_torch.kernels.plane import LANE

    gen = torch.Generator(device=dev).manual_seed(31)

    def randn(shape, dt=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    out = {}
    r = main_rows["fedprox_accum"]
    G, R = r["G"], r["R"]
    anc_shape = (R, LANE) if r["anchor"] == "shared" else (G, R, LANE)
    coef = torch.rand(G, generator=gen, device=dev) + 0.5
    act = torch.ones(G, device=dev)
    out["fedprox_accum"] = run_timer(
        lambda x, g, a, acc: kfp.fedprox_accum(x, g, a, acc, coef, act, 0.1,
                                               0.01),
        lambda: (randn((G, R, LANE)), randn((G, R, LANE)), randn(anc_shape),
                 randn((G, R, LANE))), r["bytes"])
    for name, fn in (("nova_aggregate", kna.nova_aggregate),
                     ("nova_aggregate_stacked", kna.nova_aggregate_stacked)):
        r = main_rows[name]
        n, R = r["G"], r["R"]
        w = torch.rand(n, generator=gen, device=dev) + 0.1
        w = w / w.sum()
        xs = (R, LANE) if name == "nova_aggregate" else (n, R, LANE)
        out[name] = run_timer(
            lambda x, d, fn=fn, w=w: fn(x, d, w, 0.2),
            lambda xs=xs, n=n, R=R: (randn(xs), randn((n, R, LANE))),
            r["bytes"])
    r = main_rows["robust_aggregate"]
    n, R, k, med = r["G"], r["R"], r["k"], r["mode"] == "median"
    te = -1.0 if r["form"] == "fedavg" else 0.2
    out["robust_aggregate"] = run_timer(
        lambda x, d: kra.robust_aggregate(x, d, te, k=k, median=med),
        lambda: (randn((R, LANE)), randn((n, R, LANE))), r["bytes"])
    r = main_rows["fedprox_update"]
    R = r["R"]
    out["fedprox_update"] = run_timer(
        lambda x, g, a: kfp.fedprox_update(x, g, a, 0.1, 0.01),
        lambda: tuple(randn((R, LANE)) for _ in range(3)), r["bytes"])
    r = main_rows["swa_decode_attention"]
    B, Hq, Hkv, D, S, cl = (r["B"], r["Hq"], r["Hkv"], r["D"], r["S"],
                            r["cache_len"])
    dt = getattr(torch, r["dtype"])
    out["swa_decode_attention"] = run_timer(
        lambda q, kc, vc: kswa.swa_decode_attention(q, kc, vc, cl),
        lambda: (randn((B, Hq, D), dt), randn((B, S, Hkv, D), dt),
                 randn((B, S, Hkv, D), dt)), r["bytes"])
    floor = {"empty_kernel_ms": timer(lambda: torch.cuda._sleep(0)),
             "empty_kernel_run_ms": run_timer(
                 lambda: torch.cuda._sleep(0), lambda: (), L2_BYTES * 2)}
    for name, ms in out.items():
        log(f"  {name:<23} per call {main_rows[name]['ms'] * 1e3:8.2f} us"
            f"   run of 200 {ms * 1e3:8.2f} us   bound "
            f"{main_rows[name]['bound_ms'] * 1e3:8.2f} us")
    log(f"  empty kernel: per call {floor['empty_kernel_ms'] * 1e3:.2f} us,"
        f" run of 200 {floor['empty_kernel_run_ms'] * 1e3:.2f} us")
    return out, floor


# -------------------------------------------------------- tolerance -----

def _spacing(t: torch.Tensor) -> float:
    return float(np.spacing(np.float32(float(t.float().abs().max()))))


def _bf16_ulp(a: torch.Tensor) -> torch.Tensor:
    _, e = torch.frexp(a.abs())
    return torch.ldexp(torch.ones_like(a), e - 8)


def within(got, want, atol) -> dict:
    """Max abs error, the bound applied and whether it held.  f32:
    |got - want| <= atol.  bf16: <= one bf16 ulp of the result or atol,
    whichever is larger, per element; ``tol`` is then the largest
    per-element bound and ``worst`` the largest error / bound."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if got.dtype == torch.bfloat16:
        bound = torch.clamp(_bf16_ulp(torch.maximum(g.abs(), w.abs())),
                            min=atol)
        rule = "1 bf16 ulp of the result"
    else:
        bound = torch.full_like(err, atol)
        rule = "abs"
    ratio = torch.where(err == 0, torch.zeros_like(err), err / bound)
    return {"max_abs_err": float(err.max()), "tol": float(bound.max()),
            "tol_rule": rule, "worst": float(ratio.max()),
            "ok": bool(torch.all(err <= bound))}


def _both(a, b) -> dict:
    """The check of two outputs as one."""
    return {"max_abs_err": max(a["max_abs_err"], b["max_abs_err"]),
            "tol": max(a["tol"], b["tol"]), "tol_rule": a["tol_rule"],
            "worst": max(a["worst"], b["worst"]), "ok": a["ok"] and b["ok"]}


# ---------------------------------------------------- phase 4: kernels --

def kernel_checks(dev, timer, bw, f32_rate, path_shapes):
    """Every kernel against its plain version: at each shape the paths
    launched it with (``path_shapes``: kernel -> {(G or n, R): launches},
    for fedprox_accum {(G, R, anchor form): launches}; f32, as the paths
    run) and at the extra cases below.
    Every R = 176 case is timed.  Returns the per-case rows and, per
    kernel, the row of the largest group the path launched."""
    from repro_torch.kernels import fedprox_update as kfp
    from repro_torch.kernels import nova_aggregate as kna
    from repro_torch.kernels import ref
    from repro_torch.kernels.plane import LANE

    gen = torch.Generator(device=dev).manual_seed(1234)
    rows, main = [], {}
    f32 = torch.float32

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # fedprox_accum: the path's (G, R), then G in {5, 20, 25} at R = 176
    # (the paper classifier's plane), both anchor forms, f32 and bf16,
    # plus the edge rows 24, 40.  Tolerance: two f32 ulps of the largest
    # operand, because nvcc contracts the kernel's multiply-adds into FMAs
    # where the plain version rounds each op (one bf16 ulp of the result
    # for bf16).
    path = path_shapes["fedprox_accum"]
    cases = [(G, R, f32, anc, n) for (G, R, anc), n in sorted(path.items())]
    cases += [(G, 176, dt, anc, 0) for G in (5, 20, 25)
              for dt in (f32, torch.bfloat16)
              for anc in ("shared", "per_dpu")]
    cases += [(5, R, dt, anc, 0) for R in (24, 40)
              for dt in (f32, torch.bfloat16)
              for anc in ("shared", "per_dpu")]
    G_main = max(G for G, R, _ in path if R == 176)
    for G, R, dt, anc, on_path in cases:
        x, g, acc = (randn((G, R, LANE), dt) for _ in range(3))
        anchor = randn((R, LANE) if anc == "shared" else (G, R, LANE), dt)
        coef = torch.rand(G, generator=gen, device=dev) + 0.5
        active = (torch.rand(G, generator=gen, device=dev) > 0.2).float()
        eta, mu = 0.1, 0.01
        kx, kacc = kfp.fedprox_accum(x, g, anchor, acc, coef, active, eta,
                                     mu)
        rx, racc = ref.fedprox_accum_ref(x, g, anchor, acc, coef, active,
                                         eta, mu)
        torch.cuda.synchronize()
        atol = 2 * max(_spacing(x), _spacing(g), _spacing(anchor),
                       _spacing(acc))
        esize = x.element_size()
        planes = 6 * G if anc == "per_dpu" else 5 * G + 1
        nbytes = esize * R * LANE * planes
        flops = 7 * G * R * LANE
        row = {"kernel": "fedprox_accum", "G": G, "R": R,
               "dtype": str(dt).replace("torch.", ""), "anchor": anc,
               "path_launches": on_path, "bytes": nbytes,
               **_both(within(kx, rx, atol), within(kacc, racc, atol))}
        if R == 176:
            args = (x, g, anchor, acc, coef, active, eta, mu)
            row["ms"] = timer(lambda: kfp.fedprox_accum(*args))
            row["plain_ms"] = timer(lambda: ref.fedprox_accum_ref(*args))
            row["library_ms"] = None
            row["bound_ms"] = max(nbytes / bw, flops / f32_rate) * 1e3
            row["bound_by"] = "bytes" if nbytes / bw >= flops / f32_rate \
                else "operations"
        if on_path and G == G_main and R == 176:
            main["fedprox_accum"] = row
        rows.append(row)
        log(f"  {_fmt(row)}")

    # nova_aggregate: the path's (n, R), then n in {5, 25} DPUs at R = 176,
    # f32 and bf16, plus the edge rows, and n = 12,289 and 20,000 at R = 8
    # (0.4 and 0.65 GB of d).  Tolerance: two f32 ulps of the
    # largest x plus theta*eta * n ulps of the largest d (the kernel sums
    # the n terms in order with FMAs, the plain einsum in cuBLAS's order).
    path = path_shapes["nova_aggregate"]
    cases = [(n, R, f32, c) for (n, R), c in sorted(path.items())]
    cases += [(n, 176, dt, 0) for n in (5, 25)
              for dt in (f32, torch.bfloat16)]
    cases += [(5, R, dt, 0) for R in (24, 40)
              for dt in (f32, torch.bfloat16)]
    n_main = max(n for n, R in path if R == 176)
    # past 12,288 DPUs, the count whose weights once filled the kernel's
    # shared memory: the weights now pass through it in chunks
    cases += [(n, 8, f32, 0) for n in (12289, 20000)]
    for n, R, dt, on_path in cases:
        x = randn((R, LANE), dt)
        d = randn((n, R, LANE), dt)
        w = torch.rand(n, generator=gen, device=dev) + 0.1
        w = w / w.sum()
        theta_eta = 0.2
        k = kna.nova_aggregate(x, d, w, theta_eta)
        r = ref.nova_aggregate_ref(x, d, w, theta_eta)
        torch.cuda.synchronize()
        atol = 2 * _spacing(x) + theta_eta * n * _spacing(d)
        esize = x.element_size()
        nbytes = esize * R * LANE * (n + 2)
        flops = 2 * (n + 1) * R * LANE
        row = {"kernel": "nova_aggregate", "G": n, "R": R,
               "dtype": str(dt).replace("torch.", ""), "anchor": "-",
               "path_launches": on_path, "bytes": nbytes,
               **within(k, r, atol)}
        if R == 176:
            row["ms"] = timer(lambda: kna.nova_aggregate(x, d, w,
                                                         theta_eta))
            row["plain_ms"] = timer(lambda: ref.nova_aggregate_ref(
                x, d, w, theta_eta))
            # the one-call yardstick: x - theta_eta * (w @ d) as addmm
            row["library_ms"] = timer(lambda: torch.addmm(
                x.view(1, -1), w.to(dt).view(1, n), d.view(n, -1),
                alpha=-theta_eta))
            row["bound_ms"] = max(nbytes / bw, flops / f32_rate) * 1e3
            row["bound_by"] = "bytes" if nbytes / bw >= flops / f32_rate \
                else "operations"
        if on_path and n == n_main and R == 176:
            main["nova_aggregate"] = row
        rows.append(row)
        log(f"  {_fmt(row)}")
        del d
    return rows, main


def stacked_checks(dev, timer, bw, f32_rate, path):
    """``nova_aggregate_stacked`` against its plain version at every (n, R)
    the mesh path launched it with (``path``: {(n, R): launches}, f32,
    rows of x that differ), and at n in {1, 5, 64} for R = 176 and n = 5
    for the edge rows 24 and 40, f32 and bf16, and n = 12,289 and 20,000
    at R = 8 (past the old cap).  Tolerance, as for
    ``nova_aggregate``: two f32 ulps of the largest |x| plus theta_eta * n
    ulps of the largest |d|.  Each case also says whether row j equals
    ``nova_aggregate`` (the one-plane kernel) on x[j] bit for bit; those
    comparison launches come after the counted paths.  Every R = 176 case
    is timed, beside the yardstick ``addmm(x, M, d)`` with M = -theta_eta
    * 1 w^T built before the timing."""
    from repro_torch.kernels import nova_aggregate as kna
    from repro_torch.kernels import ref
    from repro_torch.kernels.plane import LANE

    gen = torch.Generator(device=dev).manual_seed(2468)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(n, R, f32, c) for (n, R), c in sorted(path.items())]
    cases += [(n, 176, dt, 0) for n in (1, 5, 64) for dt in (f32, bf16)]
    cases += [(5, R, dt, 0) for R in (24, 40) for dt in (f32, bf16)]
    cases += [(n, 8, f32, 0) for n in (12289, 20000)]   # past the old cap
    n_main = max(n for n, _ in path)
    rows, main = [], None
    for n, R, dt, on_path in cases:
        x = torch.randn((n, R, LANE), generator=gen, device=dev).to(dt)
        d = torch.randn((n, R, LANE), generator=gen, device=dev).to(dt)
        w = torch.rand(n, generator=gen, device=dev) + 0.1
        w = w / w.sum()
        theta_eta = 0.1
        k = kna.nova_aggregate_stacked(x, d, w, theta_eta)
        r = ref.nova_aggregate_ref(x, d, w, theta_eta)
        # row j against the one-plane kernel on x[j] (a sample of rows
        # past the old cap)
        js = range(n) if n <= 64 else (0, n // 2, n - 1)
        one = torch.stack([kna.nova_aggregate(x[j], d, w, theta_eta)
                           for j in js])
        torch.cuda.synchronize()
        atol = 2 * _spacing(x) + theta_eta * n * _spacing(d)
        nbytes = x.element_size() * R * LANE * 3 * n
        flops = 4 * n * R * LANE
        row = {"kernel": "nova_aggregate_stacked", "G": n, "R": R,
               "dtype": str(dt).replace("torch.", ""), "anchor": "-",
               "path_launches": on_path, "bytes": nbytes,
               "rows_equal_nova_aggregate": bool(torch.equal(
                   k[list(js)], one)),
               **within(k, r, atol)}
        if R == 176:
            M = (-theta_eta * torch.outer(torch.ones(n, device=dev), w)
                 ).to(dt)
            row["ms"] = timer(lambda: kna.nova_aggregate_stacked(
                x, d, w, theta_eta))
            row["plain_ms"] = timer(lambda: ref.nova_aggregate_ref(
                x, d, w, theta_eta))
            row["library_ms"] = timer(lambda: torch.addmm(
                x.view(n, -1), M, d.view(n, -1)))
            row["bound_ms"] = max(nbytes / bw, flops / f32_rate) * 1e3
            row["bound_by"] = "bytes" if nbytes / bw >= flops / f32_rate \
                else "operations"
        if on_path and n == n_main:
            main = row
        rows.append(row)
        log(f"  {_fmt(row)}  rows == nova_aggregate: "
            f"{row['rows_equal_nova_aggregate']}")
    return rows, main


def update_checks(dev, timer, bw, f32_rate, path):
    """``fedprox_update`` against its plain version at R in {176, 24, 40},
    f32 and bf16 (``path``: {(R, dtype): launches} of the api phase).
    Tolerance: two f32 ulps of the largest operand (nvcc contracts the
    multiply-adds into FMAs where the plain version rounds each op), one
    bf16 ulp of the result for bf16.  R = 176 is timed; no single PyTorch
    call computes the update, so there is no yardstick."""
    from repro_torch.kernels import fedprox_update as kfp
    from repro_torch.kernels import ref
    from repro_torch.kernels.plane import LANE

    gen = torch.Generator(device=dev).manual_seed(1357)
    rows, main = [], None
    for R in (176, 24, 40):
        for dt in (torch.float32, torch.bfloat16):
            x, g, a = (torch.randn((R, LANE), generator=gen,
                                   device=dev).to(dt) for _ in range(3))
            eta, mu = 0.1, 0.01
            k = kfp.fedprox_update(x, g, a, eta, mu)
            r = ref.fedprox_update_ref(x, g, a, eta, mu)
            torch.cuda.synchronize()
            atol = 2 * max(_spacing(x), _spacing(g), _spacing(a))
            nbytes = x.element_size() * R * LANE * 4
            flops = 5 * R * LANE
            row = {"kernel": "fedprox_update", "G": 1, "R": R,
                   "dtype": str(dt).replace("torch.", ""), "anchor": "-",
                   "path_launches": path.get((R, str(dt)), 0),
                   "bytes": nbytes, **within(k, r, atol)}
            if R == 176:
                row["ms"] = timer(lambda: kfp.fedprox_update(x, g, a, eta,
                                                             mu))
                row["plain_ms"] = timer(lambda: ref.fedprox_update_ref(
                    x, g, a, eta, mu))
                row["library_ms"] = None
                row["bound_ms"] = max(nbytes / bw, flops / f32_rate) * 1e3
                row["bound_by"] = "bytes" if nbytes / bw >= \
                    flops / f32_rate else "operations"
                if dt == torch.float32:
                    main = row
            rows.append(row)
            log(f"  {_fmt(row)}")
    return rows, main


def network_pairs(nmax: int):
    """The compare-exchanges (i, j) of Batcher's odd-even merge sort of
    ``nmax`` values, in the order ``csrc/robust_sort.cuh`` runs them."""
    out = []

    def merge(lo, n, r):
        m = 2 * r
        if m < n:
            merge(lo, n, m)
            merge(lo + r, n, m)
            out.extend((i, i + r) for i in range(lo + r, lo + n - r, m))
        else:
            out.append((lo, lo + r))

    def sort(lo, n):
        if n > 1:
            sort(lo, n // 2)
            sort(lo + n // 2, n // 2)
            merge(lo, n, 1)

    sort(0, nmax)
    return out


def robust_operations(n: int, m: int, R: int, network_max: int = 64) -> int:
    """Operations the robust reduce needs for n values per coordinate, m
    of them averaged, plus a multiply and a subtract for the update.  Up
    to ``network_max`` DPUs (the register network): two (a min and a max)
    per compare-exchange of the network on n values (the NMAX network
    without the exchanges that touch only padding, which never move), m -
    1 adds and one divide.  Above (the radix select): one key per value
    and one comparison per value against the boundaries, m - 1 adds and
    one divide."""
    if n > network_max:
        return R * 1024 * (2 * n + m + 2)
    nmax = 1 << max(n - 1, 0).bit_length()
    ces = sum(1 for _, j in network_pairs(nmax) if j < n)
    return R * 1024 * (2 * ces + m + 2)


def _within_nonfinite(got, want, atol) -> dict:
    """``within`` for outputs with NaN / +-inf: those must sit at the same
    places with the same values; the finite rest is held to ``within``."""
    g, w = got.float(), want.float()
    same = bool(torch.equal(torch.isnan(g), torch.isnan(w))
                and torch.equal(g[torch.isinf(w)], w[torch.isinf(w)]))
    fin = torch.isfinite(w)
    res = within(got[fin], want[fin], atol)
    res["ok"] = res["ok"] and same
    return res


def robust_checks(dev, timer, bw, f32_rate, path_shapes):
    """``robust_aggregate`` against its plain version at every
    (n, R, mode, k, form) the threat path launched it with, and at the
    extra cases: n in {1, 2, 3, 5, 20, 25, 32, 33, 64} (the register
    network) and {65, 100, 128, 257, 1000, 1001} (the radix select), the
    median and the trimmed mean at k in {0, trim_count(n, 0.2),
    (n-1)//2}, R in {24, 40, 176} (1001: 176), f32 and bf16, n = 2000 at
    R = 8, and n = 4000 at R = 8 (keys past shared memory, re-read from
    device memory); a tie-heavy stack (timed at n = 1000), NaN and +-inf
    entries, the robust-FedAvg form x = 0, theta_eta = -1, and at n = 5,
    25, 64 (the network; median and trimmed mean, both forms, f32 and
    bf16) and 65, 1000 (the select) stacks of -0 and +0 with x = -0 (a
    zero result keeps the sign of the stable order's zero, which must
    match: compared by ``torch.signbit`` where the value is zero).  Tolerance: the
    median is bitwise equal (the same sorted values, one add and a halving for
    even n, and an unfused multiply and subtract in both); the trimmed mean
    within two f32 ulps of the largest |x| plus |theta_eta| * 2m ulps of the
    largest |d| (m = n - 2k values summed, in sorted order by the network and
    in DPU order by the radix select, and in torch's order in the plain
    version, which on the card also multiplies by 1/m where the kernel
    divides).  bf16: one bf16 ulp of the result or that bound."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import robust_aggregate as kra
    from repro_torch.kernels.plane import LANE

    gen = torch.Generator(device=dev).manual_seed(4321)
    f32, bf16 = torch.float32, torch.bfloat16
    rows, main = [], None

    def case(n, R, dt, mode, k, form, on_path, special=None, timed=False):
        median = mode == "median"
        m = (1 if n % 2 else 2) if median else n - 2 * k
        d = torch.randn((n, R, LANE), generator=gen, device=dev)
        if special == "ties":
            base = d[0].clone()
            for i in range(n):
                d[i] = (base, -4 * base, torch.zeros_like(base))[i % 3]
        elif special == "signed_zeros":
            # four DPUs in five send -0 or +0 (a coin per element), the
            # fifth a value: a zero median is the stable order's zero
            for i in range(n):
                if i % 5:
                    d[i] = torch.where(torch.rand(
                        (R, LANE), generator=gen, device=dev) < 0.5,
                        -0.0, 0.0)
        elif special == "nonfinite":
            d[0, :, :256] = float("nan")
            d[1 % n, :, 128:384] = float("inf")
            d[2 % n, :, 300:500] = float("-inf")
        d = d.to(dt)
        if special == "signed_zeros":
            # x = -0: -0 - 0.2 * (+-0) and -0 - (-1) * (+-0) both show
            # the reduce's zero sign (x = +0 would make every zero +0)
            x = torch.full((R, LANE), -0.0, dtype=dt, device=dev)
            theta_eta = -1.0 if form == "fedavg" else 0.2
        elif form == "fedavg":
            x, theta_eta = torch.zeros((R, LANE), dtype=dt, device=dev), -1.0
        else:
            x = torch.randn((R, LANE), generator=gen, device=dev).to(dt)
            theta_eta = 0.2
        got = kra.robust_aggregate(x, d, theta_eta, k=k, median=median)
        want = ref.robust_aggregate_ref(x, d, theta_eta, k=k, median=median)
        torch.cuda.synchronize()
        dfin = d.float().abs()
        dfin = dfin[torch.isfinite(dfin)]
        dmax = float(dfin.max()) if dfin.numel() else 0.0
        atol = 0.0 if median else (
            2 * _spacing(x) + abs(theta_eta) * 2 * m
            * float(np.spacing(np.float32(dmax))))
        check = (_within_nonfinite(got, want, atol) if special == "nonfinite"
                 else within(got, want, atol))
        if median and dt == f32:
            check["tol_rule"] = "bitwise"
        if special == "signed_zeros":   # a zero result keeps its sign
            zero = want.float() == 0
            check["ok"] = check["ok"] and bool(
                torch.all(got.float()[zero] == 0)) and torch.equal(
                torch.signbit(got.float()[zero]), torch.signbit(
                    want.float()[zero]))
            check["tol_rule"] += ", zeros' signs equal"
        esize = x.element_size()
        nbytes = esize * R * LANE * (n + 2)
        flops = robust_operations(n, m, R, kra.NETWORK_MAX)
        row = {"kernel": "robust_aggregate", "G": n, "R": R,
               "dtype": str(dt).replace("torch.", ""),
               "anchor": f"{'med' if median else 'tm'} k={k}"
                         + ("" if form == "eq11" else " fedavg")
                         + ("" if special is None else f" {special}"),
               "mode": mode, "k": k, "form": form,
               "path_launches": on_path, "bytes": nbytes, **check}
        if timed:
            row["ms"] = timer(lambda: kra.robust_aggregate(
                x, d, theta_eta, k=k, median=median))
            row["plain_ms"] = timer(lambda: ref.robust_aggregate_ref(
                x, d, theta_eta, k=k, median=median))
            row["sort_only_ms"] = timer(lambda: torch.sort(d, dim=0))
            # one call computes the reduce only for the median at odd n
            # (torch.median takes the lower middle value at even n)
            row["library_ms"] = (timer(lambda: torch.median(d, dim=0))
                                 if median and n % 2 else None)
            row["bound_ms"] = max(nbytes / bw, flops / f32_rate) * 1e3
            row["bound_by"] = "bytes" if nbytes / bw >= flops / f32_rate \
                else "operations"
        rows.append(row)
        return row

    n_main = max(key[0] for key in path_shapes)
    for (n, R, mode, k, form), c in sorted(path_shapes.items()):
        row = case(n, R, f32, mode, k, form, c, timed=(R == 176))
        log(f"  {_fmt(row)}")
        if n == n_main and (main is None or row["ms"] > main["ms"]):
            main = row
    extra = 0
    for n in (1, 2, 3, 5, 20, 25, 32, 33, 64):
        modes = [("median", 0)] + [
            ("trimmed_mean", k) for k in
            sorted({0, ops.trim_count(n, 0.2), (n - 1) // 2})]
        for mode, k in modes:
            for R in (24, 40, 176):
                for dt in (f32, bf16):
                    timed = (R == 176 and dt == f32 and n in (25, 64)
                             and k in (0, ops.trim_count(n, 0.2)))
                    row = case(n, R, dt, mode, k, "eq11", 0, timed=timed)
                    extra += 1
                    if timed or not row["ok"]:
                        log(f"  {_fmt(row)}")
    # signed zeros at the register network's sizes: a zero result must
    # carry the stable order's sign (the network is not stable; the
    # reduce picks each target's zero in DPU order)
    for n in (5, 25, 64):
        for dt in (f32, bf16):
            for mode, k in (("median", 0),
                            ("trimmed_mean", ops.trim_count(n, 0.2))):
                for form in ("eq11", "fedavg"):
                    row = case(n, 40, dt, mode, k, form, 0,
                               special="signed_zeros")
                    extra += 1
                    log(f"  {_fmt(row)}")
    for n in (5, 20, 25):
        for dt in (f32, bf16):
            for mode, k in (("median", 0),
                            ("trimmed_mean", ops.trim_count(n, 0.2))):
                for special, form in (("ties", "eq11"), ("nonfinite", "eq11"),
                                      (None, "fedavg"), ("ties", "fedavg")):
                    row = case(n, 40, dt, mode, k, form, 0, special=special)
                    extra += 1
                    if not row["ok"]:
                        log(f"  {_fmt(row)}")
    # above the network the kernel selects instead of sorting: the same
    # checks, n = 1001 beside torch.median, and n = 4000 at R = 8, whose
    # keys outgrow shared memory (the path that re-reads device memory)
    big = len(rows)
    for n, Rs in ((65, (24, 40, 176)), (100, (24, 40, 176)),
                  (128, (24, 40, 176)), (257, (24, 40, 176)),
                  (1000, (24, 40, 176)), (1001, (176,)), (2000, (8,)),
                  (4000, (8,))):
        kt = ops.trim_count(n, 0.2)
        modes = [("median", 0)] + [("trimmed_mean", k) for k in
                                   sorted({0, kt, (n - 1) // 2})]
        for mode, k in modes:
            for R in Rs:
                for dt in (f32, bf16):
                    timed = R == 176 and dt == f32 and (
                        mode == "median" or k == kt)
                    row = case(n, R, dt, mode, k, "eq11", 0, timed=timed)
                    extra += 1
                    if timed or not row["ok"]:
                        log(f"  {_fmt(row)}")
        if n in (65, 257, 1000, 2000, 4000):
            for dt in (f32, bf16):
                for mode, k in (("median", 0), ("trimmed_mean", kt)):
                    for special, form in (("ties", "eq11"),
                                          ("nonfinite", "eq11"),
                                          (None, "fedavg"),
                                          ("ties", "fedavg")):
                        row = case(n, 8 if n >= 2000 else 40, dt, mode, k,
                                   form, 0, special=special)
                        extra += 1
                        if not row["ok"]:
                            log(f"  {_fmt(row)}")
                    if n in (65, 1000):
                        row = case(n, 40, dt, mode, k, "eq11", 0,
                                   special="signed_zeros")
                        extra += 1
                        log(f"  {_fmt(row)}")
        if n == 1000:   # every third DPU equal, timed: one bin takes most
            for mode, k in (("median", 0), ("trimmed_mean", kt)):
                row = case(n, 176, f32, mode, k, "eq11", 0,
                           special="ties", timed=True)
                extra += 1
                log(f"  {_fmt(row)}")
    ranked = rows[big:]
    exact = all(r["max_abs_err"] == 0 for r in ranked
                if r["mode"] == "median" and r["dtype"] == "float32")
    log(f"  robust_aggregate, n > {kra.NETWORK_MAX} (radix select): "
        f"{len(ranked)} cases, "
        f"{sum(1 for r in ranked if not r['ok'])} outside tolerance; f32 "
        f"medians bitwise: {exact}")
    worst = max(r["worst"] for r in rows if r["mode"] == "trimmed_mean")
    bitwise = all(r["max_abs_err"] == 0 for r in rows
                  if r["mode"] == "median" and r["dtype"] == "float32")
    log(f"  robust_aggregate: {extra} extra cases (ties, NaN/+-inf, x = 0 "
        f"and theta_eta = -1 among them), "
        f"{sum(1 for r in rows if not r['ok'])} outside tolerance; f32 "
        f"medians bitwise: {bitwise}; worst trimmed-mean err/tol "
        f"{worst:.2f}")
    return rows, main


CROSSOVER_N = (33, 48, 64, 65, 100)


def robust_crossover(dev, timer):
    """Where the register network should hand over to the radix select:
    f32 medians at R = 176 timed through both (the network only up to 64
    DPUs), beside the threshold the wrapper uses (``NETWORK_MAX``).
    Returns {n: {"network_ms", "select_ms"}} and the largest n at which
    the network was faster."""
    from repro_torch.kernels import robust_aggregate as kra
    from repro_torch.kernels.plane import LANE

    gen = torch.Generator(device=dev).manual_seed(55)
    out, faster = {}, 0
    for n in CROSSOVER_N:
        d = torch.randn((n, 176, LANE), generator=gen, device=dev)
        x = torch.randn((176, LANE), generator=gen, device=dev)
        rec = {"select_ms": timer(lambda: kra._launch(
            x, d, 0.2, 0, True, 0))}
        if n <= max(kra.NMAX):
            rec["network_ms"] = timer(lambda: kra._launch(
                x, d, 0.2, 0, True, max(kra.NMAX)))
            if rec["network_ms"] < rec["select_ms"]:
                faster = n
        out[n] = rec
        log(f"  crossover n={n}: select {rec['select_ms']:.4f} ms"
            + (f", network {rec['network_ms']:.4f} ms"
               if "network_ms" in rec else ""))
    log(f"  the network is faster up to n = {faster} of {CROSSOVER_N}; the "
        f"wrapper hands over above NETWORK_MAX = {kra.NETWORK_MAX}")
    return out, faster


def _fmt(row):
    tol = (f"tol {row['tol']:.3e}" if row["tol_rule"] == "abs" else
           f"tol {row['tol_rule']}, <= {row['tol']:.3e}")
    where = (f"path x{row['path_launches']}" if row["path_launches"]
             else "extra")
    s = (f"{row['kernel']:<15} G/n={row['G']:<3} R={row['R']:<4} "
         f"{row['dtype']:<9} {row['anchor']:<8} {where:<9} "
         f"err={row['max_abs_err']:.3e} ({tol}; worst err/tol "
         f"{row['worst']:.2f}) {'ok' if row['ok'] else 'MISMATCH'}")
    if "ms" in row:
        lib = "-" if row["library_ms"] is None else f"{row['library_ms']:.4f}"
        s += (f"  kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms"
              f"  library {lib} ms  bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})")
    return s


# ------------------------------------------------------- phase 2: path --

def paper_world(dev):
    """The paper-width world (App. G / Table III sizes), from seeds."""
    from repro_torch.configs.cefl_paper import ClassifierConfig
    from repro_torch.core.convergence import MLConstants
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.models.classifier import init_classifier_params
    from repro_torch.network.topology import NetworkConfig, make_network

    net = make_network(NetworkConfig(num_ue=20, num_bs=10, num_dc=5,
                                     seed=0))
    pool = make_image_dataset(48000, (28, 28, 1), seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    p0 = init_classifier_params(gen, ClassifierConfig(), device=dev)
    consts = MLConstants(L=5.0, theta_i=np.full(25, 2.0),
                         sigma_i=np.full(25, 3.0))
    return net, pool, p0, consts


def drive_path(dev, world):
    """3 rounds of greedy_data and 2 of fednova on the card, counting
    launches.  Returns the launch counts, the shapes each kernel was
    launched at (kernel -> {(G or n, R): launches}, from the rounds' DPU
    groups), the per-round records and the engines."""
    from repro_torch.core.api import EngineOptions
    from repro_torch.core.engine import Engine, dpu_groups, live_dpus
    from repro_torch.data.synthetic import make_online_ues
    from repro_torch.kernels import ops
    from repro_torch.kernels.plane import as_plane
    from repro_torch.models.classifier import (classifier_accuracy,
                                               classifier_loss)
    from repro_torch.solver.objective import ObjectiveWeights

    net, ((trx, try_), (tex, tey)), p0, consts = world
    R = as_plane(p0).data.shape[0]
    ex = torch.from_numpy(tex[:1000]).to(dev)
    ey = torch.from_numpy(tey[:1000]).to(dev)

    def eval_fn(p):
        return classifier_accuracy(p, ex, ey)

    runs = [("greedy_data", 3), ("fednova", 2)]
    engines = []
    for strategy, rounds in runs:
        ues = make_online_ues(trx, try_, num_ue=20, mean_arrivals=2000.0,
                              std_arrivals=200.0, seed=0)
        eng = Engine(net, strategy, consts=consts,
                     ow=ObjectiveWeights(xi1=1.0, xi2=1e-2, xi3=2.0,
                                         T=rounds),
                     opts=EngineOptions(rounds=rounds, eta=0.1, seed=0),
                     device=dev)
        state = eng.init_loop(ues, init_params=p0, loss_fn=classifier_loss,
                              eval_fn=eval_fn)
        engines.append((strategy, eng, state, ues))
    torch.cuda.synchronize()

    shapes = {"fedprox_accum": Counter(), "nova_aggregate": Counter()}
    records = []
    ops.reset_launches()                       # counts to 0: the path
    for strategy, eng, state, ues in engines:
        while state.t < eng.opts.rounds:
            t0 = time.perf_counter()
            staged = eng.begin_round(state, ues)
            t1 = time.perf_counter()
            live = live_dpus(staged.datasets)
            groups = dpu_groups(staged.plan, live)
            for (gamma, _m, _bucket), idxs in groups.items():
                shapes["fedprox_accum"][(len(idxs), R, "shared")] += gamma
            if eng.aggregation != "fedavg":
                shapes["nova_aggregate"][(len(live), R)] += 1
            mean_loss, acc = eng.execute_round(state, staged)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            rep = eng.finish_round(state, staged, mean_loss, acc)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            rec = {"strategy": strategy, "round": rep.round,
                   "wall_s": t3 - t0, "host_plan_s": t1 - t0,
                   "device_round_s": t2 - t1, "account_s": t3 - t2,
                   "loss": rep.loss, "acc": rep.acc,
                   "aggregator": rep.aggregator, "energy_J": rep.energy,
                   "delay_s": rep.delay, "dc_points": rep.dc_points,
                   "examples": int(sum(len(d["y"]) for d in staged.datasets
                                       if d is not None)),
                   "groups": [len(v) for v in groups.values()],
                   "fused": len(groups) == 1}
            records.append(rec)
            log(f"  {strategy:<11} round {rep.round}: wall "
                f"{rec['wall_s']:.3f} s (plan {rec['host_plan_s']:.3f}, "
                f"device round {rec['device_round_s']:.3f}, account "
                f"{rec['account_s']:.3f})  loss {rep.loss:.4f}  acc "
                f"{rep.acc:.3f}  aggregator DC{rep.aggregator}  energy "
                f"{rep.energy:.2f} J  delay {rep.delay:.3f} s  groups "
                f"{rec['groups']}  examples {rec['examples']}")
    launches = dict(ops.LAUNCHES)              # read just after
    expected = dict.fromkeys(launches, 0)
    expected.update({k: sum(c.values()) for k, c in shapes.items()})
    log(f"  launches {launches}  expected {expected}")
    for name, c in shapes.items():
        log(f"  {name} launch shapes (G or n, R): launches: {dict(c)}")
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != {expected}")
    for name in shapes:
        if launches[name] == 0:
            raise AssertionError(f"kernel {name} never launched on the path")
    if not all(np.isfinite(r["loss"]) for r in records):
        raise AssertionError("a round's loss is not finite")
    for strategy, _, state, _ in engines:
        acc = state.reports[-1].acc
        if not acc > 0.1:
            raise AssertionError(f"{strategy}: final accuracy {acc} is not "
                                 "above chance (0.1)")
    return launches, shapes, records, engines


# ----------------------------------------------------- phase 3: threat --

def drive_threat_path(dev, world):
    """The ``THREAT_RUNS`` on the card, counting launches per round.
    Returns the launch counts, the robust launch shapes ((n, R, mode, k,
    form) -> launches, from each round's live DPUs; form "fedavg" is the
    x = 0, theta_eta = -1 call of robust FedAvg), the fedprox_accum
    shapes, the per-round records and the engines."""
    from repro_torch.core.api import EngineOptions
    from repro_torch.core.engine import Engine, dpu_groups, live_dpus
    from repro_torch.data.synthetic import make_online_ues
    from repro_torch.kernels import ops
    from repro_torch.kernels.plane import as_plane
    from repro_torch.models.classifier import (classifier_accuracy,
                                               classifier_loss)
    from repro_torch.solver.objective import ObjectiveWeights

    net, ((trx, try_), (tex, tey)), p0, consts = world
    R = as_plane(p0).data.shape[0]
    ex = torch.from_numpy(tex[:1000]).to(dev)
    ey = torch.from_numpy(tey[:1000]).to(dev)

    def eval_fn(p):
        return classifier_accuracy(p, ex, ey)

    engines = []
    for scenario, strategy, mode, rounds in THREAT_RUNS:
        ues = make_online_ues(trx, try_, num_ue=20, mean_arrivals=2000.0,
                              std_arrivals=200.0, seed=0)
        eng = Engine(net, strategy, consts=consts,
                     ow=ObjectiveWeights(xi1=1.0, xi2=1e-2, xi3=2.0,
                                         T=rounds),
                     opts=EngineOptions(rounds=rounds, eta=0.1, seed=0,
                                        robust_agg=mode,
                                        trim_frac=TRIM_FRAC),
                     scenario=scenario, device=dev)
        state = eng.init_loop(ues, init_params=p0, loss_fn=classifier_loss,
                              eval_fn=eval_fn)
        engines.append((scenario, strategy, mode, eng, state, ues))
    torch.cuda.synchronize()

    shapes = {"fedprox_accum": Counter(), "robust_aggregate": Counter()}
    records = []
    ops.reset_launches()                       # counts to 0: the path
    for scenario, strategy, mode, eng, state, ues in engines:
        while state.t < eng.opts.rounds:
            before = dict(ops.LAUNCHES)
            t0 = time.perf_counter()
            staged = eng.begin_round(state, ues)
            t1 = time.perf_counter()
            live = live_dpus(staged.datasets)
            groups = dpu_groups(staged.plan, live)
            n = len(live)
            k = ops.robust_kwargs(n, mode, TRIM_FRAC)["k"]
            form = "fedavg" if eng.aggregation == "fedavg" else "eq11"
            want = dict.fromkeys(ops.LAUNCHES, 0)
            want.update(fedprox_accum=sum(g for (g, _m, _b) in groups),
                        robust_aggregate=1)
            for (gamma, _m, _bucket), idxs in groups.items():
                shapes["fedprox_accum"][(len(idxs), R, "shared")] += gamma
            shapes["robust_aggregate"][(n, R, mode, k, form)] += 1
            mean_loss, acc = eng.execute_round(state, staged)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            rep = eng.finish_round(state, staged, mean_loss, acc)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            got = {name: ops.LAUNCHES[name] - before[name]
                   for name in before}
            if got != want:
                raise AssertionError(f"{scenario}/{strategy} round "
                                     f"{rep.round}: launches {got} != "
                                     f"{want}")
            ev = staged.events
            rec = {"scenario": scenario, "strategy": strategy,
                   "robust": mode, "n": n, "k": k, "round": rep.round,
                   "wall_s": t3 - t0, "host_plan_s": t1 - t0,
                   "device_round_s": t2 - t1, "account_s": t3 - t2,
                   "loss": rep.loss, "acc": rep.acc,
                   "aggregator": rep.aggregator, "energy_J": rep.energy,
                   "delay_s": rep.delay, "dc_points": rep.dc_points,
                   "groups": [len(v) for v in groups.values()],
                   "corrupted": len(ev.corrupted),
                   "active_ues": ev.active_ues,
                   "handovers": len(ev.handovers),
                   "slowed": sum(1 for c in ev.compute_scale if c < 1.0),
                   "launches": got}
            records.append(rec)
            log(f"  {scenario}/{strategy:<11} round {rep.round}: "
                f"{mode} n={n} k={k}  wall {rec['wall_s']:.3f} s (plan "
                f"{rec['host_plan_s']:.3f}, device round "
                f"{rec['device_round_s']:.3f})  loss {rep.loss:.4f}  acc "
                f"{rep.acc:.3f}  aggregator DC{rep.aggregator}  energy "
                f"{rep.energy:.2f} J  delay {rep.delay:.3f} s  groups "
                f"{rec['groups']}  corrupted {rec['corrupted']}  active "
                f"{rec['active_ues']}  handovers {rec['handovers']}  "
                f"slowed {rec['slowed']}")
    launches = dict(ops.LAUNCHES)              # read just after
    log(f"  launches {launches}")
    for name, c in shapes.items():
        log(f"  {name} launch shapes: launches: {dict(c)}")
    if launches["nova_aggregate"] != 0:
        raise AssertionError("nova_aggregate launched on a robust round")
    for name in ("fedprox_accum", "robust_aggregate"):
        if launches[name] != sum(shapes[name].values()) or \
                launches[name] == 0:
            raise AssertionError(f"kernel {name}: {launches[name]} "
                                 "launches on the threat path")
    if not all(np.isfinite(r["loss"]) for r in records):
        raise AssertionError("a threat round's loss is not finite")
    for scenario, strategy, mode, _, state, _ in engines:
        acc = state.reports[-1].acc
        if not acc > 0.1:
            raise AssertionError(f"{scenario}/{strategy}/{mode}: final "
                                 f"accuracy {acc} is not above chance")
    return launches, shapes, records, engines


# ------------------------------------------------------- phase 3b: mesh --

MESH_RUNS = [("greedy_data", 3), ("fednova", 2)]


def drive_mesh_path(dev, world):
    """``MESH_RUNS`` through ``Engine(executor=MeshExecutor())`` on the
    card, counting launches per round.  Returns the launch counts, the
    shapes (fedprox_accum {(n, R, "per_dpu"): launches},
    nova_aggregate_stacked {(n, R): launches}), the per-round records and
    the engines."""
    from repro_torch.core.api import EngineOptions
    from repro_torch.core.engine import Engine, MeshExecutor, mesh_layout
    from repro_torch.data.synthetic import make_online_ues
    from repro_torch.kernels import ops
    from repro_torch.kernels.plane import as_plane
    from repro_torch.models.classifier import (classifier_accuracy,
                                               classifier_loss)
    from repro_torch.solver.objective import ObjectiveWeights

    net, ((trx, try_), (tex, tey)), p0, consts = world
    R = as_plane(p0).data.shape[0]
    ex = torch.from_numpy(tex[:1000]).to(dev)
    ey = torch.from_numpy(tey[:1000]).to(dev)

    def eval_fn(p):
        return classifier_accuracy(p, ex, ey)

    engines = []
    for strategy, rounds in MESH_RUNS:
        ues = make_online_ues(trx, try_, num_ue=20, mean_arrivals=2000.0,
                              std_arrivals=200.0, seed=0)
        eng = Engine(net, strategy, consts=consts,
                     ow=ObjectiveWeights(xi1=1.0, xi2=1e-2, xi3=2.0,
                                         T=rounds),
                     opts=EngineOptions(rounds=rounds, eta=0.1, seed=0),
                     executor=MeshExecutor(), device=dev)
        state = eng.init_loop(ues, init_params=p0, loss_fn=classifier_loss,
                              eval_fn=eval_fn)
        engines.append((strategy, eng, state, ues))
    torch.cuda.synchronize()

    shapes = {"fedprox_accum": Counter(), "nova_aggregate_stacked": Counter()}
    records = []
    ops.reset_launches()                       # counts to 0: the path
    for strategy, eng, state, ues in engines:
        while state.t < eng.opts.rounds:
            before = dict(ops.LAUNCHES)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            staged = eng.begin_round(state, ues)
            t1 = time.perf_counter()
            lay = mesh_layout(staged.plan, staged.datasets)
            n, gmax = len(lay.dpus), lay.gamma_max
            first = staged.datasets[lay.dpus[0]]
            staged_bytes = sum(
                n * lay.bucket * np.asarray(a).itemsize
                * int(np.prod(np.asarray(a).shape[1:])) for a in
                first.values())
            want = dict.fromkeys(before, 0)
            want.update(fedprox_accum=gmax, nova_aggregate_stacked=1)
            shapes["fedprox_accum"][(n, R, "per_dpu")] += gmax
            shapes["nova_aggregate_stacked"][(n, R)] += 1
            mean_loss, acc = eng.execute_round(state, staged)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            rep = eng.finish_round(state, staged, mean_loss, acc)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            got = {name: ops.LAUNCHES[name] - before[name]
                   for name in before}
            if got != want:
                raise AssertionError(f"mesh {strategy} round {rep.round}: "
                                     f"launches {got} != {want}")
            rec = {"strategy": strategy, "round": rep.round, "n": n,
                   "bucket": lay.bucket, "gamma_max": gmax,
                   "gammas": [int(g) for g in lay.gammas],
                   "sizes": lay.sizes, "staged_bytes": staged_bytes,
                   "wall_s": t3 - t0, "host_plan_s": t1 - t0,
                   "device_round_s": t2 - t1, "account_s": t3 - t2,
                   "peak_device_bytes": torch.cuda.max_memory_allocated(),
                   "loss": rep.loss, "acc": rep.acc,
                   "aggregator": rep.aggregator, "energy_J": rep.energy,
                   "delay_s": rep.delay, "dc_points": rep.dc_points,
                   "launches": got}
            records.append(rec)
            log(f"  mesh {strategy:<11} round {rep.round}: n={n} bucket="
                f"{lay.bucket} gamma_max={gmax} staged "
                f"{staged_bytes / 1e6:.1f} MB  wall {rec['wall_s']:.3f} s "
                f"(plan {rec['host_plan_s']:.3f}, device round "
                f"{rec['device_round_s']:.3f}, account "
                f"{rec['account_s']:.3f})  peak "
                f"{rec['peak_device_bytes'] / 2**20:.1f} MiB  loss "
                f"{rep.loss:.4f}  acc {rep.acc:.3f}  aggregator "
                f"DC{rep.aggregator}  energy {rep.energy:.2f} J  delay "
                f"{rep.delay:.3f} s  largest D_i {max(lay.sizes)}")
    launches = dict(ops.LAUNCHES)              # read just after
    log(f"  launches {launches}")
    for name, c in shapes.items():
        log(f"  {name} launch shapes: launches: {dict(c)}")
    for name in shapes:
        if launches[name] != sum(shapes[name].values()) or \
                launches[name] == 0:
            raise AssertionError(f"kernel {name}: {launches[name]} "
                                 "launches on the mesh path")
    if not all(np.isfinite(r["loss"]) for r in records):
        raise AssertionError("a mesh round's loss is not finite")
    for strategy, _, state, _ in engines:
        acc = state.reports[-1].acc
        if not acc > 0.1:
            raise AssertionError(f"mesh {strategy}: final accuracy {acc} "
                                 "is not above chance (0.1)")
    return launches, shapes, records, engines


# -------------------------------------------------------- phase 3c: api --

def drive_api_path(dev, world):
    """The tree-level ops on the paper classifier's tree, f32 and bf16
    leaves: ``ops.fedprox_update`` (eta 0.1, mu 0.01) and
    ``ops.nova_aggregate`` (5 d trees, absolute weights 600..1000,
    theta_eta 0.2), each one launch, against the plain per-leaf result.
    Tolerance: two f32 ulps of the largest operand for fedprox_update and
    two of the largest |x| plus theta_eta * n of the largest |d| for
    nova_aggregate (the kernels' FMAs); bf16 leaves: one bf16 ulp of the
    result or that bound.  Returns the launch counts, the launch shapes
    (fedprox_update {(R, dtype of the plane): launches}, nova_aggregate
    {(n, R): launches}) and the checks."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.plane import as_plane

    _, _, p0, _ = world
    R = as_plane(p0).data.shape[0]
    gen = torch.Generator(device=dev).manual_seed(77)
    sizes = [600.0, 700.0, 800.0, 900.0, 1000.0]
    w = ops.normalize_weights(sizes).to(dev)
    checks = []
    shapes = {"fedprox_update": Counter(), "nova_aggregate": Counter()}
    ops.reset_launches()                       # counts to 0: the path
    for dt in (torch.float32, torch.bfloat16):
        def tree():
            return {k: torch.randn(v.shape, generator=gen,
                                   device=dev).to(dt) for k, v in p0.items()}
        params, grads, anchor = ({k: v.to(dt) for k, v in p0.items()},
                                 tree(), tree())
        d_list = [tree() for _ in sizes]
        calls = [
            ("fedprox_update",
             lambda: ops.fedprox_update(params, grads, anchor, 0.1, 0.01),
             lambda k: ref.fedprox_update_ref(params[k], grads[k], anchor[k],
                                              0.1, 0.01),
             lambda k: 2 * max(_spacing(params[k]), _spacing(grads[k]),
                               _spacing(anchor[k]))),
            ("nova_aggregate",
             lambda: ops.nova_aggregate(params, d_list, sizes, 0.2),
             lambda k: ref.nova_aggregate_ref(
                 params[k], torch.stack([d[k] for d in d_list]), w, 0.2),
             lambda k: 2 * _spacing(params[k]) + 0.2 * len(sizes) * max(
                 _spacing(d[k]) for d in d_list))]
        for name, call, plain, atol in calls:
            before = dict(ops.LAUNCHES)
            got = call()
            torch.cuda.synchronize()
            delta = {k: ops.LAUNCHES[k] - before[k] for k in before}
            want = dict.fromkeys(before, 0)
            want[name] = 1
            if delta != want:
                raise AssertionError(f"tree-level {name} ({dt}): launches "
                                     f"{delta} != {want}")
            res = None
            for k in sorted(params):
                c = within(got[k], plain(k), atol(k))
                res = c if res is None else _both(res, c)
            res = {"op": name, "leaf_dtype": str(dt), **res}
            if any(got[k].dtype != dt for k in params):
                raise AssertionError(f"tree-level {name} changed a leaf's "
                                     "dtype")
            # the ops flatten onto the f32 master plane: f32 launches
            shapes[name][(R, "torch.float32") if name == "fedprox_update"
                         else (len(sizes), R)] += 1
            checks.append(res)
            log(f"  tree-level {name:<15} {str(dt):<15} one launch; max abs "
                f"err {res['max_abs_err']:.3e} (worst err/tol "
                f"{res['worst']:.2f}) {'ok' if res['ok'] else 'MISMATCH'}")
    launches = dict(ops.LAUNCHES)              # read just after
    bad = [c for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"tree-level ops disagree: {bad}")
    return launches, shapes, checks


def mesh_reference_check(dev, engines):
    """One more ``greedy_data`` mesh round (after the counted path),
    staged once on the CPU: the step on the card (kernels) against the
    same step on the CPU (plain versions), as staged (every gamma_i = 2)
    and with the gammas set to 1, 2, 3, 1, ... (gamma_max 3, so the
    per-DPU ``active`` mask and a_k differ between DPUs).  Tolerance: rtol
    1e-4, atol 1e-5 on the new replica stack and rtol 1e-4 on the loss,
    as phase 5's fused round (cuBLAS's and the CPU BLAS's summation
    orders over the SGD steps, and the kernels' FMAs).  Returns the
    largest error."""
    from repro_torch.core.round_step import CEFLHyper, build_cefl_round_step
    from repro_torch.kernels.plane import as_plane
    from repro_torch.models.classifier import classifier_loss

    strategy, eng, state, ues = engines[0]
    staged = eng.begin_round(state, ues)
    ex = eng.executor
    mr = ex.stage(staged.plan, staged.datasets, agg=eng.aggregation,
                  theta=eng.opts.theta, device=torch.device("cpu"))
    n = len(mr.layout.dpus)
    plane = as_plane(state.params)
    mixed = dict(mr.meta, gamma=torch.arange(n, dtype=torch.int32) % 3 + 1)
    worst = 0.0
    for label, meta in (("as staged", mr.meta), ("gammas 1-3", mixed)):
        step = build_cefl_round_step(classifier_loss, CEFLHyper(
            eta=eng.opts.eta, mu=eng.mu_effective, theta=1.0,
            gamma_max=int(meta["gamma"].max())))
        outs = []
        for where in (torch.device("cpu"), dev):
            p = plane.with_data(plane.data.to(where))
            stack = p.with_data(p.broadcast(n).data.contiguous())
            new, metrics = step(stack, {k: v.to(where)
                                        for k, v in mr.batch.items()},
                                {k: v.to(where) for k, v in meta.items()})
            outs.append((new.data.cpu(), float(metrics["loss"])))
        (cn, cl), (gn, gl) = outs
        err = float((gn - cn).abs().max())
        torch.testing.assert_close(gn, cn, rtol=1e-4, atol=1e-5)
        if abs(gl - cl) > 1e-4 * abs(cl):
            raise AssertionError(f"mesh round loss {gl} (card) vs {cl} "
                                 "(CPU)")
        log(f"  mesh round ({strategy}, n={n}, bucket={mr.layout.bucket}, "
            f"{label}) card vs CPU: replica stack max abs err {err:.3e}, "
            f"loss {gl:.6f} vs {cl:.6f}")
        worst = max(worst, err)
    return worst


def staging_and_profile(dev, engines):
    """Host->device staging of the last greedy_data round's data, timed
    alone, and a profile of one more fednova round (after the counted
    path).  Returns a summary dict."""
    from repro_torch.core import fedprox
    from repro_torch.core.engine import dpu_groups, live_dpus

    strategy, eng, state, ues = engines[0]
    staged = eng.begin_round(state, ues)
    live = live_dpus(staged.datasets)
    gen = torch.Generator(device=dev).manual_seed(7)
    nbytes = sum(d["x"].nbytes + d["y"].nbytes for _, d in live)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for (gamma, m, bucket), idxs in dpu_groups(staged.plan, live).items():
        data = [live[j][1] for j in idxs]
        Ds = [len(d["y"]) for d in data]
        fedprox._stage_group_batches(data, gen, Ds, bucket, gamma, m, dev)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    log(f"  staging one greedy_data round: {nbytes / 1e6:.1f} MB host "
        f"data in {stage_s * 1e3:.1f} ms")

    strategy, eng, state, ues = engines[1]
    return {"staging_bytes": nbytes, "staging_s": stage_s,
            **profile_round("fednova", eng, state, ues)}


def profile_round(label, eng, state, ues):
    """One more round of ``eng`` (after the counted path) under
    ``torch.profiler``: its wall time, device busy time and the kernels
    that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        staged = eng.begin_round(state, ues)
        mean_loss, acc = eng.execute_round(state, staged)
        eng.finish_round(state, staged, mean_loss, acc)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    busy_us = sum(device_us(e) for e in events)
    top = sorted(events, key=lambda e: -device_us(e))[:12]
    table = [{"name": e.key, "calls": e.count,
              "device_ms": device_us(e) / 1e3} for e in top]
    log(f"  profiled {label} round: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms ({100 * busy_us / 1e3 / (wall * 1e3):.2f}"
        f" % of wall)")
    for r in table[:6]:
        log(f"    {r['device_ms']:9.3f} ms  {r['calls']:4d}x  "
            f"{r['name'][:70]}")
    return {"profiled_round_wall_s": wall,
            "profiled_round_device_ms": busy_us / 1e3, "top": table}


# ----------------------------------------------------- phase 5: check --

def reference_check(dev, world):
    """One fused round at paper width, staged once on the CPU: the card
    (kernels) against the CPU (plain versions).  Tolerance: rtol 1e-4,
    atol 1e-5 on the new plane and rtol 1e-4 on the losses — the f32
    products run in cuBLAS's and the CPU BLAS's summation orders over
    two SGD steps, and nvcc contracts the kernels' multiply-adds."""
    from repro_torch.core import fedprox
    from repro_torch.kernels.plane import as_plane
    from repro_torch.models.classifier import (classifier_accuracy,
                                               classifier_loss)

    net, ((trx, try_), (tex, tey)), p0, _ = world
    plane = as_plane({k: v.cpu() for k, v in p0.items()})
    rng = np.random.RandomState(3)
    datasets = []
    for D in (600, 700, 800, 900, 1000):      # one mini-batch bucket
        idx = rng.choice(len(try_), D, replace=False)
        datasets.append({"x": trx[idx], "y": try_[idx]})
    gamma, m, eta, mu, theta = 2, 0.5, 0.1, 0.01, 2.0
    Ds, bucket = fedprox._group_layout(datasets, m)
    staged = fedprox._stage_group_batches(
        datasets, torch.Generator().manual_seed(0), Ds, bucket, gamma, m,
        torch.device("cpu"))
    ex, ey = torch.from_numpy(tex[:1000]), torch.from_numpy(tey[:1000])
    outs = {}
    for where in ("cpu", dev):
        p = plane.data.to(where)
        args = (plane.broadcast(5).data.contiguous().to(where), p,
                {k: v.to(where) for k, v in staged[0].items()},
                staged[1].to(where), staged[2].to(where),
                fedprox.a_coefficients(gamma, eta, mu), eta, mu,
                torch.tensor(Ds, dtype=torch.float32), theta * eta)
        exw, eyw = ex.to(where), ey.to(where)
        run = fedprox._plane_round_fn(
            classifier_loss, plane.spec,
            lambda q: classifier_accuracy(q, exw, eyw))
        new, losses, acc = run(*args)
        outs[str(where)] = (new.cpu(), losses.cpu(), float(acc))
    (cn, cl, ca), (gn, gl, ga) = outs["cpu"], outs[str(dev)]
    err = float((gn - cn).abs().max())
    torch.testing.assert_close(gn, cn, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(gl, cl, rtol=1e-4, atol=0.0)
    log(f"  fused round card vs CPU: plane max abs err {err:.3e}, losses "
        f"max rel err {float(((gl - cl) / cl).abs().max()):.3e}, acc "
        f"{ga:.3f} vs {ca:.3f}")
    if abs(ga - ca) * 1000 > 2:
        raise AssertionError(f"eval accuracy {ga} (card) vs {ca} (CPU)")
    return err


# ------------------------------------------------------- phase 7: cefl --

# The front door's presets on the card, through repro_torch.experiments.run:
# (preset, overrides).  paper_table1 keeps its width and network and is cut
# to 4 rounds and one seed (rounds 0 and 3 re-solve: two SCA solves).
CEFL_RUNS = [("paper_table1", {"engine.rounds": 4, "seeds": (0,)}),
             ("quickstart", {})]


def drive_cefl_path(dev, runs=CEFL_RUNS):
    """``CEFL_RUNS`` through ``repro_torch.experiments.run`` on ``dev``:
    the ``cefl`` strategy's SCA solve and aggregator enumeration on the
    card each re-solve round.  Per round it times the host plan (split
    into the SCA solve, ``select_aggregator`` and the rest: the scenario
    tick, the rounding and the offloading split), the device round and
    the constants estimation, reads the solver's outer and primal-dual
    iteration counts, and checks: the plan validates, the aggregation
    point is one of the S DCs, and the round launched ``fedprox_accum``
    gamma times per DPU group and ``nova_aggregate`` once, as phase 2's
    rounds do.  The counters are set to 0 just before the runs and read
    just after.  Returns the launch counts, the launch shapes, the
    per-round records and the contexts."""
    from repro_torch import experiments
    from repro_torch.core.engine import Engine, dpu_groups, live_dpus
    from repro_torch.experiments import build
    from repro_torch.kernels import ops
    from repro_torch.kernels.plane import as_plane
    from repro_torch.solver import sca

    calls = {"solve": [], "select": [], "estimate": []}

    def timed(name, fn):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            calls[name].append((time.perf_counter() - t0, out))
            return out
        return wrapper

    cur, records = {}, []
    shapes = {"fedprox_accum": Counter(), "nova_aggregate": Counter()}
    real = {"solve": sca.solve, "select": sca.select_aggregator,
            "estimate": build.estimate_constants,
            "begin": Engine.begin_round, "execute": Engine.execute_round}

    def begin_round(self, state, ues):
        cur.clear()
        cur.update(n_solve=len(calls["solve"]),
                   n_select=len(calls["select"]), before=dict(ops.LAUNCHES))
        t0 = time.perf_counter()
        staged = real["begin"](self, state, ues)
        cur["plan_s"] = time.perf_counter() - t0
        groups = dpu_groups(staged.plan, live_dpus(staged.datasets))
        R = as_plane(state.params).data.shape[0]
        cur["want"] = dict.fromkeys(ops.LAUNCHES, 0)
        cur["want"].update(fedprox_accum=sum(g for g, _m, _b in groups),
                           nova_aggregate=1)
        for (gamma, _m, _b), idxs in groups.items():
            shapes["fedprox_accum"][(len(idxs), R, "shared")] += gamma
        shapes["nova_aggregate"][(len(live_dpus(staged.datasets)), R)] += 1
        cur["groups"] = [len(v) for v in groups.values()]
        cur["net"] = staged.net_t
        return staged

    def execute_round(self, state, staged):
        t0 = time.perf_counter()
        out = real["execute"](self, state, staged)
        torch.cuda.synchronize()
        cur["device_round_s"] = time.perf_counter() - t0
        return out

    def on_round(rep, name):
        got = {k: ops.LAUNCHES[k] - cur["before"][k] for k in ops.LAUNCHES}
        if got != cur["want"]:
            raise AssertionError(f"cefl {name} round {rep.round}: launches "
                                 f"{got} != {cur['want']}")
        rep.plan.validate(cur["net"])
        S = cur["net"].cfg.num_dc
        I_s = rep.plan.I_s.numpy()
        if not (0 <= rep.aggregator < S and I_s.sum() == 1
                and I_s[rep.aggregator] == 1):
            raise AssertionError(f"cefl {name} round {rep.round}: "
                                 f"aggregator {rep.aggregator} of {S} DCs")
        solves = calls["solve"][cur["n_solve"]:]
        selects = calls["select"][cur["n_select"]:]
        solve_s = sum(t for t, _ in solves)
        select_s = sum(t for t, _ in selects)
        rec = {"experiment": name, "round": rep.round,
               "solved": bool(solves), "plan_s": cur["plan_s"],
               "sca_solve_s": solve_s, "select_aggregator_s": select_s,
               "plan_rest_s": cur["plan_s"] - solve_s - select_s,
               "outer_iterations": [r.iterations for _, r in solves],
               "pd_iterations": [r.pd_iterations for _, r in solves],
               "device_round_s": cur["device_round_s"],
               "wall_s": rep.wall_time, "loss": rep.loss, "acc": rep.acc,
               "aggregator": rep.aggregator, "energy_J": rep.energy,
               "delay_s": rep.delay, "dc_points": rep.dc_points,
               "groups": cur["groups"], "launches": got}
        records.append(rec)
        log(f"  cefl {name:<12} round {rep.round}: plan "
            f"{rec['plan_s']:.3f} s (SCA solve {solve_s:.3f}, "
            f"select_aggregator {select_s:.3f}, rest "
            f"{rec['plan_rest_s']:.3f}; outer iterations "
            f"{rec['outer_iterations']}, primal-dual {rec['pd_iterations']})"
            f"  device round {rec['device_round_s']:.3f} s  loss "
            f"{rep.loss:.4f}  acc {rep.acc:.3f}  aggregator "
            f"DC{rep.aggregator}  energy {rep.energy:.2f} J  delay "
            f"{rep.delay:.3f} s  groups {rec['groups']}")

    results, contexts, estimate_s = {}, {}, {}
    sca.solve = timed("solve", real["solve"])
    sca.select_aggregator = timed("select", real["select"])
    build.estimate_constants = timed("estimate", real["estimate"])
    Engine.begin_round, Engine.execute_round = begin_round, execute_round
    try:
        experiments.clear_context_cache()
        specs = [experiments.get_experiment(name).override(**over)
                 for name, over in runs]
        for spec in specs:                    # built (and estimated) first
            n_est = len(calls["estimate"])
            contexts[spec.name] = experiments.build_context(spec,
                                                            device=dev)
            est = calls["estimate"][n_est:]
            if est:
                estimate_s[spec.name] = est[0][0]
            log(f"  {spec.name}: context built on the card; constants "
                + (f"estimated in {est[0][0]:.3f} s (L {est[0][1].L:.3f}, "
                   f"zeta1 {est[0][1].zeta1:.3f}, zeta2 "
                   f"{est[0][1].zeta2:.3f})" if est else "fixed"))
        torch.cuda.synchronize()
        ops.reset_launches()                  # counts to 0: the path
        for spec in specs:
            results[spec.name] = experiments.run(
                spec, device=dev,
                callbacks=(lambda rep, n=spec.name: on_round(rep, n),))
        launches = dict(ops.LAUNCHES)         # read just after
    finally:
        sca.solve, sca.select_aggregator = real["solve"], real["select"]
        build.estimate_constants = real["estimate"]
        Engine.begin_round = real["begin"]
        Engine.execute_round = real["execute"]
    log(f"  launches {launches}")
    for name in shapes:
        if launches[name] != sum(shapes[name].values()) or \
                launches[name] == 0:
            raise AssertionError(f"kernel {name}: {launches[name]} launches "
                                 "on the cefl path")
    for spec in specs:
        res = results[spec.name]
        solved = [r for r in records
                  if r["experiment"] == spec.name and r["solved"]]
        want = len(range(0, spec.engine.rounds,
                         spec.engine.reoptimize_every))
        if len(res) != spec.engine.rounds or len(solved) != want:
            raise AssertionError(f"cefl {spec.name}: {len(res)} rounds, "
                                 f"{len(solved)} solves (want {want})")
        if not all(np.isfinite(r.loss) for r in res.reports):
            raise AssertionError(f"cefl {spec.name}: a loss is not finite")
        if not res.final.acc > 0.1:
            raise AssertionError(f"cefl {spec.name}: final accuracy "
                                 f"{res.final.acc} is not above chance")
    return launches, shapes, records, contexts, estimate_s


def _parity(name, got, want, net, D_bar):
    """``tests/test_solver_diff.py``'s bar between two SCA results: the
    objective history within 1e-4 relative, identical rounded indicators,
    relaxed decisions within 5e-3 of their scale, the rounded plans'
    constraint residuals within 1e-3 of their scale and the violation
    history within 1e-2.  Returns the largest relative objective error."""
    from repro_torch.solver import constraints as K
    from repro_torch.solver.variables import NetView

    def cpu(w):
        return {k: v.detach().cpu() for k, v in w.items()}

    gh = np.asarray(got.objective_history)
    wh = np.asarray(want.objective_history)
    if gh.shape != wh.shape:
        raise AssertionError(f"{name}: {len(gh)} vs {len(wh)} iterates")
    np.testing.assert_allclose(gh, wh, rtol=1e-4, err_msg=name)
    g, w = cpu(got.w), cpu(want.w)
    gr, wr = cpu(got.w_rounded), cpu(want.w_rounded)
    for k in ("I_s", "I_nb", "I_bn"):
        if not torch.equal(gr[k], wr[k]):
            raise AssertionError(f"{name}: rounded {k} differs")
    for k in ("rho_nb", "rho_bs", "f_n", "z_s", "gamma", "m", "R_bs"):
        scale = max(1.0, float(w[k].abs().max()))
        np.testing.assert_allclose(g[k].numpy(), w[k].numpy(),
                                   atol=5e-3 * scale, err_msg=f"{name} {k}")
    nv = NetView.from_network(net)
    D = torch.as_tensor(D_bar, dtype=torch.float32)
    vg = K.constraint_vector(gr, nv, D).numpy()
    vw = K.constraint_vector(wr, nv, D).numpy()
    np.testing.assert_allclose(vg, vw, atol=1e-3 * max(
        1.0, float(np.abs(vw).max())), err_msg=name)
    np.testing.assert_allclose(got.violation_history,
                               want.violation_history, atol=1e-2,
                               err_msg=name)
    return float(np.max(np.abs(gh - wh) / np.abs(wh)))


def cefl_solve_check(dev, ctx):
    """One paper-width SCA solve (``ctx``'s 20/10/5 network and estimated
    constants, the first round's arrivals, ``solver_outer`` outer steps,
    the default Algorithm-2 hyper-parameters), centralized and
    distributed, on the card against the same solve on the CPU, to
    ``tests/test_solver_diff.py``'s bar; then one more centralized card
    solve under ``torch.profiler`` (device busy share; the launches it
    sees are a lower bound: the profiler drops records on this card).
    Returns a summary dict."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.solver import sca

    D_bar = np.array([len(u.step()["y"]) for u in ctx.make_ues(0)], float)
    outer = ctx.spec.engine.solver_outer
    out = {}
    for distributed in (False, True):
        res, secs = {}, {}
        for label, where in (("cpu", torch.device("cpu")), ("card", dev)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[label] = sca.solve(
                ctx.net, torch.as_tensor(D_bar, dtype=torch.float32,
                                         device=where), ctx.consts, ctx.ow,
                max_outer=outer, distributed=distributed)
            torch.cuda.synchronize()
            secs[label] = time.perf_counter() - t0
        if res["card"].w["rho_nb"].device.type != dev.type:
            raise AssertionError("the card solve left the card")
        form = "distributed" if distributed else "centralized"
        err = _parity(f"SCA solve ({form})", res["card"], res["cpu"],
                      ctx.net, D_bar)
        out[form] = {"card_s": secs["card"], "cpu_s": secs["cpu"],
                     "objective_max_rel_err": err,
                     "outer_iterations": res["card"].iterations,
                     "pd_iterations": res["card"].pd_iterations,
                     "objective_history": res["card"].objective_history}
        log(f"  paper-width SCA solve, {form}: card {secs['card']:.3f} s, "
            f"CPU {secs['cpu']:.3f} s, objective max rel err {err:.2e}, "
            f"outer {res['card'].iterations}, primal-dual "
            f"{res['card'].pd_iterations}; rounded plans identical")

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    D = torch.as_tensor(D_bar, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sca.solve(ctx.net, D, ctx.consts, ctx.ow, max_outer=outer,
                  distributed=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    busy_us = sum(device_us(e) for e in events)
    seen = sum(e.count for e in events)
    top = sorted(events, key=lambda e: -device_us(e))[:8]
    out["profile"] = {"wall_s": wall, "device_busy_ms": busy_us / 1e3,
                      "busy_share": busy_us / 1e6 / wall,
                      "launches_seen_lower_bound": seen,
                      "top": [{"name": e.key, "calls": e.count,
                               "device_ms": device_us(e) / 1e3}
                              for e in top]}
    log(f"  profiled centralized solve: wall {wall * 1e3:.1f} ms, device "
        f"busy {busy_us / 1e3:.2f} ms ({100 * busy_us / 1e6 / wall:.2f} % "
        f"of wall), {seen} kernel launches seen (a lower bound: the "
        f"profiler drops records on this card)")
    for e in top[:5]:
        log(f"    {device_us(e) / 1e3:9.3f} ms  {e.count:5d}x  "
            f"{e.key[:70]}")
    return out


# ------------------------------------------------------ phase 6: serve --

SERVE_ARCH = "starcoder2-15b"
# (label, requests, prompt tokens): the serving path, then a rolling run
# whose prompts fill the window, so every step wraps the slot and attends
# over a full cache
SERVE_RUNS = [("8 x 512", 8, 512), ("rolling 2 x 4096", 2, 4096)]
SERVE_GEN, SERVE_CACHE = 32, 4096


def drive_serve_path(dev, cfg=None, runs=SERVE_RUNS, gen=SERVE_GEN,
                     cache_len=SERVE_CACHE):
    """``repro_torch.serve.serve`` at full width and depth (starcoder2-15b,
    bf16, random weights from a seed on the card): each of ``runs`` greedy-
    generates ``gen`` tokens, with the launch counters set to 0 just
    before and read just after.  Each run must launch
    ``swa_decode_attention`` num_layers x (gen - 1) times and no other
    kernel; logits finite, tokens in the vocab.  Returns the summed
    launches, the kernel's launch shapes ((B, S, cache_len) -> launches),
    the per-run records, a profiled decode step and the init record."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.plane import tree_paths
    from repro_torch.models import lm as L
    from repro_torch.serve import serve

    cfg = cfg or get_config(SERVE_ARCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = L.init_lm_params(torch.Generator(device=dev).manual_seed(0),
                              cfg)
    torch.cuda.synchronize()
    leaves = [t for _, t in tree_paths(params)]
    init = {"init_s": time.perf_counter() - t0,
            "weight_bytes": sum(t.numel() * t.element_size() for t in leaves),
            "params": sum(t.numel() for t in leaves)}
    log(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{init['params'] / 1e9:.3f} G params, "
        f"{init['weight_bytes'] / 1e9:.2f} GB of {cfg.dtype} weights made on "
        f"the card in {init['init_s']:.2f} s")
    total = Counter()
    shapes = Counter()
    records = []
    window = cfg.sliding_window or cache_len
    for label, B, P in runs:
        prompts = np.random.RandomState(1).randint(0, cfg.vocab_size, (B, P))
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()                   # counts to 0: the path
        t0 = time.perf_counter()
        tokens, stats = serve(cfg, prompts, gen=gen, cache_len=cache_len,
                              params=params, device=dev)
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)          # read just after
        want = dict.fromkeys(launches, 0)
        want["swa_decode_attention"] = cfg.num_layers * (gen - 1)
        if launches != want:
            raise AssertionError(f"serve {label}: launches {launches} != "
                                 f"{want}")
        S = min(window, cache_len)
        for pos in range(P, P + gen - 1):
            shapes[(B, S, min(pos + 1, S))] += cfg.num_layers
        if not stats["logits_finite"]:
            raise AssertionError(f"serve {label}: logits not finite")
        lo, hi = int(tokens.min()), int(tokens.max())
        if tuple(tokens.shape) != (B, gen) or lo < 0 or \
                hi >= cfg.vocab_size:
            raise AssertionError(f"serve {label}: tokens "
                                 f"{tuple(tokens.shape)} in [{lo}, {hi}]")
        steps = stats["decode_step_s"]
        med = statistics.median(steps[1:])
        rec = {"run": label, "batch": B, "prompt": P, "gen": gen,
               "cache_len": cache_len, "wall_s": wall,
               "prefill_s": stats["prefill_s"],
               "prefill_tokens_per_s": B * P / stats["prefill_s"],
               "decode_first_ms": steps[0] * 1e3,
               "decode_ms_median": med * 1e3,
               "decode_ms_min": min(steps) * 1e3,
               "decode_ms_max": max(steps) * 1e3,
               "tokens_per_s": B / med,
               "peak_device_bytes": torch.cuda.max_memory_allocated(),
               "launches": launches, "first_tokens": tokens[0, :8].tolist()}
        records.append(rec)
        total.update(launches)
        log(f"  serve {label} (prompt {P}, {gen} tokens, cache {cache_len}):"
            f" prefill {rec['prefill_s']:.3f} s "
            f"({rec['prefill_tokens_per_s']:.0f} tokens/s), decode "
            f"{rec['decode_ms_median']:.2f} ms/step median after the first "
            f"(first {rec['decode_first_ms']:.2f}, min "
            f"{rec['decode_ms_min']:.2f}, max {rec['decode_ms_max']:.2f})"
            f", {rec['tokens_per_s']:.1f} tokens/s batched, peak "
            f"{rec['peak_device_bytes'] / 2**30:.2f} GiB; "
            f"swa_decode_attention x{launches['swa_decode_attention']}")
    prof = profile_decode_step(params, cfg, dev, runs[0][1], runs[0][2],
                               cache_len)
    del params
    torch.cuda.empty_cache()
    return dict(total), shapes, records, prof, init


def profile_decode_step(params, cfg, dev, B, P, cache_len):
    """One decode step of a fresh B x P prefill (after the counted runs;
    one step to warm up) under ``torch.profiler``: wall time, device busy
    time and the operations that took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm as L

    prompts = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (B, P))).to(dev)
    logits, cache = L.prefill(params, cfg, prompts, cache_len)
    tok = torch.argmax(logits, dim=-1)
    logits, cache = L.lm_decode_step(params, cfg, tok, cache)
    tok = torch.argmax(logits, dim=-1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, cache = L.lm_decode_step(params, cfg, tok, cache)
        tok = torch.argmax(logits, dim=-1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def device_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    averages = prof.key_averages()
    events = [e for e in averages
              if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    busy_us = sum(device_us(e) for e in events)
    top = sorted(events, key=lambda e: -device_us(e))[:12]
    table = [{"name": e.key, "calls": e.count,
              "device_ms": device_us(e) / 1e3} for e in top]
    # the host side: launches issued and the ops with the most host time
    host = [e for e in averages if e.device_type == DeviceType.CPU]
    launches = sum(e.count for e in host if e.key in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
        "cuLaunchKernelEx"))
    host_top = [{"name": e.key, "calls": e.count,
                 "self_cpu_ms": e.self_cpu_time_total / 1e3}
                for e in sorted(host, key=lambda e: -e.self_cpu_time_total)
                [:12]]
    log(f"  profiled decode step (B = {B}, cache_len {P + 2}): wall "
        f"{wall * 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms "
        f"({100 * busy_us / 1e3 / (wall * 1e3):.1f} % of wall), "
        f"{launches} kernel launches")
    for r in table[:8]:
        log(f"    {r['device_ms']:9.3f} ms  {r['calls']:4d}x  "
            f"{r['name'][:70]}")
    log("    host, self time:")
    for r in host_top[:8]:
        log(f"    {r['self_cpu_ms']:9.3f} ms  {r['calls']:4d}x  "
            f"{r['name'][:70]}")
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
            "busy_share": busy_us / 1e3 / (wall * 1e3), "top": table,
            "kernel_launches": launches, "host_top": host_top}


# swa_decode_attention cases beyond the path's: (B, Hq, Hkv, D, S,
# cache_len, dtype); G = Hq / Hkv
SWA_EXTRA = [
    (8, 48, 4, 128, 4096, 4096, torch.bfloat16),    # full cache at B = 8
    (8, 48, 4, 128, 4096, 4096, torch.float32),
    (2, 48, 4, 128, 4096, 4096, torch.float32),
    (8, 4, 4, 128, 4096, 2000, torch.bfloat16),     # G = 1
    (8, 32, 4, 128, 4096, 2000, torch.bfloat16),    # G = 8
    (8, 64, 4, 128, 4096, 2000, torch.bfloat16),    # G = 16
    (4, 16, 4, 32, 1000, 777, torch.float32),       # D = 32, S = 1000
    (4, 16, 4, 32, 1000, 777, torch.bfloat16),
    (4, 24, 4, 64, 1000, 1000, torch.float32),      # D = 64, cache_len S
    (4, 24, 4, 64, 1000, 1000, torch.bfloat16),
    (2, 48, 4, 128, 1000, 1, torch.bfloat16),       # cache_len 1
    (2, 48, 4, 128, 1000, 1, torch.float32),
    (1, 48, 4, 128, 32768, 32768, torch.bfloat16),  # decode_32k's cache
]


def swa_checks(dev, timer, bw, f32_rate, bf16_rate, path, Hq=48, Hkv=4,
               D=128):
    """``swa_decode_attention`` against its plain version at the first and
    last (B, S, cache_len) of each serve run (``path``: {(B, S,
    cache_len): launches}; bf16, starcoder2's heads) and at
    ``SWA_EXTRA``.
    Tolerance: float32 within 8 f32 ulps of the largest |v| (the output
    is a convex combination of v rows; the scores are summed in another
    order, with FMAs, which moves each softmax weight by a few ulps
    relative); bfloat16 within one bf16 ulp of the plain version's f32
    result on the same inputs, or that f32 tolerance where it is larger
    (the kernel's f32 result agrees to f32 rounding, then rounds once to
    bf16; near zero the f32 difference outweighs a bf16 ulp).  Every
    case is timed beside the plain version and, as the library yardstick,
    one ``F.scaled_dot_product_attention(..., enable_gqa=True)`` with a
    ``pos < cache_len`` mask over the same cache (strided views, no copy).
    The bound's
    operations term takes the dense bf16 tensor rate for bf16 (the kernel
    runs on the tensor cores) and the f32 rate for float32.  At the main
    path's shape and at B = 8 full, one call must capture as a CUDA graph
    of one kernel (the splits merge in the same launch), and the profiler
    reports its device time per launch.  Returns the rows and the
    row of the main path's shape (the 8 x 512 run's first step)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_decode_attention as kswa

    gen = torch.Generator(device=dev).manual_seed(9876)
    keys = sorted(path)
    firsts = {}
    for B, S, cl in keys:
        firsts.setdefault((B, S), []).append(cl)
    cases = []
    for (B, S), cls in sorted(firsts.items()):
        for cl in sorted({min(cls), max(cls)}):
            cases.append((B, Hq, Hkv, D, S, cl, torch.bfloat16,
                          path[(B, S, cl)]))
    cases += [c + (0,) for c in SWA_EXTRA]
    # the main path's shape: the first step of the largest batch
    main_key = min(path, key=lambda key: (-key[0], key[2]))
    rows, main = [], None
    for B, Hq_, Hkv_, D_, S, cl, dt, on_path in cases:
        q = torch.randn((B, Hq_, D_), generator=gen, device=dev).to(dt)
        k = torch.randn((B, S, Hkv_, D_), generator=gen, device=dev).to(dt)
        v = torch.randn((B, S, Hkv_, D_), generator=gen, device=dev).to(dt)
        got = kswa.swa_decode_attention(q, k, v, cl)
        want = ref.swa_decode_attention_ref(q.float(), k.float(), v.float(),
                                            cl)
        torch.cuda.synchronize()
        atol = 8 * _spacing(v)
        check = (within(got, want, atol) if dt == torch.float32
                 else _within_bf16_of_f32(got, want, atol))
        es = q.element_size()
        nbytes = es * (2 * B * cl * Hkv_ * D_ + 2 * B * Hq_ * D_)
        flops = 4 * B * Hq_ * cl * D_
        mask = (torch.arange(S, device=dev) < cl).view(1, 1, 1, S)
        qs, ks, vs = (q.view(B, Hq_, 1, D_), k.transpose(1, 2),
                      v.transpose(1, 2))
        lib = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                             enable_gqa=True)
        row = {"kernel": "swa_decode_attention", "G": Hq_ // Hkv_, "R": S,
               "B": B, "Hq": Hq_, "Hkv": Hkv_, "D": D_, "S": S,
               "cache_len": cl, "dtype": str(dt).replace("torch.", ""),
               "anchor": f"B={B} D={D_} len={cl}",
               "path_launches": on_path, "bytes": nbytes, **check,
               "library_max_abs_err": float(
                   (lib.view(B, Hq_, D_).float() - want).abs().max())}
        row["ms"] = timer(lambda: kswa.swa_decode_attention(q, k, v, cl))
        row["plain_ms"] = timer(lambda: ref.swa_decode_attention_ref(
            q, k, v, cl))
        row["library_ms"] = timer(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=True))
        rate = bf16_rate if dt == torch.bfloat16 else f32_rate
        row["bound_ms"] = max(nbytes / bw, flops / rate) * 1e3
        row["bound_by"] = "bytes" if nbytes / bw >= flops / rate \
            else "operations"
        if on_path and (B, S, cl) == main_key or (B, S, cl, dt) == (
                8, 4096, 4096, torch.bfloat16):
            one_kernel_per_call(
                lambda: kswa.swa_decode_attention(q, k, v, cl),
                f"swa_decode_attention at (B={B}, len={cl})")
            row["one_kernel_per_call"] = True
            row["launch_split_us"] = launch_split(
                lambda: kswa.swa_decode_attention(q, k, v, cl))
        if on_path and (B, S, cl) == main_key:
            main = row
        rows.append(row)
        log(f"  {_fmt(row)}")
        if "launch_split_us" in row:
            log(f"    device time per launch: {row['launch_split_us']}")
    return rows, main


def launch_split(fn, iters=10, tries=3) -> dict:
    """Device microseconds per launch of each kernel ``fn`` launches, from
    ``torch.profiler`` over ``iters`` calls: a report, not a check.  The
    tracer on the card drops records now and then (8 of 10 launches seen;
    whole traces in a process that has profiled before), so the time is
    per launch seen, and a trace without device activity is taken again,
    up to ``tries`` times in all; after that the result is empty."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            if e.device_type == DeviceType.CUDA and us > 0:
                m = re.search(r"(\w+_kernel)", e.key)
                out[m.group(1) if m else e.key] = round(us / e.count, 2)
        if out:
            return out
    log(f"  the profiler saw no device activity in {tries} traces: no "
        "device time per launch")
    return {}


def graph_nodes(fn) -> list:
    """The node types (``CUgraphNodeType``; 0 is a kernel) of a CUDA graph
    captured from one call of ``fn``, read through the driver API.  A
    first call on the capture stream makes what ``fn`` keeps per stream
    (``swa_decode_attention``'s tickets), so the capture holds the call
    alone.  Unlike a trace, the graph holds every launch."""
    import ctypes

    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    torch.cuda.synchronize()
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    types = []
    for node in nodes:
        t = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)):
            raise RuntimeError("cuGraphNodeGetType failed")
        types.append(t.value)
    del graph
    return types


def one_kernel_per_call(fn, what: str) -> None:
    """Raises unless one call of ``fn`` is one kernel launch and nothing
    else (``graph_nodes``)."""
    types = graph_nodes(fn)
    if types != [0]:
        raise AssertionError(f"{what}: one call captures the graph nodes "
                             f"{types} (0 = kernel), not one kernel")


def _within_bf16_of_f32(got, want_f32, atol) -> dict:
    """A bf16 result within one bf16 ulp of an f32 reference (the larger
    ulp of |got| and |want|) or ``atol``, whichever is larger, per
    element: near zero a bf16 ulp is smaller than the f32 difference the
    rounding starts from."""
    g = got.float()
    err = (g - want_f32).abs()
    bound = torch.clamp(_bf16_ulp(torch.maximum(g.abs(), want_f32.abs())),
                        min=atol)
    ratio = torch.where(err == 0, torch.zeros_like(err), err / bound)
    return {"max_abs_err": float(err.max()), "tol": float(bound.max()),
            "tol_rule": "1 bf16 ulp of the f32 plain result, or f32 tol",
            "worst": float(ratio.max()), "ok": bool(torch.all(err <= bound))}


SERVE_CHECK = {"layers": 2, "batch": 2, "prompt": 64, "steps": 8,
               "logits_atol": 5e-4}


def serve_reference_check(dev, cfg=None, layers=SERVE_CHECK["layers"],
                          batch=SERVE_CHECK["batch"],
                          prompt=SERVE_CHECK["prompt"],
                          steps=SERVE_CHECK["steps"],
                          atol=SERVE_CHECK["logits_atol"]):
    """starcoder2-15b at full width with ``layers`` layers, float32, TF32
    off: the same weights (made on the CPU from a seed) and prompts on the
    card (the kernel) and on the CPU (plain versions), prefill and
    ``steps`` decode steps, each step fed the CPU's greedy token.
    Tolerance on the logits: ``atol`` (5e-4 against logits of order 2:
    products of depth up to 24,576 summed in cuBLAS's and the CPU BLAS's
    orders through two layers, and the kernel's summation order).  The
    card's greedy token must equal the CPU's wherever the CPU's top-2
    logit margin exceeds 2 * atol.  Returns the largest logit error."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.plane import tree_map
    from repro_torch.models import lm as L

    cfg = cfg or dataclasses.replace(get_config(SERVE_ARCH),
                                     num_layers=layers)
    params = L.init_lm_params(torch.Generator().manual_seed(11), cfg,
                              torch.float32)
    gparams = tree_map(lambda t: t.to(dev), params)
    prompts = torch.from_numpy(np.random.RandomState(12).randint(
        0, cfg.vocab_size, (batch, prompt)))
    worst, checked, agree = 0.0, 0, 0
    cl, cc = L.prefill(params, cfg, prompts, SERVE_CACHE)
    gl, gc = L.prefill(gparams, cfg, prompts.to(dev), SERVE_CACHE)
    for step in range(steps + 1):
        g = gl.cpu()
        err = float((g - cl).abs().max())
        worst = max(worst, err)
        if err > atol:
            raise AssertionError(f"serve check step {step}: logits differ "
                                 f"by {err} > {atol}")
        top2 = torch.topk(cl, 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * atol
        tok = torch.argmax(cl, dim=-1)
        same = torch.argmax(g, dim=-1) == tok
        if not bool(torch.all(same[sure])):
            raise AssertionError(f"serve check step {step}: greedy tokens "
                                 "differ where the margin is clear")
        checked += int(sure.sum())
        agree += int(same.sum())
        if step < steps:
            cl, cc = L.lm_decode_step(params, cfg, tok, cc)
            gl, gc = L.lm_decode_step(gparams, cfg, tok.to(dev), gc)
    log(f"  {cfg.name} x{cfg.num_layers} layers f32, B={batch}, prompt "
        f"{prompt}, {steps} decode steps: card vs CPU logits max abs err "
        f"{worst:.3e} (tol {atol:g}); greedy tokens equal {agree} of "
        f"{batch * (steps + 1)} ({checked} with a clear margin)")
    del gparams
    torch.cuda.empty_cache()
    return worst

# ---------------------------------------------------------------- main --

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import cuda
    from repro_torch.kernels import robust_aggregate as kra

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = smi_name_power()
    bw, f32_rate, bf16_rate = card_rates(kind)
    log(f"card: {kind} ({smi}); torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; peaks used for bounds: {bw / 1e12:.2f} TB/s,"
        f" {f32_rate / 1e12:.0f} TFLOP/s f32, {bf16_rate / 1e12:.0f} TFLOP/s "
        f"bf16 tensor")

    log("phase 1: build")
    t0 = time.perf_counter()
    built = cuda.build()
    log(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    OUT.mkdir(parents=True, exist_ok=True)
    for name, (secs, out) in sorted(built.items()):
        (OUT / f"build_{name}.log").write_text(out)
        log(f"  {name}: {secs:.1f} s")
        for fn, props in ptxas_summary(out):
            log(f"    {fn}: {props}")

    log("phase 2: the main path at paper width (greedy_data x3, fednova x2)")
    world = paper_world(dev)
    torch.cuda.reset_peak_memory_stats()
    launches, shapes, records, engines = drive_path(dev, world)
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak device memory {peak / 2**20:.1f} MiB")
    extra = staging_and_profile(dev, engines)

    log("phase 3: the threat path at paper width (byzantine + greedy_data "
        "trimmed mean x3, byzantine + fedavg median x2, stragglers + "
        "fednova median x2)")
    torch.cuda.reset_peak_memory_stats()
    t_launches, t_shapes, t_records, t_engines = drive_threat_path(dev,
                                                                   world)
    t_peak = torch.cuda.max_memory_allocated()
    log(f"  peak device memory {t_peak / 2**20:.1f} MiB")
    scenario, strategy, mode, eng, state, ues = t_engines[0]
    t_profile = profile_round(f"{scenario} + {strategy} {mode}", eng,
                              state, ues)

    log("phase 3b: the mesh path at paper width (Engine(executor="
        "MeshExecutor()): greedy_data x3, fednova x2)")
    m_launches, m_shapes, m_records, m_engines = drive_mesh_path(dev, world)
    m_peak = max(r["peak_device_bytes"] for r in m_records)
    log(f"  peak device memory {m_peak / 2**20:.1f} MiB")
    strategy, eng, state, ues = m_engines[0]
    m_profile = profile_round(f"mesh {strategy}", eng, state, ues)

    log("phase 3c: the tree-level kernel ops on the paper classifier's "
        "tree (f32, bf16 leaves)")
    a_launches, a_shapes, a_checks = drive_api_path(dev, world)

    log("phase 6: serve starcoder2-15b at full width and depth (bf16, "
        "random weights): 8 x 512-token prompts, then 2 x 4096 (rolling "
        "window), 32 tokens each, cache 4096")
    s_launches, s_shapes, s_records, s_profile, s_init = drive_serve_path(
        dev)

    log("phase 7: cefl through the front door (repro_torch.experiments.run):"
        " paper_table1 at paper width cut to 4 rounds and one seed, "
        "quickstart whole (8 rounds)")
    c_launches, c_shapes, c_records, c_contexts, c_estimate = \
        drive_cefl_path(dev)
    c_check = cefl_solve_check(dev, c_contexts["paper_table1"])

    log(f"phase 4: kernels vs plain versions at the paths' shapes and extra "
        f"cases ({smi})")
    timer = Timer(dev)
    # each kernel at every shape any path launched it with
    checked = {"fedprox_accum": shapes["fedprox_accum"]
               + t_shapes["fedprox_accum"] + m_shapes["fedprox_accum"]
               + c_shapes["fedprox_accum"],
               "nova_aggregate": shapes["nova_aggregate"]
               + a_shapes["nova_aggregate"] + c_shapes["nova_aggregate"]}
    rows, main_rows = kernel_checks(dev, timer, bw, f32_rate, checked)
    r_rows, main_rows["robust_aggregate"] = robust_checks(
        dev, timer, bw, f32_rate, t_shapes["robust_aggregate"])
    crossover, network_faster = robust_crossover(dev, timer)
    s_rows, main_rows["nova_aggregate_stacked"] = stacked_checks(
        dev, timer, bw, f32_rate, m_shapes["nova_aggregate_stacked"])
    u_rows, main_rows["fedprox_update"] = update_checks(
        dev, timer, bw, f32_rate, a_shapes["fedprox_update"])
    w_rows, main_rows["swa_decode_attention"] = swa_checks(
        dev, timer, bw, f32_rate, bf16_rate, s_shapes)
    rows += r_rows + s_rows + u_rows + w_rows
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} kernel case(s) disagree with the "
                             f"plain version: {bad}")
    log("  the main rows timed again as runs of 200 launches between one "
        "event pair (inputs rotated over copies past 2 x L2), beside the "
        "per-call timer's floor")
    run_ms, floor = run_column(dev, main_rows, timer, RunTimer())
    del timer

    log("phase 5: one fused round and one mesh round, card vs CPU; "
        "starcoder2-15b at full width, 2 layers, f32, card vs CPU")
    round_err = reference_check(dev, world)
    mesh_err = mesh_reference_check(dev, m_engines)
    serve_err = serve_reference_check(dev)

    kernels = []
    for name in REPLACES:
        r = main_rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": REPLACES[name][0],
            "replaces": REPLACES[name][1],
            "launches": sum(c.get(name, 0) for c in (
                launches, t_launches, m_launches, a_launches, s_launches,
                c_launches)),
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "result.json").write_text(json.dumps({
        "card": smi, "kind": kind, "torch": torch.__version__,
        "cuda": torch.version.cuda, "kernel_rows": rows,
        "rounds": records, "peak_device_bytes": peak,
        "path_launch_shapes": {k: [list(key) + [n] for key, n in c.items()]
                               for k, c in shapes.items()},
        "threat_rounds": t_records, "threat_peak_device_bytes": t_peak,
        "threat_launches": t_launches, "threat_profile": t_profile,
        "threat_launch_shapes": {k: [list(key) + [n] for key, n in c.items()]
                                 for k, c in t_shapes.items()},
        "round_check_max_abs_err": round_err, "staging_profile": extra,
        "robust_crossover": {"network_max": kra.NETWORK_MAX,
                             "network_faster_up_to": network_faster,
                             "times": crossover},
        "mesh_rounds": m_records, "mesh_launches": m_launches,
        "mesh_launch_shapes": {k: [list(key) + [n] for key, n in c.items()]
                               for k, c in m_shapes.items()},
        "mesh_profile": m_profile, "mesh_round_check_max_abs_err": mesh_err,
        "api_launches": a_launches, "api_checks": a_checks,
        "serve_init": s_init, "serve_runs": s_records,
        "serve_launches": s_launches, "serve_decode_profile": s_profile,
        "serve_launch_shapes": [list(key) + [n]
                                for key, n in sorted(s_shapes.items())],
        "serve_check_max_abs_err": serve_err,
        "kernel_run_ms": run_ms, "timer_floor": floor,
        "cefl_rounds": c_records, "cefl_launches": c_launches,
        "cefl_launch_shapes": {k: [list(key) + [n] for key, n in c.items()]
                               for k, c in c_shapes.items()},
        "cefl_estimate_s": c_estimate, "cefl_solve_check": c_check,
        "seconds": time.perf_counter() - t_start}, indent=1, default=str))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
