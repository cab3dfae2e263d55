#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of CE-FL (``src/repro_torch``) on one NVIDIA
card and check it: the CE-FL rounds, the front door with the ``cefl``
strategy, multi-seed sweeps with resume, cohorts, the scenario fuzzer,
the LM serving path, CE-FL training of mamba2-130m and whisper-medium,
serving of the MoE and hybrid models, the sharded plane on rank meshes,
and the five examples with the runtime sanitizer.

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
8. sweeps  — (runs after 7) ``repro_torch.experiments.sweep``:
             ``paper_table1`` at paper width, seeds 0, 1, 2 cut to 4
             rounds, with the vmap executor (one ``fedprox_accum`` launch
             per cross-run DPU group and step, per-DPU anchors) and then
             the sequential one: the run structure (plans, aggregators,
             dc_points, handovers, active UEs, energy, delay) must be
             identical, params / losses / accuracy bit for bit or within
             rtol 1e-6; each sequential seed bit for bit
             ``experiments.run``'s.  Per round: plan / device seconds and
             launches against the groups; the sweep's wall time against
             three solo runs.  Kill and resume of ``sweep_smoke``
             (campus_walk, 4 rounds) and of the paper_table1 sweep
             (stopped after round 2 into a checkpoint, resumed; bit for
             bit; checkpoint bytes, write / read seconds).  The cohort
             threat path: paper_table1's world at 100 UEs, 72 drawn a
             round, ``byzantine`` under ``greedy_data``, trimmed mean x3
             and median x2: every round one ``robust_aggregate`` launch
             over n > 64 DPUs (the radix select) and no
             ``nova_aggregate``; every stack held against the plain
             version and the select timed at the path's n.  A ``cefl``
             cohort run (10 UEs drawn, 2 rounds).  Two draws of the
             scenario fuzzer.  Counters set to 0 before, read after.
9. lm      — (runs after 8) mamba2-130m (arXiv:2405.21060, 128,983,488
             parameters, a (126,080, 1024) f32 plane): (a) served at full
             width and depth in bf16 through ``repro_torch.serve`` (8 x
             512-token prompts, 32 tokens; no kernel launches: a Mamba
             layer steps its state in plain torch); (b) 2 layers at full
             width in f32, card against CPU: prefill and 4 decode steps,
             one plane-form LM round (seq 128, 2 DPUs, gammas (2, 1));
             (c) ``lm_smoke`` whole (20 rounds) and (d) ``lm_mamba2_130m``
             at full width and depth cut to 6 of its 200 rounds (batch 8,
             seq 512, 2 DPUs, gamma 2) through ``experiments.run``, every
             round ``fedprox_accum`` gamma times and
             ``nova_aggregate_stacked`` once (counters set to 0 just
             before each run and read just after), every loss finite and
             the last below the first; seconds per round, training
             tokens/s, peak memory and a profiled round; (e) both kernels
             at every shape (c) and (d) launched against their plain
             versions, timed per call and, at the LM plane, as a run of
             200 launches.
10. moe     — (runs after 9) (a) jamba-v0.1-52b (arXiv:2403.19887) at
             full width in bf16, 16 of its 32 layers (2 of 4 periods:
             14 Mamba-2, 2 attention, 8 MoE top-2 of 16; 52.0 GB), and
             (b) llama4-maverick-400b-a17b at full width, one period (a
             dense layer and a 128-expert top-1 layer with its shared
             expert; 37.1 GB), each served through ``repro_torch.serve``
             (8 x 512-token prompts, 32 and 4 tokens, cache 1024; the
             MoE routings recorded, prefill's capacity drops reported),
             counters set to 0 just before and read just after each run:
             ``swa_decode_attention`` once per attention layer and step;
             (c) whisper-medium (arXiv:2212.04356) at full width and depth
             trained through ``launch.train`` (2 DPUs, batch 8 x seq 256
             + 1,500 encoder frames, gamma 2, eta 3e-3, 3 rounds; per
             round ``fedprox_accum`` gamma times and
             ``nova_aggregate_stacked`` once; losses finite and falling),
             a profiled round, then served (8 x 64, 32 tokens: self- and
             cross-attention through the kernel); (d) the flash backward
             at starcoder2-15b's attention shape (S 6144 past the 4096
             window, Hq 48, Hkv 4, D 128, f32) against autograd through
             a naive masked attention; (e) jamba, llama4, arctic, qwen3
             and whisper at their reduced size in f32, card vs CPU:
             prefill and decode logits and one LM round, after checking
             that every MoE routing agrees.  Phase 4 holds each kernel
             against its plain version at every shape phase 10 launched.
11. mesh   — (runs after 10) the sharded parameter plane on ('dpu',
             'rows') rank meshes (``repro_torch.sharding``), spawned with
             ``run_spmd`` after phase 1 built the kernels, so the ranks
             only load them: mesh (1, 1) over a one-rank NCCL group, and
             (2, 1), (1, 2), (2, 2), (4, 1) over a gloo group of 4 ranks
             whose CUDA tensors all lie on this card (NCCL refuses two
             ranks on one device).  (a) The three sharded ops at the paper
             plane (R 176; G 25, which degrades the 'dpu' axis, and G 20)
             and mamba2-130m's LM plane (R 126,080, G 4): exact mode,
             both robust modes and fedprox_accum bitwise against the
             single-device kernels, psum within rtol = atol = 1e-6, every
             rank's launches counted (one launch a call; two for psum
             where 'dpu' splits), the single-device kernels against their
             plain versions to phase 4's bounds.  (b) The engine at paper
             width (phase 2's world and classifier) under ``fednova``, 3
             rounds, at mesh_shape (1, 1), (2, 2), (4, 1), against the
             single-device card run: arrivals N(1500, 100) put every
             UE's mini-batch in one bucket, so the 20 live DPUs form one
             group and every round runs the sharded fused round (the
             counter must equal the rounds); bitwise or within rtol 1e-6,
             printed.  (c) ``MeshExecutor(mesh_shape=(2, 2))``, phase 3b's
             fednova rounds cut to 2, allclose (atol 1e-5) to the
             single-device mesh round.  (d) The sequence-sharded decode at
             starcoder2-15b's attention shape (Hq 48, Hkv 4, D 128, bf16,
             B 2, S 16,384 over the 4 ranks) against the plain version's
             f32 result (one bf16 ulp, or 8 f32 ulps of the largest |v|)
             and the single-device kernel; one ``lm_decode_step`` with
             ``ctx`` on starcoder2-15b cut to 2 layers at full width
             (f32, prompt 1536, cache 4096 rows split 4 ways), 4 steps,
             logits within 5e-4 of the single-device kernel path.  Times
             are recorded but are no scaling figure: the ranks share one
             card and gloo stages through host memory.
12. examples — (runs after 11) the five examples of
             ``repro_torch.examples`` through their ``main(argv)`` in this
             process, the counters set to 0 just before each call and read
             just after: (a) quickstart whole, and once as ``python -m
             repro_torch.examples.quickstart``; (b) the front door's
             ``run quickstart --set sanitize=true`` (finite every round),
             the same run through ``experiments.run`` under
             ``engine.sanitize``, equal to (a) bit for bit with (a)'s
             launches, then with ``engine.eta=1e12``, which must raise
             ``SanitizerError``; (c) ``cefl_vs_baselines --full --rounds
             3`` (20/10/5, 28x28); (d) ``mobility_demo`` whole (a
             migration and a handover under cefl, none under fixed:0);
             each CE-FL example must launch ``fedprox_accum`` and
             ``nova_aggregate``; (e) ``serve_lm --arch codeqwen1.5-7b`` at
             full width and depth in f32 (32.8 GB), exactly 32 x 15
             ``swa_decode_attention`` launches and no other kernel, its
             launch shapes (f32, G 1, D 128) checked and timed in phase 4
             with both timers beside SDPA; (f) ``train_lm_cefl --full
             --steps 3`` (mamba2-130m) from a temporary working directory:
             ``fedprox_accum`` twice and ``nova_aggregate_stacked`` once a
             round, losses finite and falling, the checkpoint written.
             The round kernels' launch shapes of (a)-(d) and (f) are
             recorded and checked in phase 4 with the other paths'.
4. kernels — each hand-written kernel against its plain PyTorch version on
             the same card tensors, at every shape the paths launched it
             with and at extra cases, with the tolerance stated below
             (signed-zero stacks at n = 5, 25, 64 compared by sign;
             ``nova_aggregate`` and its stacked form at 1, 64 and 100
             DPUs, whose copies wrap the kernel's ring inside a tile, and
             at 12,289 and 20,000; every stacked row bit for bit equal to
             the one-plane kernel); then each is timed with CUDA events
             (median of 30 launches, L2 flushed before each) beside its
             plain version, its bound and a one-call PyTorch yardstick
             where one exists; ``nova_aggregate``'s launch plan is timed
             against its neighbours (another tile, other bytes in flight,
             other blocks an SM); ``robust_aggregate``'s network and
             radix select are timed against each other at n = 33-100 (the
             crossover), and ``swa_decode_attention`` must show one
             kernel per call.
             The kernels line reports the largest group the paths
             launched.  Each kernel's main row is timed a second way, as
             a run of 200 launches between one event pair (``RunTimer``),
             beside an empty kernel under both timers (so is
             ``nova_aggregate`` at (25, 176) bf16 and (5, 176), and the
             stacked form at whisper-medium's plane); every timed row is
             printed again above that floor, beside its bound.
5. check   — one fused round and one mesh round at paper width on the card
             against the same staged round on the CPU (plain versions),
             to the stated tolerance; starcoder2-15b at full width with 2
             layers in f32, prefill and 8 decode steps, card against CPU.
13. nano   — (runs before 4) the drop-free MoE's grouped kernels
             (``csrc/grouped_mm.cu``) at the Nemotron-H cell's expert
             layer: 8,192 tokens, d 2,688, 16 held of 128 relu² experts of
             1,856, top-6.  One forward and backward of
             ``moe.dropless_forward`` under sync debug mode "error", the
             kernels' launches counted from 0 (4 products, 2 weight
             gradients); each product at the layer's routing against the
             plain version on the CPU and the up kernel's count of rows
             written against the held pairs; each timed beside its bound
             (2·P·K·N at the f32 FMA rate), the plain loop on the card
             and ``torch.bmm`` over equal segments.
             ``python3 chip_smoke.py --phase 13`` runs it alone.

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

# The shape of each kernel's row in the kernels line, fixed so the row's
# series keeps its meaning as paths are added: the paper world's 25 DPUs
# at the classifier's R = 176 plane (fedprox_accum in the mesh path's
# per-DPU-anchor form).  A path must launch it; the other path shapes are
# rows of result.json's kernel_rows.
MAIN_SHAPES = {"fedprox_accum": (25, 176, "per_dpu"),
               "nova_aggregate": (25, 176)}

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
        check=True)
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


# nova_aggregate's rows beside its main row that also take the run-of-200
# column: (n, R, dtype)
NOVA_RUN_ROWS = [(25, 176, "bfloat16"), (5, 176, "float32")]


def run_column(dev, main_rows, timer, run_timer, rows=()):
    """The second time column of the kernels' main rows (``RunTimer``), at
    each row's shape on fresh random inputs, and of the ``NOVA_RUN_ROWS``
    rows of ``rows`` (set as their ``run_ms``), and the floor of both
    timers: an empty kernel (``torch.cuda._sleep(0)``) under each.
    Returns {kernel: ms per launch} and the floors."""
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
    for r in rows:
        if r["kernel"] == "nova_aggregate" and "ms" in r and (
                r["G"], r["R"], r["dtype"]) in NOVA_RUN_ROWS:
            n, R, dt = r["G"], r["R"], getattr(torch, r["dtype"])
            w = torch.rand(n, generator=gen, device=dev) + 0.1
            w = w / w.sum()
            r["run_ms"] = run_timer(
                lambda x, d, w=w: kna.nova_aggregate(x, d, w, 0.2),
                lambda n=n, R=R, dt=dt: (randn((R, LANE), dt),
                                         randn((n, R, LANE), dt)),
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


def above_floor(rows, floor):
    """Each timed row's time above the empty kernel, per call and (where
    the row has a run-of-200 time) per launch, beside its bound: derived
    from the two timers' readings, which it leaves as they are.  Logs one
    line a row and returns them as (kernel, G/n, R, dtype, form, ms
    above, run ms above or None, bound ms)."""
    out = []
    for r in rows:
        if "ms" not in r:
            continue
        run = r.get("run_ms")
        out.append((r["kernel"], r["G"], r["R"], r["dtype"], r["anchor"],
                    r["ms"] - floor["empty_kernel_ms"],
                    None if run is None
                    else run - floor["empty_kernel_run_ms"], r["bound_ms"]))
    for name, G, R, dt, anchor, ms, run, bound in out:
        log(f"    {name:<22} G/n={G:<5} R={R:<6} {dt:<8} {anchor:<16} "
            f"above floor: per call {ms * 1e3:8.2f} us, run of 200 "
            + ("       -" if run is None else f"{run * 1e3:8.2f}")
            + f" us; bound {bound * 1e3:8.2f} us")
    return out


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
    kernel, the row of its ``MAIN_SHAPES`` shape."""
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
        if on_path and (G, R, anc) == MAIN_SHAPES["fedprox_accum"]:
            main["fedprox_accum"] = row
        rows.append(row)
        log(f"  {_fmt(row)}")

    # nova_aggregate: the path's (n, R), then n in {1, 5, 25, 64, 100} DPUs
    # at R = 176, f32 and bf16, plus the edge rows, and n = 12,289 and
    # 20,000 at R = 8
    # (0.4 and 0.65 GB of d).  Tolerance: two f32 ulps of the
    # largest x plus theta*eta * n ulps of the largest d (the kernel sums
    # the n terms in order with FMAs, the plain einsum in cuBLAS's order).
    path = path_shapes["nova_aggregate"]
    cases = [(n, R, f32, c) for (n, R), c in sorted(path.items())]
    cases += [(n, 176, dt, 0) for n in (5, 25)
              for dt in (f32, torch.bfloat16)]
    cases += [(5, R, dt, 0) for R in (24, 40)
              for dt in (f32, torch.bfloat16)]
    # one DPU, and 64 and 100 DPUs, whose copies wrap the kernel's ring
    # inside a tile
    cases += [(n, 176, dt, 0) for n in (1, 64, 100)
              for dt in (f32, torch.bfloat16)]
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
        if on_path and (n, R) == MAIN_SHAPES["nova_aggregate"]:
            main["nova_aggregate"] = row
        rows.append(row)
        log(f"  {_fmt(row)}")
        del d
    for name, shape in MAIN_SHAPES.items():
        if name not in main:
            raise AssertionError(f"{name}: no path launched the kernels "
                                 f"line's shape {shape}")
    return rows, main


def stacked_checks(dev, timer, bw, f32_rate, path):
    """``nova_aggregate_stacked`` against its plain version at every (n, R)
    the mesh path launched it with (``path``: {(n, R): launches}, f32,
    rows of x that differ), and at n in {1, 5, 64, 100} for R = 176 (64
    and 100 wrap the kernel's ring inside a tile) and n = 5 for the edge
    rows 24 and 40, f32 and bf16, and n = 12,289 and 20,000 at R = 8
    (past the old cap).  Tolerance, as for
    ``nova_aggregate``: two f32 ulps of the largest |x| plus theta_eta * n
    ulps of the largest |d|.  Every row j must equal ``nova_aggregate``
    (the one-plane kernel) on x[j] bit for bit, or the case fails; those
    comparison launches come after the counted paths.  Every R = 176 case
    is timed, beside the yardstick ``addmm(x, M, d)`` with M = -theta_eta
    * 1 w^T built before the timing."""
    from repro_torch.kernels import nova_aggregate as kna
    from repro_torch.kernels import ref
    from repro_torch.kernels.plane import LANE

    gen = torch.Generator(device=dev).manual_seed(2468)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(n, R, f32, c) for (n, R), c in sorted(path.items())]
    cases += [(n, 176, dt, 0) for n in (1, 5, 64, 100)
              for dt in (f32, bf16)]
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
        # every row j against the one-plane kernel on x[j], by bits
        idt = torch.int32 if dt == f32 else torch.int16
        differ = torch.zeros((), dtype=torch.int64, device=dev)
        for j in range(n):
            one = kna.nova_aggregate(x[j], d, w, theta_eta)
            differ += (one.view(idt) != k[j].view(idt)).sum()
        torch.cuda.synchronize()
        atol = 2 * _spacing(x) + theta_eta * n * _spacing(d)
        nbytes = x.element_size() * R * LANE * 3 * n
        flops = 4 * n * R * LANE
        row = {"kernel": "nova_aggregate_stacked", "G": n, "R": R,
               "dtype": str(dt).replace("torch.", ""), "anchor": "-",
               "path_launches": on_path, "bytes": nbytes,
               "rows_equal_nova_aggregate": int(differ) == 0,
               **within(k, r, atol)}
        row["ok"] = row["ok"] and row["rows_equal_nova_aggregate"]
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


# The plans nova_plan_sweep holds launch_plan's against: launch_plan's
# keywords, one choice moved at a time.
NOVA_PLAN_VARIANTS = [
    ("plan", {}),
    ("tile 1024", {"tile_elems": 1024}), ("tile 512", {"tile_elems": 512}),
    ("tile 256", {"tile_elems": 256}),
    ("in flight 16 KB", {"in_flight": 16 << 10}),
    ("in flight 64 KB", {"in_flight": 64 << 10}),
    ("in flight 128 KB", {"in_flight": 128 << 10}),
    ("2 blocks an SM", {"blocks_per_sm": 2}),
    ("8 blocks an SM", {"blocks_per_sm": 8}),
]
# (n, R, dtype, stacked): the kernels line's shape in f32 and bf16, the
# stacked form there, and at mamba2-130m's plane
NOVA_PLAN_SHAPES = [(25, 176, "float32", False), (25, 176, "bfloat16", False),
                    (25, 176, "float32", True), (2, 126080, "float32", True)]


def nova_plan_sweep(dev, timer):
    """``nova_aggregate``'s launch plan against its neighbours
    (``NOVA_PLAN_VARIANTS``: another tile, a quarter to four times the
    bytes in flight, 2 or 8 blocks an SM) at ``NOVA_PLAN_SHAPES``, per
    call (``Timer``), each launch through the wrapper's ``_launch`` with
    the variant's plan (no launch counted) and checked equal, bit for bit,
    to the plan's output (no bit depends on the plan).  Returns {shape:
    [(variant, plan, ms)]}."""
    from repro_torch.kernels import nova_aggregate as kna
    from repro_torch.kernels.plane import LANE

    gen = torch.Generator(device=dev).manual_seed(97)
    sms = kna.sm_count(dev)
    out = {}
    for n, R, dt, stacked in NOVA_PLAN_SHAPES:
        dtype = getattr(torch, dt)
        x = torch.randn((n, R, LANE) if stacked else (R, LANE),
                        generator=gen, device=dev).to(dtype)
        d = torch.randn((n, R, LANE), generator=gen, device=dev).to(dtype)
        w = torch.rand(n, generator=gen, device=dev) + 0.1
        w = w / w.sum()
        reps = n if stacked else 1
        want = kna._launch(x, d, w, 0.2, n, reps)
        rows, seen = [], set()
        for label, kw in NOVA_PLAN_VARIANTS:
            plan = kna.launch_plan(n, reps, R, x.element_size(), sms, **kw)
            if plan in seen:
                continue
            seen.add(plan)
            got = kna._launch(x, d, w, 0.2, n, reps, plan)
            if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
                raise AssertionError(f"nova_aggregate plan {plan} changed "
                                     f"bits at {(n, R, dt, stacked)}")
            ms = timer(lambda plan=plan: kna._launch(x, d, w, 0.2, n, reps,
                                                     plan))
            rows.append((label, tuple(plan), ms))
        key = f"n={n} R={R} {dt}" + (" stacked" if stacked else "")
        best = min(ms for _, _, ms in rows)
        log(f"  {key}: " + "; ".join(
            f"{label} {plan[:3]} {ms * 1e3:.2f} us"
            + (" (fastest)" if ms == best else "")
            for label, plan, ms in rows))
        out[key] = rows
        del x, d, want, got
        torch.cuda.empty_cache()
    return out


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
    ``swa_decode_attention`` (attention layers, plus every layer's
    cross-attention in an encoder-decoder) x (gen - 1) times and no
    other kernel (a Mamba-2 config: no launch at all); logits finite,
    tokens in the vocab.  Returns the summed
    launches, the kernel's launch shapes ((B, S, cache_len) -> launches),
    the per-run records, a profiled decode step and the init record."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.plane import tree_paths
    from repro_torch.models import blocks
    from repro_torch.models import lm as L
    from repro_torch.serve import serve

    cfg = cfg or get_config(SERVE_ARCH)
    n_attn = blocks.num_periods(cfg) * sum(
        spec.kind == "A" for spec in blocks.period_spec(cfg))
    # an encoder-decoder's decode step also cross-attends in every layer
    n_cross = cfg.num_layers if cfg.is_encdec else 0
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
        want["swa_decode_attention"] = (n_attn + n_cross) * (gen - 1)
        if launches != want:
            raise AssertionError(f"serve {label}: launches {launches} != "
                                 f"{want}")
        S = min(window, cache_len)
        for pos in range(P, P + gen - 1):
            if n_attn:
                shapes[(B, S, min(pos + 1, S))] += n_attn
            if n_cross:
                shapes[(B, cfg.encoder_seq, cfg.encoder_seq)] += n_cross
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
    from repro_torch.serve import encoder_frames

    prompts = torch.from_numpy(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (B, P))).to(dev)
    enc = encoder_frames(cfg, B, 2, params["embed"].dtype, dev) \
        if cfg.is_encdec else None
    logits, cache = L.prefill(params, cfg, prompts, cache_len,
                              enc_embed=enc)
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
               D=128, cases=None, run_timer=None):
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
    row of the main path's shape (the 8 x 512 run's first step).
    ``cases``: (B, Hq, Hkv, D, S, cache_len, dtype, launches) rows to
    check instead (phase 10's and 12's path shapes); then there is no main
    row.  ``run_timer``: a :class:`RunTimer` that also times each row as
    a run of 200 launches (``run_ms``)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels import swa_decode_attention as kswa

    gen = torch.Generator(device=dev).manual_seed(9876)
    main_key = None
    if cases is None:
        firsts = {}
        for B, S, cl in sorted(path):
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
        if run_timer is not None:
            row["run_ms"] = run_timer(
                lambda q_, k_, v_: kswa.swa_decode_attention(q_, k_, v_, cl),
                lambda: tuple(torch.randn(t.shape, generator=gen, device=dev)
                              .to(dt) for t in (q, k, v)), nbytes)
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
    """``cfg`` (default: starcoder2-15b at full width with ``layers``
    layers), float32, TF32 off: the same weights (made on the CPU from a
    seed) and prompts on the card (the kernels) and on the CPU (plain
    versions), prefill and ``steps`` decode steps, each step fed the
    CPU's greedy token (an encoder-decoder encodes the same seeded
    frames on both).
    Tolerance on the logits: ``atol`` (5e-4 against logits of order 2:
    products of depth up to 24,576 summed in cuBLAS's and the CPU BLAS's
    orders through two layers, and the kernel's summation order).  The
    card's greedy token must equal the CPU's wherever the CPU's top-2
    logit margin exceeds 2 * atol.  Returns the largest logit error."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.plane import tree_map
    from repro_torch.models import lm as L
    from repro_torch.serve import encoder_frames

    cfg = cfg or dataclasses.replace(get_config(SERVE_ARCH),
                                     num_layers=layers)
    params = L.init_lm_params(torch.Generator().manual_seed(11), cfg,
                              torch.float32)
    gparams = tree_map(lambda t: t.to(dev), params)
    prompts = torch.from_numpy(np.random.RandomState(12).randint(
        0, cfg.vocab_size, (batch, prompt)))
    enc = encoder_frames(cfg, batch, 12, torch.float32, "cpu") \
        if cfg.is_encdec else None
    worst, checked, agree = 0.0, 0, 0
    cl, cc = L.prefill(params, cfg, prompts, SERVE_CACHE, enc_embed=enc)
    gl, gc = L.prefill(gparams, cfg, prompts.to(dev), SERVE_CACHE,
                       enc_embed=None if enc is None else enc.to(dev))
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

# ------------------------------------- phase 8: sweeps, resume, cohorts --

# The paper_table1 sweep: the Tables I-II preset's three seeds at paper
# width, cut to 4 rounds as in phase 7 (rounds 0 and 3 re-solve).
SWEEP_OVER = {"engine.rounds": 4, "seeds": (0, 1, 2)}
# The cohort threat path: paper_table1's world grown to 100 UEs, 72 drawn
# per round, so a round's robust reduce sees 72 UEs + 5 DCs (> 64: the
# radix select).  Fixed constants: greedy_data reads none, and the
# estimation over 100 probe UEs would only add set-up time.
COHORT_THREAT_OVER = {"network.num_ue": 100, "engine.cohort_size": 72,
                      "scenario": "byzantine", "strategy": "greedy_data",
                      "consts.mode": "fixed", "seeds": (0,),
                      "engine.trim_frac": TRIM_FRAC}
COHORT_THREAT_RUNS = [("trimmed_mean", 3), ("median", 2)]
# The cefl cohort run: the SCA solve on a 10-UE subnetwork of paper_table1
COHORT_CEFL_OVER = {"engine.cohort_size": 10, "engine.rounds": 2,
                    "seeds": (0,)}
# vmap against sequential: params, losses and accuracy within this of the
# sequential executor's (the cross-run group's bmm batch count differs
# from a run's own, and cuBLAS may pick its algorithm by batch count)
SWEEP_RTOL = 1e-6


def _identical(a, b) -> bool:
    """Two RunResults bit for bit: every report field but the wall time,
    the plans, and the final params."""
    if len(a) != len(b):
        return False
    for ra, rb in zip(a.reports, b.reports):
        for f in ("round", "acc", "loss", "energy", "delay", "cum_energy",
                  "cum_delay", "aggregator", "dc_points", "gamma_mean",
                  "m_mean", "handovers", "aggregator_moved", "active_ues"):
            if getattr(ra, f) != getattr(rb, f):
                return False
        wa, wb = ra.plan.to_w(), rb.plan.to_w()
        if any(not torch.equal(wa[k], wb[k]) for k in wa):
            return False
    return all(torch.equal(a.params[k], b.params[k]) for k in a.params)


def sweep_parity(vm, seq) -> dict:
    """The parity contract between the two executors' results: the run
    structure (plans, aggregators, dc_points, handovers, active UEs,
    energy, delay) exact; params, losses and accuracy bit for bit or
    within ``SWEEP_RTOL`` (losses and accuracy relative, params by the
    largest |param| of each leaf).  Raises on a miss."""
    out = {"exact": True, "loss_rel": 0.0, "acc_rel": 0.0,
           "params_rel": 0.0}
    for (key, a), (_, b) in zip(vm.runs, seq.runs):
        for ra, rb in zip(a.reports, b.reports):
            for f in ("round", "aggregator", "dc_points", "handovers",
                      "active_ues", "energy", "delay", "cum_energy",
                      "cum_delay", "gamma_mean", "m_mean"):
                if getattr(ra, f) != getattr(rb, f):
                    raise AssertionError(f"sweep seed {key.seed} round "
                                         f"{ra.round}: {f} differs")
            wa, wb = ra.plan.to_w(), rb.plan.to_w()
            for k in wa:
                if not torch.equal(wa[k], wb[k]):
                    raise AssertionError(f"sweep seed {key.seed} round "
                                         f"{ra.round}: plan {k} differs")
            for f in ("loss", "acc"):
                x, y = getattr(ra, f), getattr(rb, f)
                rel = abs(x - y) / max(abs(y), 1e-30)
                out[f"{f}_rel"] = max(out[f"{f}_rel"], rel)
        for k in a.params:
            err = float((a.params[k] - b.params[k]).abs().max())
            scale = float(b.params[k].abs().max())
            out["params_rel"] = max(out["params_rel"], err / scale)
    out["exact"] = all(_identical(a, b)
                       for (_, a), (_, b) in zip(vm.runs, seq.runs))
    worst = max(out["loss_rel"], out["acc_rel"], out["params_rel"])
    if worst > SWEEP_RTOL:
        raise AssertionError(f"vmap vs sequential sweep: {out} beyond "
                             f"rtol {SWEEP_RTOL}")
    return out


class _ShapeRecorder:
    """Wraps the kernel wrappers for the length of a ``with`` block and
    counts the shapes they launched with: fedprox_accum (G, R, anchor
    form), nova_aggregate and nova_aggregate_stacked (n, R), and every
    robust_aggregate stack kept (with its inputs and output) for the
    check against the plain version."""

    def __init__(self):
        self.shapes = {"fedprox_accum": Counter(),
                       "nova_aggregate": Counter(),
                       "nova_aggregate_stacked": Counter()}
        self.robust = []

    def __enter__(self):
        from repro_torch.kernels import fedprox_update as kfp
        from repro_torch.kernels import nova_aggregate as kna
        from repro_torch.kernels import robust_aggregate as kra
        self._mods = (kfp, kna, kra)
        self._real = (kfp.fedprox_accum, kna.nova_aggregate,
                      kra.robust_aggregate, kna.nova_aggregate_stacked)
        real_fp, real_na, real_ra, real_ns = self._real

        def fedprox_accum(x, g, anchor, *a):
            form = "per_dpu" if anchor.dim() == 3 else "shared"
            self.shapes["fedprox_accum"][(x.shape[0], x.shape[1],
                                          form)] += 1
            return real_fp(x, g, anchor, *a)

        def nova_aggregate(x, d, *a):
            self.shapes["nova_aggregate"][(d.shape[0], d.shape[1])] += 1
            return real_na(x, d, *a)

        def nova_aggregate_stacked(x, d, *a):
            self.shapes["nova_aggregate_stacked"][(d.shape[0],
                                                   d.shape[1])] += 1
            return real_ns(x, d, *a)

        def robust_aggregate(x, d, theta_eta, *, k=0, median=False):
            out = real_ra(x, d, theta_eta, k=k, median=median)
            self.robust.append((x.clone(), d.clone(), theta_eta, k, median,
                                out.clone()))
            return out

        kfp.fedprox_accum = fedprox_accum
        kna.nova_aggregate = nova_aggregate
        kna.nova_aggregate_stacked = nova_aggregate_stacked
        kra.robust_aggregate = robust_aggregate
        return self

    def __exit__(self, *exc):
        kfp, kna, kra = self._mods
        (kfp.fedprox_accum, kna.nova_aggregate, kra.robust_aggregate,
         kna.nova_aggregate_stacked) = self._real


def _want_launches(groups_per_run, union: bool) -> int:
    """fedprox_accum launches of one sweep round: gamma per DPU group,
    per run (sequential) or per cross-run group (vmap)."""
    if union:
        keys = set().union(*[set(g) for g in groups_per_run])
        return sum(gamma for gamma, _m, _b in keys)
    return sum(gamma for g in groups_per_run for gamma, _m, _b in g)


def drive_sweep_path(dev):
    """Phase 8, part 1-2: the paper_table1 sweep through
    ``experiments.sweep`` with the vmap and then the sequential executor,
    held to the parity contract; three solo ``experiments.run``s, each
    bit for bit the sequential sweep's seed; then kill and resume
    (``stop_after=2`` into a checkpoint, ``resume=True``) of sweep_smoke
    (campus_walk, 4 rounds) and of the paper_table1 sweep, bit for bit
    against the uninterrupted vmap sweeps (paper_table1's round 3
    re-solves from the restored warm-start plan: one SCA solve per seed
    on resume).  Per sweep round: plan seconds (every run's begin_round),
    device seconds, fedprox_accum launches against the groups."""
    import importlib
    import tempfile
    from repro_torch import experiments
    from repro_torch.core.engine import Engine, dpu_groups, live_dpus
    from repro_torch.experiments import runstate
    from repro_torch.kernels import ops
    from repro_torch.solver import sca
    sw = importlib.import_module("repro_torch.experiments.sweep")

    records, cur = [], {"plan": 0.0}
    ck_times = {"save": [], "load": []}
    solves = []
    real = {"begin": Engine.begin_round,
            "save": runstate.save_sweep_state,
            "load": runstate.load_sweep_state, "solve": sca.solve,
            sw.SequentialSweepExecutor: sw.SequentialSweepExecutor
            ._device_phase,
            sw.VmapSweepExecutor: sw.VmapSweepExecutor._device_phase}

    def begin_round(self, state, ues):
        t0 = time.perf_counter()
        out = real["begin"](self, state, ues)
        cur["plan"] += time.perf_counter() - t0
        return out

    def wrap_phase(cls):
        def phase(self, ctx, active, staged):
            before = dict(ops.LAUNCHES)
            groups = [dpu_groups(st.plan, live_dpus(st.datasets))
                      for st in staged]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real[cls](self, ctx, active, staged)
            torch.cuda.synchronize()
            got = {k: ops.LAUNCHES[k] - before[k] for k in before}
            want = _want_launches(groups,
                                  union=self.executor_name == "vmap")
            if got["fedprox_accum"] != want or \
                    got["nova_aggregate"] != len(active):
                raise AssertionError(
                    f"{self.executor_name} sweep round {staged[0].t}: "
                    f"launches {got}, want fedprox_accum {want} and "
                    f"nova_aggregate {len(active)}")
            records.append({
                "spec": ctx.spec.name, "executor": self.executor_name,
                "round": staged[0].t, "runs": len(active),
                "plan_s": cur["plan"],
                "device_s": time.perf_counter() - t0,
                "groups": [[len(v) for v in g.values()] for g in groups],
                "launches": got})
            cur["plan"] = 0.0
        return phase

    def timed(name):
        def fn(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*a, **kw)
            ck_times[name].append(time.perf_counter() - t0)
            return out
        return fn

    def solve(*a, **kw):
        solves.append(1)
        return real["solve"](*a, **kw)

    def sweep(*a, **kw):
        cur["plan"] = 0.0           # a solo run's begin_round is no sweep's
        return experiments.sweep(*a, **kw)

    spec = experiments.get_experiment("paper_table1").override(**SWEEP_OVER)
    smoke = experiments.get_experiment("sweep_smoke").override(
        **{"engine.rounds": 4})
    out = {}
    Engine.begin_round = begin_round
    for cls in (sw.SequentialSweepExecutor, sw.VmapSweepExecutor):
        cls._device_phase = wrap_phase(cls)
    runstate.save_sweep_state = timed("save")
    runstate.load_sweep_state = timed("load")
    sca.solve = solve
    try:
        experiments.build_context(spec, device=dev)    # phase 7's, cached
        results, wall = {}, {}
        for executor in ("vmap", "sequential"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results[executor] = sweep(spec, executor=executor, device=dev)
            torch.cuda.synchronize()
            wall[executor] = time.perf_counter() - t0
        parity = sweep_parity(results["vmap"], results["sequential"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for seed in spec.run_seeds:
            solo = experiments.run(spec, seed=seed, device=dev)
            if not _identical(results["sequential"].result(seed), solo):
                raise AssertionError(f"sequential sweep seed {seed} is not "
                                     "experiments.run's bit for bit")
        torch.cuda.synchronize()
        wall["three_solo_runs"] = time.perf_counter() - t0
        out.update(parity=parity, wall_s=wall,
                   stats=results["vmap"].stats())
        # sweep_smoke (greedy_data: every DPU of a run shares its (gamma,
        # m), so runs' groups merge) both ways: the launch contrast
        smoke_full = sweep(smoke, executor="vmap", device=dev)
        out["smoke_parity"] = sweep_parity(
            smoke_full, sweep(smoke, executor="sequential", device=dev))
        resume = {}
        with tempfile.TemporaryDirectory() as tmp:
            for s, full in ((smoke, smoke_full), (spec, results["vmap"])):
                ck = Path(tmp) / s.name
                n_save = len(ck_times["save"])
                part = sweep(s, executor="vmap", device=dev,
                             checkpoint_dir=ck, stop_after=2)
                nbytes = sum(f.stat().st_size for f in ck.iterdir())
                n0 = len(solves)
                res = sweep(s, executor="vmap", device=dev,
                            checkpoint_dir=ck, resume=True)
                for seed in s.run_seeds:
                    if len(part.result(seed)) != 2 or not _identical(
                            res.result(seed), full.result(seed)):
                        raise AssertionError(f"{s.name} seed {seed}: kill "
                                             "and resume is not the "
                                             "uninterrupted sweep")
                resume[s.name] = {
                    "checkpoint_bytes": nbytes,
                    "write_s": ck_times["save"][n_save],
                    "read_s": ck_times["load"][-1],
                    "solves_on_resume": len(solves) - n0}
        want_solves = len(spec.run_seeds)        # round 3, every seed
        if resume[spec.name]["solves_on_resume"] != want_solves:
            raise AssertionError(f"paper_table1 resume: "
                                 f"{resume[spec.name]['solves_on_resume']}"
                                 f" SCA solves, want {want_solves}")
        out["resume"] = resume
    finally:
        Engine.begin_round = real["begin"]
        for cls in (sw.SequentialSweepExecutor, sw.VmapSweepExecutor):
            cls._device_phase = real[cls]
        runstate.save_sweep_state = real["save"]
        runstate.load_sweep_state = real["load"]
        sca.solve = real["solve"]
    out["rounds"] = records
    for r in records:
        log(f"  {r['spec']:<12} {r['executor']:<10} round {r['round']}: "
            f"plan {r['plan_s']:.3f} s  device {r['device_s']:.3f} s  "
            f"fedprox_accum {r['launches']['fedprox_accum']}  groups "
            f"{r['groups']}")
    for s in (spec, smoke):
        for executor in ("vmap", "sequential"):
            rs = [r for r in records if r["spec"] == s.name
                  and r["executor"] == executor][:s.engine.rounds]
            out[f"{s.name}_{executor}_per_round"] = {
                "plan_s": [r["plan_s"] for r in rs],
                "device_s": [r["device_s"] for r in rs],
                "fedprox_accum": [r["launches"]["fedprox_accum"]
                                  for r in rs]}
    log(f"  paper_table1 sweep of seeds {list(spec.run_seeds)} x "
        f"{spec.engine.rounds} rounds: vmap {wall['vmap']:.3f} s, "
        f"sequential {wall['sequential']:.3f} s, three solo runs "
        f"{wall['three_solo_runs']:.3f} s; vmap vs sequential: exact "
        f"{parity['exact']}, loss rel {parity['loss_rel']:.3g}, acc rel "
        f"{parity['acc_rel']:.3g}, params rel {parity['params_rel']:.3g}")
    log(f"  sweep_smoke vmap vs sequential: {out['smoke_parity']}; "
        f"fedprox_accum per round vmap "
        f"{out['sweep_smoke_vmap_per_round']['fedprox_accum']}, sequential "
        f"{out['sweep_smoke_sequential_per_round']['fedprox_accum']}")
    for name, r in out["resume"].items():
        log(f"  resume {name}: checkpoint {r['checkpoint_bytes']} bytes, "
            f"write {r['write_s']:.4f} s, read {r['read_s']:.4f} s, "
            f"SCA solves on resume {r['solves_on_resume']}; bit for bit")
    return out


def drive_cohort_paths(dev):
    """Phase 8, part 3: the cohort threat path (paper_table1's world at
    100 UEs, 72 drawn per round, byzantine under greedy_data: 3 rounds of
    the trimmed mean, then 2 of the median) and one cefl cohort run
    (paper_table1, 10 UEs drawn, 2 rounds: the SCA solve on the
    subnetwork).  Every threat round launches robust_aggregate once with
    n > 64 and nova_aggregate never; every cefl round nova_aggregate
    once.  Returns the per-round records and the shape recorder (its
    robust stacks go to :func:`cohort_robust_checks`)."""
    from repro_torch import experiments
    from repro_torch.core.engine import dpu_groups, live_dpus
    from repro_torch.kernels import ops
    from repro_torch.kernels import robust_aggregate as kra

    base = experiments.get_experiment("paper_table1")
    records = []

    def drive(spec, want_fn, tag):
        ctx = experiments.build_context(spec, device=dev)
        eng = ctx.make_engine(spec.run_seeds[0])
        ues = ctx.make_ues(spec.run_seeds[0])
        state = eng.init_loop(ues, init_params=ctx.p0, loss_fn=ctx.loss_fn,
                              eval_fn=ctx.eval_fn)
        while state.t < eng.opts.rounds:
            before = dict(ops.LAUNCHES)
            t0 = time.perf_counter()
            staged = eng.begin_round(state, ues)
            t1 = time.perf_counter()
            live = live_dpus(staged.datasets)
            groups = dpu_groups(staged.plan, live)
            mean_loss, acc = eng.execute_round(state, staged)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            rep = eng.finish_round(state, staged, mean_loss, acc)
            got = {k: ops.LAUNCHES[k] - before[k] for k in before}
            want = dict.fromkeys(ops.LAUNCHES, 0)
            want.update(fedprox_accum=sum(g for g, _m, _b in groups),
                        **want_fn(len(live)))
            if got != want:
                raise AssertionError(f"{tag} round {rep.round}: launches "
                                     f"{got} != {want}")
            if len(staged.cohort) != spec.engine.cohort_size:
                raise AssertionError(f"{tag}: cohort {staged.cohort}")
            rep.plan.validate(staged.net_t)
            if not np.isfinite(rep.loss):
                raise AssertionError(f"{tag} round {rep.round}: loss "
                                     f"{rep.loss}")
            r = {"path": tag, "round": rep.round, "n": len(live),
                 "cohort": len(staged.cohort), "plan_s": t1 - t0,
                 "device_s": t2 - t1, "loss": rep.loss, "acc": rep.acc,
                 "aggregator": rep.aggregator, "energy_J": rep.energy,
                 "delay_s": rep.delay, "launches": got}
            records.append(r)
            log(f"  {tag} round {rep.round}: n={r['n']} (cohort "
                f"{r['cohort']})  plan {r['plan_s']:.3f} s  device "
                f"{r['device_s']:.3f} s  loss {rep.loss:.4f}  acc "
                f"{rep.acc:.3f}  aggregator DC{rep.aggregator}  energy "
                f"{rep.energy:.2f} J  launches {got}")

    with _ShapeRecorder() as shapes:
        for mode, rounds in COHORT_THREAT_RUNS:
            spec = base.override(**COHORT_THREAT_OVER).override(
                **{"engine.robust_agg": mode, "engine.rounds": rounds})

            def threat_want(n):
                if n <= kra.NETWORK_MAX:
                    raise AssertionError(f"cohort threat round: n = {n} "
                                         "takes the network, not the "
                                         "radix select")
                return {"robust_aggregate": 1}
            drive(spec, threat_want, f"cohort byzantine {mode}")
        drive(base.override(**COHORT_CEFL_OVER),
              lambda n: {"nova_aggregate": 1}, "cohort cefl")
    return records, shapes


def cohort_robust_checks(stacks, timer, bw, f32_rate):
    """Each robust stack phase 8 launched (the cohort threat path's, then
    the fuzzer's) against the plain version on the same inputs (median
    bitwise in f32; trimmed mean within two ulps of the largest |x| plus
    |theta_eta| * 2m ulps of the largest |d|), and the radix select timed
    at the cohort path's n, per mode (the first stack of each mode above
    the network's 64; after the phase's counters were read: these
    launches are not the path's)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import robust_aggregate as kra
    from repro_torch.kernels.plane import LANE

    checks, timed = [], {}
    for x, d, theta_eta, k, median, got in stacks:
        want = ref.robust_aggregate_ref(x, d, theta_eta, k=k, median=median)
        n = d.shape[0]
        m = (1 if n % 2 else 2) if median else n - 2 * k
        atol = 0.0 if median else (
            2 * _spacing(x) + abs(theta_eta) * 2 * m * _spacing(d))
        c = within(got, want, atol)
        c.update(n=n, k=k, mode="median" if median else "trimmed_mean")
        checks.append(c)
        if not c["ok"]:
            raise AssertionError(f"cohort robust_aggregate n={n}: {c}")
        if c["mode"] not in timed and n > kra.NETWORK_MAX:
            nbytes = 4 * d.shape[1] * LANE * (n + 2)
            flops = robust_operations(n, m, d.shape[1], kra.NETWORK_MAX)
            timed[c["mode"]] = {
                "n": n, "k": k, "R": d.shape[1],
                "ms": timer(lambda: kra.robust_aggregate(
                    x, d, theta_eta, k=k, median=median)),
                "plain_ms": timer(lambda: ref.robust_aggregate_ref(
                    x, d, theta_eta, k=k, median=median)),
                "library_ms": (timer(lambda: torch.median(d, dim=0))
                               if median and n % 2 else None),
                "bound_ms": max(nbytes / bw, flops / f32_rate) * 1e3,
                "max_abs_err": c["max_abs_err"]}
    for mode, t in timed.items():
        log(f"  radix select at the cohort path's n = {t['n']} ({mode}, "
            f"k={t['k']}): {t['ms'] * 1e3:.1f} us per call, plain "
            f"{t['plain_ms'] * 1e3:.1f} us, bound {t['bound_ms'] * 1e3:.1f}"
            f" us" + ("" if t["library_ms"] is None else
                      f", torch.median {t['library_ms'] * 1e3:.1f} us"))
    log(f"  {len(checks)} robust stacks held against the plain version, "
        f"n = {sorted({c['n'] for c in checks})}")
    return checks, timed


def drive_sweep_phase(dev, timer, bw, f32_rate):
    """Phase 8: the sweep path, kill and resume, the cohort paths and two
    fuzzer draws on the card.  The launch counters are set to 0 just
    before and read just after; returns the launch counts, the
    fedprox_accum / nova_aggregate shapes the phase launched (phase 4
    checks each) and the records."""
    from repro_torch.kernels import ops
    from repro_torch.scenario import fuzz

    ops.reset_launches()                       # counts to 0: the phase
    t0 = time.perf_counter()
    with _ShapeRecorder() as sweep_shapes:
        sweep = drive_sweep_path(dev)
    t1 = time.perf_counter()
    cohort, cohort_shapes = drive_cohort_paths(dev)
    t2 = time.perf_counter()
    with _ShapeRecorder() as fuzz_shapes:
        failing = fuzz.run_fuzz(2, 0, str(OUT / "fuzz_out"), device=dev,
                                progress=lambda s: log(f"  {s}"))
    t3 = time.perf_counter()
    launches = dict(ops.LAUNCHES)              # read just after
    if failing:
        raise AssertionError(f"the fuzzer failed draws: {failing}")
    n_threat = sum(r["path"].startswith("cohort byzantine") for r in cohort)
    if len(cohort_shapes.robust) != n_threat:
        raise AssertionError(f"{len(cohort_shapes.robust)} robust stacks "
                             f"for {n_threat} cohort threat rounds")
    stacks = cohort_shapes.robust + fuzz_shapes.robust
    if len(stacks) != launches["robust_aggregate"]:
        raise AssertionError(f"{len(stacks)} robust stacks recorded for "
                             f"{launches['robust_aggregate']} launches")
    robust_checks, radix = cohort_robust_checks(stacks, timer, bw, f32_rate)
    shapes = {name: sweep_shapes.shapes[name] + cohort_shapes.shapes[name]
              + fuzz_shapes.shapes[name] for name in sweep_shapes.shapes}
    log(f"  launches {launches}; seconds: sweeps and resume {t1 - t0:.1f},"
        f" cohorts {t2 - t1:.1f}, fuzzer {t3 - t2:.1f}")
    for name in ("fedprox_accum", "nova_aggregate", "robust_aggregate"):
        if not launches[name]:
            raise AssertionError(f"kernel {name}: no launch in phase 8")
    return launches, shapes, {"sweep": sweep, "cohort": {
        "rounds": cohort, "robust_checks": robust_checks,
        "radix_select": radix}, "fuzz_seconds": t3 - t2,
        "seconds": t3 - t0}


# ----------------------------------------- phase 9: LM training, Mamba --

LM_ARCH = "mamba2-130m"
# (a) serving: (label, requests, prompt tokens); prompts are a multiple of
# the SSD chunk (64)
LM_SERVE_RUNS = [("8 x 512", 8, 512)]
# (b) card vs CPU: a 2-layer full-width f32 mamba2, prefill + 4 decode
# steps, then one plane-form round (seq 128, 2 DPUs, gammas (2, 1))
LM_CHECK = {"layers": 2, "batch": 2, "prompt": 64, "steps": 4, "seq": 128,
            "gammas": (2, 1)}
# (d) lm_mamba2_130m at full width and depth, cut to 6 of its 200 rounds
LM_FULL_OVER = {"engine.rounds": 6}


def lm_reference_check(dev, layers=LM_CHECK["layers"],
                       batch=LM_CHECK["batch"], prompt=LM_CHECK["prompt"],
                       steps=LM_CHECK["steps"], seq=LM_CHECK["seq"],
                       gammas=LM_CHECK["gammas"]):
    """Phase 9 (b): mamba2-130m at full width with ``layers`` layers in
    f32, TF32 off, the same weights (made on the CPU from a seed) on the
    card and on the CPU.  Serving: prefill and ``steps`` decode steps,
    logits to phase 6's ``atol`` 5e-4 (``serve_reference_check``).  One
    plane-form LM round (``experiments.lm.build_lm_step``, ``seq`` tokens,
    2 DPUs with gammas ``gammas``): the card (kernels) against the CPU
    (plain versions), new replica stack to rtol 1e-4, atol 1e-5 and loss
    to rtol 1e-4, as phase 5's rounds.  Returns the errors."""
    from repro_torch.configs import get_config
    from repro_torch.experiments.spec import ModelSpec

    cfg = dataclasses.replace(get_config(LM_ARCH), num_layers=layers)
    serve_err = serve_reference_check(dev, cfg=cfg, batch=batch,
                                      prompt=prompt, steps=steps)
    m = ModelSpec(kind="lm", arch=LM_ARCH, reduced=False, batch=2 * batch,
                  seq=seq, n_dpu=2, n_micro=1, gamma=max(gammas))
    rec = lm_round_card_vs_cpu(dev, cfg, m, gammas)
    return {"serve_logits_max_abs_err": serve_err,
            "round_max_abs_err": rec["max_abs_err"],
            "round_loss": rec["loss"]}


def lm_round_card_vs_cpu(dev, cfg, m, gammas, seed=13):
    """One plane-form LM round (``experiments.lm.build_lm_step`` of ``cfg``
    and the spec ``m``, 2 DPUs with gammas ``gammas``) from the same f32
    weights (made on the CPU from ``seed``) and batch, on the card
    (kernels) and on the CPU (plain versions): the new replica stack to
    rtol 1e-4, atol 1e-5 and the loss to rtol 1e-4, as phase 5's rounds.
    Returns the error, the losses and the plane's rows."""
    from repro_torch.core.round_step import make_dpu_meta
    from repro_torch.experiments import lm as tlm
    from repro_torch.kernels.plane import ParamPlane
    from repro_torch.models import lm as L

    params = L.init_lm_params(torch.Generator().manual_seed(seed), cfg,
                              torch.float32)
    plane = ParamPlane.from_tree(params)
    step = tlm.build_lm_step(cfg, m, eta=3e-2, mu=0.01)
    batch_cpu = tlm.lm_batch(cfg, m, seed + 4, torch.device("cpu"))
    outs = []
    for where in (torch.device("cpu"), dev):
        stack = plane.with_data(plane.broadcast(2).data.to(where)
                                .contiguous())
        meta = make_dpu_meta(2, gammas=list(gammas), device=where)
        new, metrics = step(stack, {k: v.to(where)
                                    for k, v in batch_cpu.items()}, meta)
        outs.append((new.data.cpu(), float(metrics["loss"])))
        del stack, new
    (cn, cl), (gn, gl) = outs
    err = float((gn - cn).abs().max())
    torch.testing.assert_close(gn, cn, rtol=1e-4, atol=1e-5)
    if not (np.isfinite(gl) and abs(gl - cl) <= 1e-4 * abs(cl)):
        raise AssertionError(f"LM round loss {gl} (card) vs {cl} (CPU)")
    R = plane.data.shape[0]
    log(f"  LM round ({cfg.name} x{cfg.num_layers} layers f32, R = {R}, "
        f"seq {m.seq}, gammas {gammas}) card vs CPU: replica stack max "
        f"abs err {err:.3e}, loss {gl:.6f} vs {cl:.6f}")
    del outs, plane, params
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "loss": [gl, cl], "R": R}


class _RoundCounter:
    """Wraps ``experiments.lm.build_lm_step`` for the length of a ``with``
    block: every round step it builds records the launch counts of its
    call (counters before and after) and its host seconds to a
    synchronize."""

    def __init__(self):
        self.rounds = []

    def __enter__(self):
        from repro_torch.experiments import lm as tlm
        from repro_torch.kernels import ops
        self._mod, self._real = tlm, tlm.build_lm_step
        real = self._real

        def build_lm_step(*a, **k):
            step = real(*a, **k)

            def counted(params, batch, meta):
                before = dict(ops.LAUNCHES)
                t0 = time.perf_counter()
                out = step(params, batch, meta)
                torch.cuda.synchronize()
                self.rounds.append({
                    "seconds": time.perf_counter() - t0,
                    "launches": {n: ops.LAUNCHES[n] - before[n]
                                 for n in before}})
                return out
            return counted

        tlm.build_lm_step = build_lm_step
        return self

    def __exit__(self, *exc):
        self._mod.build_lm_step = self._real


def _lm_run(dev, name, over, shapes):
    """One LM preset through ``experiments.run`` (the front door) on the
    card, counters set to 0 just before and read just after.  Every round
    must launch ``fedprox_accum`` gamma times and
    ``nova_aggregate_stacked`` once, and nothing else; every loss finite
    and the last below the first (``run_lm`` raises otherwise)."""
    from repro_torch import experiments
    from repro_torch.experiments.lm import lm_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.plane import spec_of

    spec = experiments.get_experiment(name).override(**over)
    m = spec.model
    cfg = lm_config(m)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                       # counts to 0: the path
    t0 = time.perf_counter()
    with _RoundCounter() as rc, shapes:
        result = experiments.run(spec, device=dev)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)              # read just after
    peak = torch.cuda.max_memory_allocated()
    losses = result.series("loss")
    want = dict.fromkeys(launches, 0)
    want.update(fedprox_accum=m.gamma, nova_aggregate_stacked=1)
    for t, r in enumerate(rc.rounds):
        if r["launches"] != want:
            raise AssertionError(f"{name} round {t}: launches "
                                 f"{r['launches']} != {want}")
    if len(rc.rounds) != spec.engine.rounds:
        raise AssertionError(f"{name}: {len(rc.rounds)} round steps for "
                             f"{spec.engine.rounds} rounds")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{name}: losses {losses}")
    secs = [r["seconds"] for r in rc.rounds]
    per_round = statistics.median(secs[1:])
    tokens = m.batch * m.seq * m.gamma
    flat = spec_of(result.params)
    R = flat.rows
    rec = {"preset": name, "over": over, "arch": cfg.name,
           "params": flat.n, "R": R, "n_dpu": m.n_dpu,
           "batch": m.batch, "seq": m.seq, "gamma": m.gamma,
           "rounds": spec.engine.rounds, "losses": losses,
           "round_s": secs, "round_s_median_after_first": per_round,
           "train_tokens_per_round": tokens,
           "train_tokens_per_s": tokens / per_round, "wall_s": wall,
           "peak_device_bytes": peak, "launches": launches}
    log(f"  {name} ({cfg.name}, {flat.n:,} params, plane R = "
        f"{R}, {m.n_dpu} DPUs, batch {m.batch} x seq {m.seq}, gamma "
        f"{m.gamma}, {spec.engine.rounds} rounds): loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; round 0 {secs[0]:.3f} s, then "
        f"{per_round:.3f} s median ({min(secs[1:]):.3f}-"
        f"{max(secs[1:]):.3f}), {rec['train_tokens_per_s']:.0f} training "
        f"tokens/s; peak {peak / 2**30:.2f} GiB; launches {launches}")
    return rec, result


def profile_lm_round(dev, name, over, params):
    """One more round of the preset from ``params`` (the run's trained
    tree, or fresh weights, as both DPUs' replicas), after the counted
    run, under ``torch.profiler`` (device activity only): wall time,
    device busy time and the kernels that took the most device time.
    The profiler on this card drops records, so the launches are the
    counters'."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import experiments
    from repro_torch.core.round_step import make_dpu_meta
    from repro_torch.experiments import lm as tlm
    from repro_torch.kernels import ops
    from repro_torch.kernels.plane import ParamPlane

    spec = experiments.get_experiment(name).override(**over)
    m = spec.model
    cfg = tlm.lm_config(m)
    step = tlm.build_lm_step(cfg, m, eta=spec.engine.eta, mu=spec.engine.mu)
    plane = ParamPlane.from_tree(params)
    stack = plane.with_data(plane.broadcast(m.n_dpu).data.contiguous())
    del plane
    meta = make_dpu_meta(m.n_dpu, gammas=[m.gamma] * m.n_dpu, device=dev)
    batch = tlm.lm_batch(cfg, m, 99, dev)
    torch.cuda.synchronize()
    before = dict(ops.LAUNCHES)
    # device activity only: recording every host op of a whisper-medium
    # round doubles its wall time (a rehearsal on the CPU records the CPU)
    acts = [ProfilerActivity.CUDA if dev.type == "cuda"
            else ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        stack, metrics = step(stack, batch, meta)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counted = {n: ops.LAUNCHES[n] - before[n] for n in before}
    # the raw device records: building the profiler's averages over a
    # whisper-medium round (hundreds of thousands of host ops) takes
    # minutes, reading the records a second
    per_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            n, ns = per_name.get(e.name(), (0, 0))
            per_name[e.name()] = (n + 1, ns + e.duration_ns())
    busy_us = sum(ns for _, ns in per_name.values()) / 1e3
    top = sorted(per_name.items(), key=lambda kv: -kv[1][1])[:15]
    table = [{"name": k, "calls": n, "device_ms": ns / 1e6}
             for k, (n, ns) in top]
    # nova_aggregate_stacked launches nova_aggregate_kernel (replicas = n)
    mine = {n: [{"calls": c, "device_ms": ns / 1e6}
                for k2, (c, ns) in per_name.items() if k in k2]
            for n, k in (("fedprox_accum", "fedprox_accum_kernel"),
                         ("nova_aggregate_stacked", "nova_aggregate_kernel"))}
    log(f"  profiled {name} round: wall {wall * 1e3:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms ({100 * busy_us / 1e3 / (wall * 1e3):.1f} "
        f"% of wall); counted launches {counted}; the kernels in the "
        f"trace: {mine}")
    for r in table[:10]:
        log(f"    {r['device_ms']:9.3f} ms  {r['calls']:5d}x  "
            f"{r['name'][:70]}")
    del stack
    torch.cuda.empty_cache()
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
            "busy_share": busy_us / 1e3 / (wall * 1e3), "top": table,
            "kernels_in_trace": mine, "counted_launches": counted,
            "loss": float(metrics["loss"])}


def _row_chunks(R: int, rows: int = 1 << 16):
    """Slices of at most ``rows`` plane rows covering R: the plain version
    and the comparison run chunk by chunk, so a check at an LM plane
    holds no full-size temporary beside the inputs and the kernel's
    outputs."""
    return [slice(r, min(r + rows, R)) for r in range(0, R, rows)]


def lm_kernel_checks(dev, timer, run_timer, bw, f32_rate, shapes,
                     run_kernels=("fedprox_accum", "nova_aggregate_stacked")):
    """Phase 9 (e) and phase 10's rows of phase 4: ``fedprox_accum``
    (per-DPU anchor) and ``nova_aggregate_stacked`` against their plain
    versions (chunk by chunk, ``_row_chunks``) at every shape the phase
    launched them with (``shapes``: {(G, R, form) or (n, R): launches}),
    f32, with the tolerances of phase 4's rows (two f32 ulps of the
    largest operand; two of the largest |x| plus theta_eta * n of the
    largest |d|).  Each is timed per call (``Timer``) beside its plain
    version, its byte bound and, for the stacked form, ``addmm``; the
    largest also as a run of 200 launches (``run_timer``, a ``RunTimer``,
    for the kernels of ``run_kernels``; None leaves that out: at
    whisper-medium's plane the two copies of ``fedprox_accum``'s inputs
    would take 50 GB, of the stacked form's 25 GB).  Returns the rows."""
    from repro_torch.kernels import fedprox_update as kfp
    from repro_torch.kernels import nova_aggregate as kna
    from repro_torch.kernels import ref
    from repro_torch.kernels.plane import LANE

    gen = torch.Generator(device=dev).manual_seed(4321)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev)

    rows = []
    R_max = max(R for _, R, _ in shapes["fedprox_accum"])
    for (G, R, form), n_path in sorted(shapes["fedprox_accum"].items()):
        x, g, acc, anchor = (randn((G, R, LANE)) for _ in range(4))
        coef = torch.rand(G, generator=gen, device=dev) + 0.5
        active = torch.ones(G, device=dev)
        args = (x, g, anchor, acc, coef, active, 3e-2, 0.01)
        kx, kacc = kfp.fedprox_accum(*args)
        atol = 2 * max(_spacing(x), _spacing(g), _spacing(anchor),
                       _spacing(acc))
        check = None
        for sl in _row_chunks(R):
            rx, racc = ref.fedprox_accum_ref(
                x[:, sl], g[:, sl], anchor[:, sl], acc[:, sl], *args[4:])
            part = _both(within(kx[:, sl], rx, atol),
                         within(kacc[:, sl], racc, atol))
            check = part if check is None else _both(check, part)
        nbytes = 4 * R * LANE * 6 * G
        row = {"kernel": "fedprox_accum", "G": G, "R": R, "dtype": "float32",
               "anchor": form, "path_launches": n_path, "bytes": nbytes,
               **check}
        del kx, kacc, rx, racc
        row["ms"] = timer(lambda: kfp.fedprox_accum(*args))
        row["plain_ms"] = timer(lambda: ref.fedprox_accum_ref(*args))
        row["library_ms"] = None
        row["bound_ms"] = max(nbytes / bw, 7 * G * R * LANE / f32_rate) * 1e3
        row["bound_by"] = "bytes"
        del x, g, acc, anchor, args
        if R == R_max and run_timer is not None \
                and "fedprox_accum" in run_kernels:
            row["run_ms"] = run_timer(
                lambda x, g, a, acc: kfp.fedprox_accum(
                    x, g, a, acc, coef, active, 3e-2, 0.01),
                lambda: tuple(randn((G, R, LANE)) for _ in range(4)),
                nbytes)
        rows.append(row)
        log(f"  {_fmt(row)}" + (f"  run of 200 {row['run_ms']:.4f} ms"
                                if "run_ms" in row else ""))
        torch.cuda.empty_cache()
    for (n, R), n_path in sorted(shapes["nova_aggregate_stacked"].items()):
        x, d = randn((n, R, LANE)), randn((n, R, LANE))
        w = torch.rand(n, generator=gen, device=dev) + 0.1
        w = w / w.sum()
        theta_eta = 2 * 3e-2
        k = kna.nova_aggregate_stacked(x, d, w, theta_eta)
        atol = 2 * _spacing(x) + theta_eta * n * _spacing(d)
        check = None
        for sl in _row_chunks(R):
            part = within(k[:, sl], ref.nova_aggregate_ref(
                x[:, sl], d[:, sl], w, theta_eta), atol)
            check = part if check is None else _both(check, part)
        nbytes = 4 * R * LANE * 3 * n
        row = {"kernel": "nova_aggregate_stacked", "G": n, "R": R,
               "dtype": "float32", "anchor": "-", "path_launches": n_path,
               "bytes": nbytes, **check}
        del k
        M = -theta_eta * torch.outer(torch.ones(n, device=dev), w)
        row["ms"] = timer(lambda: kna.nova_aggregate_stacked(
            x, d, w, theta_eta))
        row["plain_ms"] = timer(lambda: ref.nova_aggregate_ref(
            x, d, w, theta_eta))
        row["library_ms"] = timer(lambda: torch.addmm(
            x.view(n, -1), M, d.view(n, -1)))
        row["bound_ms"] = max(nbytes / bw, 4 * n * R * LANE / f32_rate) * 1e3
        row["bound_by"] = "bytes"
        del x, d
        if R == R_max and run_timer is not None \
                and "nova_aggregate_stacked" in run_kernels:
            row["run_ms"] = run_timer(
                lambda x, d: kna.nova_aggregate_stacked(x, d, w, theta_eta),
                lambda: (randn((n, R, LANE)), randn((n, R, LANE))), nbytes)
        rows.append(row)
        log(f"  {_fmt(row)}" + (f"  run of 200 {row['run_ms']:.4f} ms"
                                if "run_ms" in row else ""))
        torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"phase 9: {len(bad)} kernel case(s) disagree "
                             f"with the plain version: {bad}")
    return rows


def drive_lm_phase(dev, bw, f32_rate):
    """Phase 9: (a) mamba2-130m served at full width and depth in bf16,
    (b) a 2-layer full-width f32 mamba2 card vs CPU (serving and one LM
    round), (c) ``lm_smoke`` whole and (d) ``lm_mamba2_130m`` at full
    width and depth cut to 6 rounds through ``experiments.run``, with a
    profiled round, (e) both round kernels at every shape (c) and (d)
    launched against their plain versions, timed.  Returns the launch
    counts of (a), (c) and (d) and the records."""
    from repro_torch.configs import get_config

    log("  (a) serve mamba2-130m at full width and depth (bf16, random "
        "weights): 8 x 512-token prompts, 32 tokens")
    s_launches, _, s_records, s_profile, s_init = drive_serve_path(
        dev, cfg=get_config(LM_ARCH), runs=LM_SERVE_RUNS)
    log("  (b) mamba2-130m x2 layers at full width, f32: card vs CPU")
    check = lm_reference_check(dev)
    shapes = _ShapeRecorder()
    log("  (c) lm_smoke whole (20 rounds) through experiments.run")
    smoke, _ = _lm_run(dev, "lm_smoke", {}, shapes)
    launches = Counter(smoke["launches"])
    log("  (d) lm_mamba2_130m at full width and depth, 6 of 200 rounds")
    full, result = _lm_run(dev, "lm_mamba2_130m", LM_FULL_OVER, shapes)
    launches.update(full["launches"])
    launches.update(s_launches)
    profile = profile_lm_round(dev, "lm_mamba2_130m", LM_FULL_OVER,
                               result.params)
    del result
    torch.cuda.empty_cache()
    log("  (e) fedprox_accum and nova_aggregate_stacked at phase 9's shapes"
        " vs their plain versions")
    timer = Timer(dev)
    rows = lm_kernel_checks(dev, timer, RunTimer(), bw, f32_rate,
                            shapes.shapes)
    del timer
    return dict(launches), {
        "serve_init": s_init, "serve_runs": s_records,
        "serve_decode_profile": s_profile, "check": check,
        "lm_smoke": smoke, "lm_mamba2_130m": full, "round_profile": profile,
        "kernel_rows": rows}


# ------------------- phase 10: MoE, the flash backward, enc-dec --

# (a), (b): (arch, layers, runs, gen, cache_len); depth cut in whole
# periods (jamba's is 8 layers, llama4's 2), widths full, bf16
P10_SERVE = [
    ("jamba-v0.1-52b", 16, [("8 x 512", 8, 512)], 32, 1024),
    ("llama4-maverick-400b-a17b", 2, [("8 x 512", 8, 512)], 4, 1024),
]
# (c) whisper-medium at full width and depth through launch.train, at a
# step size of 3e-3: at launch.train's default 3e-2 the full-width loss
# rises over the first rounds
WHISPER = "whisper-medium"
WHISPER_TRAIN = {"steps": 3, "batch": 8, "seq": 256, "n-dpu": 2,
                 "gamma": 2, "eta": 3e-3}
WHISPER_SERVE = ([("8 x 64", 8, 64)], 32, 128)
# (d) the flash backward at starcoder2-15b's attention shape, past its
# 4096 window
FLASH_SHAPE = {"B": 1, "S": 6144, "Hq": 48, "Hkv": 4, "D": 128,
               "window": 4096}
FLASH_REL = 1e-5
# (e) card vs CPU at the reduced size, f32
P10_CHECK_ARCHS = ["jamba-v0.1-52b", "llama4-maverick-400b-a17b",
                   "arctic-480b", "qwen3-32b", "whisper-medium"]
P10_CHECK = {"batch": 2, "prompt": 64, "steps": 4, "seq": 64,
             "gammas": (2, 1)}


class _RouteRecorder:
    """Wraps ``models.moe.moe_route`` for the length of a ``with`` block
    and keeps every routing it returns: its device, shape (G, T, k),
    capacity and the expert ids and kept mask."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe
        self._mod, self._real = moe, moe.moe_route
        real = self._real

        def moe_route(router, xg, m, C):
            r = real(router, xg, m, C)
            self.calls.append({"device": xg.device.type, "C": C,
                               "shape": tuple(r["expert_ids"].shape),
                               "expert_ids": r["expert_ids"],
                               "kept": r["kept"]})
            return r

        moe.moe_route = moe_route
        return self

    def __exit__(self, *exc):
        self._mod.moe_route = self._real

    def summary(self) -> list:
        """Per distinct (G, T, k, C): calls and the share of (token,
        choice) pairs kept."""
        out = {}
        for c in self.calls:
            key = c["shape"] + (c["C"],)
            n, kept, pairs = out.get(key, (0, 0, 0))
            out[key] = (n + 1, kept + int(c["kept"].sum()),
                        pairs + c["kept"].numel())
        return [{"G": k[0], "T": k[1], "k": k[2], "C": k[3], "calls": n,
                 "kept_share": kept / pairs}
                for k, (n, kept, pairs) in sorted(out.items())]


class _SwaRecorder:
    """Wraps ``kernels.swa_decode_attention.swa_decode_attention`` for the
    length of a ``with`` block and counts its launch shapes: {(B, Hq,
    Hkv, D, S, dtype): Counter(cache_len -> launches)}."""

    def __init__(self):
        self.shapes = {}

    def __enter__(self):
        from repro_torch.kernels import swa_decode_attention as kswa
        self._mod, self._real = kswa, kswa.swa_decode_attention
        real = self._real

        def swa_decode_attention(q, k_cache, v_cache, cache_len):
            key = (q.shape[0], q.shape[1], k_cache.shape[2], q.shape[2],
                   k_cache.shape[1], q.dtype)
            self.shapes.setdefault(key, Counter())[int(cache_len)] += 1
            return real(q, k_cache, v_cache, cache_len)

        kswa.swa_decode_attention = swa_decode_attention
        return self

    def __exit__(self, *exc):
        self._mod.swa_decode_attention = self._real

    def cases(self) -> list:
        """swa_checks' cases: the first and last cache_len of each shape,
        with their launches."""
        out = []
        for (B, Hq, Hkv, D, S, dt), cls in sorted(
                self.shapes.items(), key=lambda kv: str(kv[0])):
            for cl in sorted({min(cls), max(cls)}):
                out.append((B, Hq, Hkv, D, S, cl, dt, cls[cl]))
        return out


def _serve_full(dev, arch, layers, runs, gen, cache_len):
    """(a) / (b) / the whisper serve of (c): ``drive_serve_path`` on the
    full-width config cut to ``layers`` (None: all), with the MoE
    routings recorded.  Returns the launches, the records and the
    routing summary."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    with _RouteRecorder() as routes:
        launches, _, records, prof, init = drive_serve_path(
            dev, cfg=cfg, runs=runs, gen=gen, cache_len=cache_len)
    summary = routes.summary()
    for r in summary:
        log(f"    MoE routing G {r['G']} x T {r['T']} x top-{r['k']}, "
            f"capacity {r['C']}: {r['calls']} calls, "
            f"{100 * r['kept_share']:.2f} % of pairs kept")
    for rec in records:
        rec["launches_per_step"] = rec["launches"][
            "swa_decode_attention"] / (gen - 1)
    return launches, {"init": init, "runs": records, "decode_profile": prof,
                      "routing": summary, "layers": cfg.num_layers}


def drive_whisper_train(dev, shapes):
    """(c) whisper-medium at full width and depth through
    ``launch.train.main`` (``WHISPER_TRAIN``), counters set to 0 just
    before and read just after: every round launches ``fedprox_accum``
    gamma times and ``nova_aggregate_stacked`` once and nothing else;
    losses finite and the last below the first (``run_lm`` raises
    otherwise).  Then one profiled round from fresh weights."""
    from repro_torch.experiments.lm import lm_config
    from repro_torch.experiments.spec import ModelSpec
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import lm as L

    t = WHISPER_TRAIN
    argv = ["--arch", WHISPER, "--device", str(dev)] + [
        a for k, v in t.items() for a in (f"--{k}", str(v))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                       # counts to 0: the path
    t0 = time.perf_counter()
    with _RoundCounter() as rc, shapes:
        losses = train.main(argv)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)              # read just after
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(launches, 0)
    want.update(fedprox_accum=t["gamma"], nova_aggregate_stacked=1)
    for i, r in enumerate(rc.rounds):
        if r["launches"] != want:
            raise AssertionError(f"whisper round {i}: launches "
                                 f"{r['launches']} != {want}")
    if len(rc.rounds) != t["steps"] or not all(np.isfinite(losses)):
        raise AssertionError(f"whisper: {len(rc.rounds)} rounds, losses "
                             f"{losses}")
    secs = [r["seconds"] for r in rc.rounds]
    per_round = statistics.median(secs[1:])
    tokens = t["batch"] * t["seq"] * t["gamma"]
    m = ModelSpec(kind="lm", arch=WHISPER, reduced=False, batch=t["batch"],
                  seq=t["seq"], n_dpu=t["n-dpu"], gamma=t["gamma"])
    cfg = lm_config(m)
    R = max(R for _, R, _ in shapes.shapes["fedprox_accum"])
    rec = {"argv": argv, "losses": losses, "round_s": secs,
           "round_s_median_after_first": per_round,
           "train_tokens_per_round": tokens,
           "train_tokens_per_s": tokens / per_round, "wall_s": wall,
           "peak_device_bytes": peak, "launches": launches, "R": R}
    log(f"  whisper-medium training ({cfg.num_layers} + "
        f"{cfg.encoder_layers} layers, plane R = {R}, {t['n-dpu']} DPUs, "
        f"batch {t['batch']} x seq {t['seq']} + {cfg.encoder_seq} frames, "
        f"gamma {t['gamma']}, eta {t['eta']}, {t['steps']} rounds): loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; round 0 {secs[0]:.3f} s, "
        f"then {per_round:.3f} s median, {rec['train_tokens_per_s']:.0f} "
        f"training tokens/s; peak {peak / 2**30:.2f} GiB; launches "
        f"{launches}")
    over = {"model.arch": WHISPER, "model.reduced": False,
            "model.batch": t["batch"], "model.seq": t["seq"],
            "model.n_dpu": t["n-dpu"], "model.gamma": t["gamma"],
            "engine.eta": t["eta"]}
    params = L.init_lm_params(torch.Generator(device=dev).manual_seed(0),
                              cfg, torch.float32)
    rec["round_profile"] = profile_lm_round(dev, "lm_smoke", over, params)
    del params
    torch.cuda.empty_cache()
    return launches, rec


def flash_check(dev, timer):
    """(d) the flash backward at starcoder2-15b's attention shape
    (``FLASH_SHAPE``, f32, TF32 off, causal with the 4096 window past
    it): out, dq, dk, dv of ``models.attention.blocked_attention`` against
    autograd through a naive masked attention (scores of every pair, the
    KV heads repeated over their G query heads) on the same card
    tensors, each within ``FLASH_REL`` of the naive one's largest entry.
    Both timed (forward + backward, median of 5) with their peaks."""
    from repro_torch.models import attention as A

    f = FLASH_SHAPE
    B, S, Hq, Hkv, D, W = (f[k] for k in ("B", "S", "Hq", "Hkv", "D",
                                          "window"))
    G = Hq // Hkv
    gen = torch.Generator(device=dev).manual_seed(77)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    q = randn(B, S, Hq, D).requires_grad_(True)
    k = randn(B, S, Hkv, D).requires_grad_(True)
    v = randn(B, S, Hkv, D).requires_grad_(True)
    dout = randn(B, S, Hq, D)
    pos = torch.arange(S, device=dev)
    mask = (pos[:, None] >= pos[None]) & (pos[:, None] - pos[None] < W)

    def flash():
        out = A.blocked_attention(q, k, v, causal=True, window=W)
        return (out,) + torch.autograd.grad(out, (q, k, v), dout)

    def naive():
        kk, vv = k.repeat_interleave(G, 2), v.repeat_interleave(G, 2)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * A._scale(D)
        p = torch.softmax(torch.where(mask, s, A.NEG_INF), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p, vv)
        return (out,) + torch.autograd.grad(out, (q, k, v), dout)

    rec = {"shape": dict(f)}
    results = {}
    for name, fn in (("flash", flash), ("naive", naive)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        results[name] = [t.detach() for t in fn()]
        torch.cuda.synchronize()
        rec[f"{name}_peak_bytes"] = torch.cuda.max_memory_allocated()
        rec[f"{name}_ms"] = timer(fn, iters=5, warmup=1)
    errs = {}
    for name, got, want in zip(("out", "dq", "dk", "dv"), results["flash"],
                               results["naive"]):
        scale = float(want.abs().max())
        errs[name] = {"max_abs_err": float((got - want).abs().max()),
                      "max_abs": scale, "tol": FLASH_REL * scale}
        if not errs[name]["max_abs_err"] <= errs[name]["tol"]:
            raise AssertionError(f"flash backward at {f}: {name} "
                                 f"{errs[name]}")
    rec["errors"] = errs
    log(f"  flash backward at B {B}, S {S}, Hq {Hq}, Hkv {Hkv}, D {D}, "
        f"window {W} (f32): " + ", ".join(
            f"{n} {e['max_abs_err']:.2e} of {e['max_abs']:.2f}"
            for n, e in errs.items()) + f" (tol {FLASH_REL:g} of each max); "
        f"forward + backward {rec['flash_ms']:.1f} ms, peak "
        f"{rec['flash_peak_bytes'] / 2**30:.2f} GiB; naive "
        f"{rec['naive_ms']:.1f} ms, peak "
        f"{rec['naive_peak_bytes'] / 2**30:.2f} GiB")
    del q, k, v, dout, results
    torch.cuda.empty_cache()
    return rec


def _same_routing(routes: _RouteRecorder, what: str, dev) -> int:
    """The card's routings equal the CPU's, call for call (expert ids and
    kept mask); raises naming the flips otherwise.  Returns the calls
    compared (none in a rehearsal on the CPU, which has no card)."""
    if dev.type == "cpu":
        return 0
    cpu = [c for c in routes.calls if c["device"] == "cpu"]
    card = [c for c in routes.calls if c["device"] != "cpu"]
    if len(cpu) != len(card):
        raise AssertionError(f"{what}: {len(cpu)} CPU routings, "
                             f"{len(card)} on the card")
    for i, (a, b) in enumerate(zip(cpu, card)):
        ids = b["expert_ids"].cpu() != a["expert_ids"]
        kept = b["kept"].cpu() != a["kept"]
        if bool(ids.any()) or bool(kept.any()):
            raise AssertionError(
                f"{what}: routing {i} {a['shape']} flips {int(ids.sum())} "
                f"expert choices and {int(kept.sum())} capacity drops "
                "between the CPU and the card")
    return len(cpu)


def p10_reference_checks(dev):
    """(e) every ``P10_CHECK_ARCHS`` config at its reduced size, f32, TF32
    off, the same weights on the card and on the CPU: prefill and decode
    logits to ``atol`` 5e-4 (``serve_reference_check``) and one
    plane-form CE-FL LM round to rtol 1e-4, atol 1e-5
    (``lm_round_card_vs_cpu``), each after checking that every MoE
    routing (expert ids, kept mask) agrees."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.experiments.spec import ModelSpec

    c = P10_CHECK
    out = {}
    for arch in P10_CHECK_ARCHS:
        cfg = reduced(get_config(arch))
        with _RouteRecorder() as routes:
            serve_err = serve_reference_check(
                dev, cfg=cfg, batch=c["batch"], prompt=c["prompt"],
                steps=c["steps"])
        n_serve = _same_routing(routes, f"{arch} serving", dev)
        m = ModelSpec(kind="lm", arch=arch, reduced=True,
                      batch=2 * c["batch"], seq=c["seq"], n_dpu=2,
                      n_micro=1, gamma=max(c["gammas"]))
        with _RouteRecorder() as routes:
            rnd = lm_round_card_vs_cpu(dev, cfg, m, c["gammas"])
        n_round = _same_routing(routes, f"{arch} round", dev)
        out[arch] = {"serve_logits_max_abs_err": serve_err,
                     "round_max_abs_err": rnd["max_abs_err"],
                     "round_loss": rnd["loss"],
                     "routings_equal": {"serve": n_serve, "round": n_round}}
        if n_serve or n_round:
            log(f"    {arch}: MoE routing equal on card and CPU in "
                f"{n_serve} serving and {n_round} round calls")
    return out


def drive_p10_phase(dev, timer):
    """Phase 10: (a) jamba-v0.1-52b, 16 of 32 layers, and (b)
    llama4-maverick-400b-a17b, one period, served at full width in bf16;
    (c) whisper-medium trained at full width and depth through
    ``launch.train`` with a profiled round, then served; (d) the flash
    backward at starcoder2-15b's attention shape against a naive
    gradient; (e) the reduced configs card vs CPU.  Returns the launches
    of (a)-(c), the kernels' launch shapes (fedprox_accum /
    nova_aggregate_stacked: a ``_ShapeRecorder`` over (c) and (e);
    swa_decode_attention: a ``_SwaRecorder`` over all) and the records."""
    launches = Counter()
    records = {"seconds": {}}
    shapes = _ShapeRecorder()

    def part(name, t0):
        records["seconds"][name] = secs = time.perf_counter() - t0
        log(f"    ({name}: {secs:.1f} s)")

    with _SwaRecorder() as swa:
        for (arch, layers, runs, gen, cache_len), tag in zip(P10_SERVE,
                                                             "ab"):
            log(f"  ({tag}) serve {arch} at full width, {layers} layers "
                f"(bf16, random weights): {runs[0][0]}, {gen} tokens, "
                f"cache {cache_len}")
            t0 = time.perf_counter()
            got, records[arch] = _serve_full(dev, arch, layers, runs, gen,
                                             cache_len)
            launches.update(got)
            torch.cuda.empty_cache()
            part(tag, t0)
        log(f"  (c) train {WHISPER} at full width and depth through "
            "launch.train, then serve it")
        t0 = time.perf_counter()
        got, records["whisper_train"] = drive_whisper_train(dev, shapes)
        launches.update(got)
        part("c train", t0)
        t0 = time.perf_counter()
        runs, gen, cache_len = WHISPER_SERVE
        got, records["whisper_serve"] = _serve_full(dev, WHISPER, None,
                                                    runs, gen, cache_len)
        launches.update(got)
        part("c serve", t0)
        log("  (d) the flash backward at starcoder2-15b's attention shape")
        t0 = time.perf_counter()
        records["flash"] = flash_check(dev, timer)
        part("d", t0)
        log("  (e) reduced configs, f32: card vs CPU (serving, one round)")
        t0 = time.perf_counter()
        with shapes:
            records["check"] = p10_reference_checks(dev)
        part("e", t0)
    return dict(launches), shapes, swa, records


# -------------------------------------------- phase 11: the rank mesh --

# The sharded plane's ops at the paper's plane (R = 176; G = 25 DPUs, the
# paper world's, which no 'dpu' axis of 2 or 4 divides, so that axis
# degrades to replication, and G = 20, the UEs of a fednova round) and at
# mamba2-130m's LM plane (R = 126,080, G = 4).
P11_OPS = [("paper plane, G 25", 25, 176), ("paper plane, G 20", 20, 176),
           ("mamba2-130m LM plane", 4, 126080)]
P11_WORLD = 4                     # gloo ranks, all on the one card
P11_MESHES = [(2, 1), (1, 2), (2, 2), (4, 1)]
PAPER_WORLD = dict(num_ue=20, num_bs=10, num_dc=5, pool=48000,
                   input_shape=(28, 28, 1), hidden=(200, 100),
                   eval_examples=1000)
# fednova offloads nothing and plans gamma 2, m 0.5 for every UE; with
# arrivals N(1500, 100) every UE's mini-batch of round(0.5 * D) lands in
# the 513-1024 bucket, so the 20 live DPUs form ONE group and every round
# runs the fused (here: the sharded fused) round.
P11_ENGINE = dict(world=PAPER_WORLD, strategy="fednova", rounds=3,
                  mean_arrivals=1500.0, std_arrivals=100.0, eta=0.1)
# phase 3b's fednova mesh rounds (arrivals N(2000, 200)), cut to 2
P11_MESH_EXEC = dict(mesh=(2, 2), world=PAPER_WORLD, strategy="fednova",
                     rounds=2, mean_arrivals=2000.0, std_arrivals=200.0,
                     eta=0.1)
# starcoder2-15b's attention shape, the sequence split over the 4 ranks;
# cache_len 12,000 leaves rank 3's slice wholly masked
P11_DECODE = dict(B=2, S=16384, Hq=48, Hkv=4, D=128, dtype="bfloat16",
                  cache_lens=(12000, 16384), keep_outputs=True)
P11_LM = dict(arch="starcoder2-15b", reduced_cfg=False, layers=2,
              dtype="float32", batch=2, prompt=1536, cache_len=4096,
              steps=4)
ENGINE_RTOL = 1e-6


def _p11_op_calls(meshes):
    from repro_torch.sharding import parity as P
    return [(P.ops_worker, dict(meshes=meshes, G=G, R=R, seed=1000 + G))
            for _, G, R in P11_OPS]


def _p11_expected_launches(op, shape, G, R, rank):
    """Kernel launches of one sharded op on ``rank``: one launch, two
    for the psum mode on a rank whose 'dpu' axis splits (the partial sum
    and the update); ranks outside the mesh run the single-device op."""
    import types

    from repro_torch.sharding.mesh import plane_axes
    kernel = {"nova_exact": "nova_aggregate", "nova_psum": "nova_aggregate",
              "fedprox_accum": "fedprox_accum"}.get(op, "robust_aggregate")
    d, r = shape
    g_ax, _ = plane_axes(types.SimpleNamespace(shape={"dpu": d, "rows": r}),
                         G, R)
    split = g_ax is not None and d > 1 and rank < d * r
    return {kernel: 2 if (op == "nova_psum" and split) else 1}


def _p11_verdict(c) -> str:
    return "bitwise" if c["bitwise"] else f"max err {c['max_abs_err']:.1e}"


def p11_ops_check(reports, meshes, group):
    """Every sharded op bitwise (psum: allclose) against the single-device
    kernel, every rank's launches as expected, the single-device kernel
    against its plain version.  Returns the summary rows."""
    rows = []
    for (label, G, R), rep in zip(P11_OPS, reports):
        for op, c in rep["kernel_vs_plain"].items():
            if not c["ok"]:
                raise AssertionError(f"{label}: {op} kernel vs plain "
                                     f"{c}")
        for shape in meshes:
            rec = rep["meshes"][str(tuple(shape))]
            for op, c in rec.items():
                ok = c["allclose"] if op == "nova_psum" else c["bitwise"]
                want = [_p11_expected_launches(op, shape, G, R, k)
                        for k in range(len(c["launches"]))]
                if not ok or c["launches"] != want:
                    raise AssertionError(
                        f"{group} {label} mesh {shape} {op}: ok={ok}, "
                        f"launches {c['launches']} != {want}; {c}")
                rows.append({"group": group, "case": label, "G": G, "R": R,
                             "mesh": list(shape), "op": op,
                             "bitwise": c["bitwise"],
                             "max_abs_err": c.get("max_abs_err"),
                             "s": c["s"], "launches": c["launches"],
                             "collectives": c["collectives"]})
            log(f"  {group} {label} (G {G}, R {R}) mesh {tuple(shape)}: "
                + "; ".join(f"{op} {_p11_verdict(c)} {1e3 * c['s']:.1f} ms"
                            for op, c in rec.items()))
    return rows


def p11_engine_check(rep, group):
    """Each mesh's engine run against the single-device run on the card:
    every round through the sharded fused round, accuracy, loss and
    params bitwise or within rtol 1e-6 (atol 1e-6), which is printed."""
    rounds = len(rep["single"]["acc"])
    out = {}
    for shape, c in rep["meshes"].items():
        if c["fused_rounds"] != rounds:
            raise AssertionError(f"{group} engine mesh {shape}: "
                                 f"{c['fused_rounds']} sharded rounds of "
                                 f"{rounds}")
        want = {"fedprox_accum": 2 * rounds, "nova_aggregate": rounds}
        if any(lc != want for lc in c["launches"]):
            raise AssertionError(f"{group} engine mesh {shape}: launches "
                                 f"{c['launches']} != {want} per rank")
        close = np.allclose(c["acc"], rep["single"]["acc"], rtol=ENGINE_RTOL,
                            atol=ENGINE_RTOL) and np.allclose(
            c["loss"], rep["single"]["loss"], rtol=ENGINE_RTOL,
            atol=ENGINE_RTOL) and c["allclose"]
        exact = c["params_bitwise"] and c["acc_equal"] and c["loss_equal"]
        if not (exact or close):
            raise AssertionError(f"{group} engine mesh {shape}: neither "
                                 f"bitwise nor within rtol {ENGINE_RTOL}: "
                                 f"{c}")
        verdict = "bitwise" if exact else f"within rtol {ENGINE_RTOL}"
        log(f"  {group} engine fednova mesh {shape}: {verdict} to the "
            f"single-device card run (params max err {c['max_abs_err']:.1e}"
            f"), {c['fused_rounds']} sharded rounds in {c['s']:.2f} s "
            f"(single device {rep['single']['s']:.2f} s), launches per "
            f"rank {c['launches'][0]}, collectives {c['collectives']}")
        out[shape] = {"verdict": verdict, "s": c["s"],
                      "single_s": rep["single"]["s"],
                      "max_abs_err": c["max_abs_err"],
                      "launches": c["launches"], "acc": c["acc"],
                      "loss": c["loss"], "collectives": c["collectives"]}
    return out


def p11_decode_check(rep):
    """The seq-sharded decode's bf16 output within one bf16 ulp of the
    plain version's f32 result or 8 f32 ulps of the largest |v| (the
    swa check's bound), as is the single-device kernel's."""
    out = {}
    for cl, c in rep["cases"].items():
        want = torch.from_numpy(c["plain_f32"])
        atol = 8 * float(np.spacing(np.float32(c["v_absmax"])))
        res = {name: _within_bf16_of_f32(
            torch.from_numpy(c[name]).to(torch.bfloat16), want, atol)
            for name in ("out", "single")}
        if not (res["out"]["ok"] and res["single"]["ok"]
                and c["collectives"] == {"all_reduce:cache": 3}):
            raise AssertionError(f"seq-sharded decode cache_len {cl}: "
                                 f"{res} {c['collectives']}")
        log(f"  (d) seq-sharded decode B {rep['B']} S {rep['S']} over "
            f"{P11_WORLD} ranks, cache_len {cl}: vs plain f32 "
            f"{res['out']['max_abs_err']:.2e} (tol {res['out']['tol']:.2e}),"
            f" vs the single-device kernel {c['vs_single']:.2e}, kernel vs "
            f"plain {res['single']['max_abs_err']:.2e}; {1e3 * c['s']:.2f} "
            f"ms, collectives {c['collectives']}")
        out[cl] = {"vs_plain": res["out"], "kernel_vs_plain": res["single"],
                   "vs_single": c["vs_single"], "s": c["s"],
                   "launches": c["launches"]}
    return out


def drive_mesh_phase(dev):
    """Phase 11: the sharded plane on ``('dpu', 'rows')`` rank meshes,
    every rank launching the hand-written kernels on its block.  A
    one-rank NCCL group runs mesh (1, 1); a gloo group of 4 ranks, all on
    this card (NCCL refuses two ranks on one device; gloo stages CUDA
    tensors through host memory), runs (2, 1), (1, 2), (2, 2), (4, 1).
    (a) the sharded ops, (b) the engine, (c) ``MeshExecutor(mesh_shape=
    (2, 2))``, (d) the sequence-sharded decode and one ``lm_decode_step``
    with ``ctx``.  Seconds are recorded but are no scaling figure: the
    ranks share one card.  Returns (launches of every rank's sharded
    calls, records)."""
    from repro_torch.sharding import parity as P
    from repro_torch.sharding.mesh import run_spmd

    records = {}
    t0 = time.perf_counter()
    log("  one-rank NCCL group: mesh (1, 1)")
    nccl = run_spmd(P.sequence_worker, 1, _p11_op_calls([(1, 1)]) + [
        (P.engine_worker, dict(meshes=[(1, 1)], **P11_ENGINE))],
        backend="nccl", device=dev)
    records["nccl_s"] = time.perf_counter() - t0
    log(f"  gloo group of {P11_WORLD} ranks on one card: meshes "
        f"{P11_MESHES}")
    t0 = time.perf_counter()
    gloo = run_spmd(P.sequence_worker, P11_WORLD, _p11_op_calls(P11_MESHES)
                    + [(P.engine_worker, dict(meshes=[(2, 2), (4, 1)],
                                              **P11_ENGINE)),
                       (P.mesh_executor_worker, P11_MESH_EXEC),
                       (P.decode_worker, P11_DECODE),
                       (P.lm_decode_worker, P11_LM)],
                    backend="gloo", device=dev)
    records["gloo_s"] = time.perf_counter() - t0
    n_ops = len(P11_OPS)
    log("  (a) the sharded ops (exact and psum eq. 11, both robust modes, "
        "fedprox_accum)")
    records["ops"] = p11_ops_check(nccl[:n_ops], [(1, 1)], "nccl") + \
        p11_ops_check(gloo[:n_ops], P11_MESHES, "gloo")
    log("  (b) the engine at paper width, fednova x3")
    records["engine"] = {**p11_engine_check(nccl[n_ops], "nccl"),
                         **p11_engine_check(gloo[n_ops], "gloo")}
    mx = gloo[n_ops + 1]
    log(f"  (c) MeshExecutor(mesh_shape=(2, 2)), fednova x2: loss "
        f"{mx['loss']} vs {mx['ref_loss']}, params max err "
        f"{mx['params_max_abs_err']:.1e} (atol 1e-5), {mx['mesh_steps']} "
        f"sharded steps, launches per rank {mx['launches'][0]}")
    want = {"fedprox_accum": 4, "nova_aggregate_stacked": 2}
    if (mx["mesh_steps"] != 2 or mx["params_max_abs_err"] > 1e-5
            or mx["loss_max_abs_err"] > 1e-5
            or any(lc != want for lc in mx["launches"])):
        raise AssertionError(f"sharded MeshExecutor: {mx}")
    records["mesh_executor"] = mx
    records["decode"] = p11_decode_check(gloo[n_ops + 2])
    lm = gloo[n_ops + 3]
    log(f"  (d) lm_decode_step with ctx: {lm['arch']} x{lm['layers']} "
        f"layers (d_model {lm['d_model']}, f32), B {lm['batch']}, prompt "
        f"{lm['prompt']}, cache rows {lm['cache_rows']} over {lm['shards']}"
        f" ranks, {lm['steps']} steps: logits max err "
        f"{lm['logits_max_abs_err']:.2e} vs the single-device kernel path "
        f"(tol {lm['logits_atol']:g}), tokens agree "
        f"{lm['tokens_agree_where_clear']}")
    if not (lm["ok"] and lm["finite"]):
        raise AssertionError(f"lm_decode_step with ctx: {lm}")
    records["lm_decode"] = lm
    log(f"  seconds: NCCL group {records['nccl_s']:.1f}, gloo group "
        f"{records['gloo_s']:.1f} (spawn included; ranks share one card "
        "and gloo stages through host memory: no scaling figure)")
    launches = Counter()
    for rep in nccl[:n_ops] + gloo[:n_ops]:
        for rec in rep["meshes"].values():
            for c in rec.values():
                for lc in c["launches"]:
                    launches.update(lc)
    for rep in (nccl[n_ops], gloo[n_ops]):
        for c in rep["meshes"].values():
            for lc in c["launches"]:
                launches.update(lc)
    for lc in mx["launches"]:
        launches.update(lc)
    return dict(launches), records


# ------------------------------------------------ phase 12: the examples --

# The examples' arguments (each adds --device, default cuda): the three
# CE-FL examples at their own or the paper's width, codeqwen1.5-7b served
# whole in f32 at the example's defaults (batch 4, prompt 32, 16 tokens,
# cache 128), mamba2-130m trained whole for 3 rounds.
P12_SERVE_ARCH = "codeqwen1.5-7b"
P12_CVB = ["--full", "--rounds", "3"]
P12_TRAIN = ["--full", "--steps", "3"]


def _counted(label, fn, want=None):
    """``fn()`` in this process with its printed output kept in
    ``OUT/phase12_<label>.txt``; the launch counters are set to 0 just
    before the call and read just after.  ``want``: the exact launch
    counts the call must make (every other kernel 0).  Returns (fn's
    result, launches, seconds, output)."""
    import contextlib
    import io

    from repro_torch.kernels import ops

    out = io.StringIO()
    torch.cuda.synchronize()
    ops.reset_launches()                       # counts to 0: the path
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)              # read just after
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / f"phase12_{label}.txt").write_text(out.getvalue())
    if want is not None:
        full = dict.fromkeys(launches, 0)
        full.update(want)
        if launches != full:
            raise AssertionError(f"{label}: launches {launches} != {full}")
    log(f"    {label}: {secs:.1f} s; launches "
        f"{ {k: v for k, v in launches.items() if v} }")
    return result, launches, secs, out.getvalue()


def _example(name, argv, want=None):
    """``repro_torch.examples.<name>.main(argv)``, counted."""
    import importlib

    mod = importlib.import_module(f"repro_torch.examples.{name}")
    return _counted(name, lambda: mod.main(list(argv)), want)


def _round_kernels(name, launches):
    """A CE-FL example must have launched both round kernels."""
    if not (launches["fedprox_accum"] and launches["nova_aggregate"]):
        raise AssertionError(f"{name}: no fedprox_accum or nova_aggregate "
                             f"launch: {launches}")


def drive_examples_phase(dev):
    """Phase 12: the five examples of ``repro_torch.examples`` on the card
    through their ``main(argv)`` (and quickstart once through ``python
    -m``), plus the sanitizer through the front door: (a) quickstart
    whole; (b) ``experiments run quickstart --set sanitize=true`` finite
    every round, then with ``engine.eta=1e12`` it must raise
    ``SanitizerError``, and the same run through ``experiments.run`` under
    ``engine.sanitize`` must equal (a) bit for bit, launches included;
    (c) ``cefl_vs_baselines --full --rounds 3``; (d)
    ``mobility_demo`` whole (its own asserts: a migration and a handover
    under cefl, none under fixed:0); (e) ``serve_lm`` on codeqwen1.5-7b at
    full width and depth in f32, exactly 32 x 15 ``swa_decode_attention``
    launches, its launch shapes recorded for phase 4; (f)
    ``train_lm_cefl --full --steps 3`` from a temporary working
    directory: ``fedprox_accum`` gamma and ``nova_aggregate_stacked`` once
    a round, losses finite and falling.  The round kernels' launch shapes
    are recorded for phase 4: (a)-(d) in one ``_ShapeRecorder`` (the
    ``-m`` subprocess runs (a)'s shapes again, unrecorded), (f) in
    another, since its plane is an LM's.  Returns (launches, swa
    recorder, the CE-FL examples' shapes, train_lm_cefl's shapes,
    records)."""
    import os
    import re
    import tempfile

    from repro_torch.analysis import SanitizerError
    from repro_torch.configs import get_config
    from repro_torch import experiments
    from repro_torch.experiments import __main__ as cli
    from repro_torch.experiments import get_experiment
    from repro_torch.experiments.trace import read_trace

    launches, rec = Counter(), {}
    shapes, lm_shapes = _ShapeRecorder(), _ShapeRecorder()
    t_phase = time.perf_counter()
    log("  (a) quickstart, whole (8 cefl rounds)")
    with shapes:
        res, lc, secs, _ = _example("quickstart", [])
    quick, quick_lc = res, lc
    _round_kernels("quickstart", lc)
    launches.update(lc)
    rec["quickstart"] = {"s": secs, "launches": lc,
                         "acc": res.series("acc"),
                         "loss": res.series("loss"),
                         "aggregator": res.series("aggregator"),
                         "energy": res.series("energy"),
                         "delay": res.series("delay")}
    if not np.isfinite(rec["quickstart"]["loss"]).all():
        raise AssertionError(f"quickstart losses {rec['quickstart']}")
    t0 = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-m",
                           "repro_torch.examples.quickstart"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    (OUT / "phase12_quickstart_m.txt").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0 or "final accuracy" not in proc.stdout:
        raise AssertionError(
            f"python -m repro_torch.examples.quickstart: exit "
            f"{proc.returncode}: {proc.stderr[-2000:]}")
    rec["quickstart_m_s"] = time.perf_counter() - t0
    log(f"  python -m repro_torch.examples.quickstart: exit 0 in "
        f"{rec['quickstart_m_s']:.1f} s ("
        f"{proc.stdout.strip().splitlines()[-1]})")

    log("  (b) experiments run quickstart --set sanitize=true; the same "
        "through experiments.run, equal to (a) bit for bit; then "
        "engine.eta=1e12 must raise SanitizerError")
    trace = OUT / "phase12_sanitize_trace.jsonl"
    argv = ["run", "quickstart", "--set", "sanitize=true", "--trace",
            str(trace)]
    with shapes:
        rc, lc, secs, _ = _counted("sanitize", lambda: cli.main(argv))
    if rc != 0:
        raise AssertionError(f"experiments {argv}: exit {rc}")
    rounds = read_trace(trace)
    if len(rounds) != 8 or not all(
            np.isfinite([r["loss"], r["acc"], r["energy"], r["delay"]]).all()
            for r in rounds):
        raise AssertionError(f"experiments {argv}: trace {rounds}")
    _round_kernels("quickstart sanitize", lc)
    launches.update(lc)
    rec["sanitize_clean_s"] = secs
    spec = get_experiment("quickstart").override(**{"engine.sanitize": True})
    with shapes:
        res, lc, secs, _ = _counted(
            "sanitize_run", lambda: experiments.run(spec, device=dev),
            want=quick_lc)
    launches.update(lc)
    for key in ("acc", "loss", "aggregator", "energy", "delay",
                "dc_points"):
        if res.series(key) != quick.series(key):
            raise AssertionError(f"sanitize run's {key} {res.series(key)} "
                                 f"!= quickstart's {quick.series(key)}")
    for k in quick.params:
        if not torch.equal(res.params[k], quick.params[k]):
            raise AssertionError(f"sanitize run's params[{k!r}] differ "
                                 f"from quickstart's")
    rec["sanitize_run"] = {"s": secs, "launches": lc,
                           "equal_to_quickstart": True}
    log("    under sanitize: launches, acc, loss, aggregator, energy, "
        "delay, dc_points and params equal (a)'s bit for bit")
    argv = ["run", "quickstart", "--set", "sanitize=true", "--set",
            "engine.eta=1e12", "--rounds", "2"]
    try:
        with shapes:
            _counted("sanitize_divergent", lambda: cli.main(argv))
    except SanitizerError as e:
        rec["sanitize_divergent"] = str(e)
        log(f"    eta=1e12 raised as it must: {e}")
    else:
        raise AssertionError("quickstart at eta=1e12 under sanitize ran to "
                             "its end without a SanitizerError")

    log("  (c) cefl_vs_baselines --full --rounds 3 (20/10/5, 28x28)")
    with shapes:
        res, lc, secs, _ = _example("cefl_vs_baselines", P12_CVB)
    _round_kernels("cefl_vs_baselines", lc)
    launches.update(lc)
    rec["cefl_vs_baselines"] = {"s": secs, "launches": lc, "final": {
        s: {k: getattr(res.result(0, s).final, k)
            for k in ("acc", "loss", "cum_energy", "cum_delay")}
        for s in ("cefl", "fednova", "fedavg")}}
    for s, f in rec["cefl_vs_baselines"]["final"].items():
        if not np.isfinite(list(f.values())).all():
            raise AssertionError(f"cefl_vs_baselines {s}: {f}")

    log("  (d) mobility_demo, whole (20 rounds of campus_walk, cefl and "
        "fixed:0)")
    with shapes:
        res, lc, secs, _ = _example("mobility_demo", [])
    _round_kernels("mobility_demo", lc)
    launches.update(lc)
    cefl, fixed = res["cefl"], res["fixed"]
    rec["mobility_demo"] = {
        "s": secs, "launches": lc,
        "cefl_migrations": sum(r.aggregator_moved for r in cefl.reports),
        "cefl_handovers": sum(len(r.handovers) for r in cefl.reports),
        "fixed_migrations": sum(r.aggregator_moved for r in fixed.reports),
        "cefl_aggregator": cefl.series("aggregator"),
        "final_acc": {"cefl": cefl.final.acc, "fixed": fixed.final.acc}}
    m = rec["mobility_demo"]
    if m["cefl_migrations"] < 1 or m["cefl_handovers"] < 1 \
            or m["fixed_migrations"]:
        raise AssertionError(f"mobility_demo: {m}")
    log(f"    cefl {m['cefl_migrations']} migrations, "
        f"{m['cefl_handovers']} handovers; fixed:0 "
        f"{m['fixed_migrations']} migrations")

    cfg = get_config(P12_SERVE_ARCH)
    steps = 15                     # serve_lm's 16 tokens, less prefill's
    log(f"  (e) serve_lm --arch {P12_SERVE_ARCH} (full width and depth, "
        "f32, batch 4, prompt 32, 16 tokens, cache 128)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with _SwaRecorder() as swa:
        toks, lc, secs, out = _example(
            "serve_lm", ["--arch", P12_SERVE_ARCH],
            want={"swa_decode_attention": cfg.num_layers * steps})
    launches.update(lc)
    gen_s = float(re.search(r"generated \d+ tokens/seq in ([0-9.]+)s",
                            out).group(1))
    rec["serve_lm"] = {
        "s": secs, "launches": lc, "arch": cfg.name,
        "layers": cfg.num_layers, "tokens": toks.tolist(),
        "decode_s_15_steps": gen_s,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "prefill_line": [ln for ln in out.splitlines()
                         if "prefill" in ln][0]}
    if tuple(toks.shape) != (4, 16) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"serve_lm tokens {toks}")
    log(f"    {rec['serve_lm']['prefill_line'].strip()}; decode "
        f"{gen_s / steps * 1e3:.2f} ms/step (host clock over 15 steps, "
        f"one synchronize); peak "
        f"{rec['serve_lm']['peak_device_bytes'] / 2**30:.2f} GiB")
    torch.cuda.empty_cache()

    log("  (f) train_lm_cefl --full --steps 3 (mamba2-130m, full width and "
        "depth) from a temporary working directory")
    gamma = get_experiment("lm_mamba2_130m").model.gamma
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            with lm_shapes:
                res, lc, secs, _ = _example(
                    "train_lm_cefl", P12_TRAIN,
                    want={"fedprox_accum": gamma * 3,
                          "nova_aggregate_stacked": 3})
            ckpt = Path(tmp) / "results" / "ckpt_mamba2_cefl" / \
                "manifest.json"
            if not ckpt.exists():
                raise AssertionError(f"no checkpoint at {ckpt}")
        finally:
            os.chdir(cwd)
    launches.update(lc)
    losses = res.series("loss")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"train_lm_cefl losses {losses}")
    rec["train_lm_cefl"] = {"s": secs, "launches": lc, "losses": losses,
                            "round_s": res.series("wall_time")}
    log(f"    losses {[round(x, 4) for x in losses]}")
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase 12: {rec['phase_s']:.1f} s")
    return dict(launches), swa, shapes.shapes, lm_shapes.shapes, rec


# ---------------------------------------------------------------- main --

# ------------------------------------ phase 13: the drop-free MoE --

# the Nemotron-H cell's expert layer: 8,192 tokens (one DPU step of
# nemotron3_nano_30b_a3b.b4s4k), d 2,688, 128 relu² experts of 1,856,
# top-6, this card holding experts 0-15
P13 = dict(T=8192, d=2688, f=1856, E=128, held=16, k=6, scale=2.5)
# the grouped kernels' launches in one forward and backward of the layer:
# up and down products, their input gradients, their weight gradients
P13_LAUNCHES = {"grouped_mm": 4, "grouped_mm_wgrad": 2}
# |card - plain| <= P13_RTOL x the largest |plain| of the case: float32
# sums of up to 2,688 products in another order
P13_RTOL = 2e-5


def drive_nano_phase(dev, timer, f32_rate):
    """Phase 13: the drop-free expert layer (``models/moe.dropless_forward``)
    at the Nemotron-H cell's shapes.  (a) One forward and backward of the
    layer under ``torch.cuda.set_sync_debug_mode("error")`` (no host read
    inside it), the grouped kernels' launches counted from 0 and held to
    ``P13_LAUNCHES``.  (b) Each product the layer launches, at the layer's
    own routing, against the plain version on the CPU: the up product
    (row gather), the down product, the down product's input gradient and
    both weight gradients, to ``P13_RTOL`` of the largest value; the up
    kernel's own count of rows written against the routing's held pairs.
    (c) Each timed per call (``Timer``, L2 flushed; the launch alone, its
    output allocated once) beside its bound 2·P·K·N at the f32 FMA rate,
    the plain loop on the card and ``torch.bmm`` over equal segments.
    Returns (kernel rows, record)."""
    import ctypes
    import warnings

    from repro_torch.configs.base import MoEConfig
    from repro_torch.kernels import cuda
    from repro_torch.kernels import grouped_mm as gmm
    from repro_torch.models import moe

    t_phase = time.perf_counter()
    built = cuda.build(["grouped_mm"])
    secs, out = built["grouped_mm"]
    (OUT / "build_grouped_mm.log").write_text(out)
    log(f"  grouped_mm built in {secs:.1f} s")
    ptxas = ptxas_summary(out)
    for fn, props in ptxas:
        log(f"    {fn}: {props}")
    c = P13
    m = MoEConfig(num_experts=c["E"], top_k=c["k"], expert_ff=c["f"],
                  expert_act="relu2", dropless=True,
                  routed_scale=c["scale"], held_experts=c["held"])
    gen = torch.Generator(device=dev).manual_seed(13)
    p = moe.init_moe_params(gen, c["d"], m, torch.float32)
    for t in p.values():
        t.requires_grad_(True)
    x = torch.randn((1, c["T"], c["d"]), generator=gen, device=dev,
                    requires_grad=True)
    ct = torch.randn((1, c["T"], c["d"]), generator=gen, device=dev)

    # (a) the layer, built and warmed, then counted under sync debug
    y = moe.dropless_forward(p, x, m)
    torch.autograd.grad((y * ct).sum(), [x] + list(p.values()))
    torch.cuda.synchronize()
    for name in gmm.LAUNCHES:
        gmm.LAUNCHES[name] = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("error")
        try:
            y = moe.dropless_forward(p, x, m)
            grads = torch.autograd.grad((y * ct).sum(),
                                        [x] + list(p.values()))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = dict(gmm.LAUNCHES)
    log(f"  (a) one forward and backward under sync debug mode 'error': "
        f"launches {launches}")
    if launches != P13_LAUNCHES:
        raise AssertionError(f"phase 13: launches {launches}, expected "
                             f"{P13_LAUNCHES}")
    if not all(bool(torch.isfinite(g).all()) for g in grads):
        raise AssertionError("phase 13: a non-finite gradient")

    # (b) the products at the layer's routing, card against the CPU
    with torch.no_grad():
        h = x.detach().reshape(c["T"], c["d"])
        r = moe.dropless_route(p["router"].detach(), h, m)
        w_in, w_out = p["w_in"].detach(), p["w_out"].detach()
        act = torch.square(torch.relu(
            gmm.grouped_mm(h, w_in, r.offsets, r.rows)))
        P = r.rows.numel()
        g_out = torch.randn((P, c["d"]), generator=gen, device=dev)
        g_act = torch.randn((P, c["f"]), generator=gen, device=dev)
        w_out_t = w_out.transpose(1, 2).contiguous()
    o = r.offsets.tolist()
    pairs = o[-1]
    written = torch.zeros((), dtype=torch.int64, device=dev)
    gmm.grouped_mm(h, w_in, r.offsets, r.rows, written)
    counted = int(written)
    log(f"  (b) {pairs} held pairs of {P} (segments {o}); the up kernel "
        f"counted {counted} rows written")
    if counted != pairs or pairs != int(r.held.sum()):
        raise AssertionError(f"phase 13: {counted} rows written, "
                             f"{pairs} pairs held, "
                             f"{int(r.held.sum())} routed")
    cases = [  # (name, kernel, kind, a, w or g, rows, K, N)
        ("up", "grouped_mm", "mm", h, w_in, r.rows, c["d"], c["f"]),
        ("down", "grouped_mm", "mm", act, w_out, None, c["f"], c["d"]),
        ("down input gradient", "grouped_mm", "mm", g_out, w_out_t, None,
         c["d"], c["f"]),
        ("up weight gradient", "grouped_mm_wgrad", "wgrad", h, g_act,
         r.rows, c["d"], c["f"]),
        ("down weight gradient", "grouped_mm_wgrad", "wgrad", act, g_out,
         None, c["f"], c["d"]),
    ]
    mm_fn = cuda.entry("grouped_mm", "grouped_mm_f32", gmm._MM_ARGTYPES)
    wg_fn = cuda.entry("grouped_mm", "grouped_wgrad_f32",
                       gmm._WGRAD_ARGTYPES)
    stream = torch.cuda.current_stream(dev).cuda_stream
    seg = pairs // c["held"]
    rows_out = []
    for name, kernel, kind, a, b, rows, K, N in cases:
        fn = gmm.grouped_mm if kind == "mm" else gmm.grouped_wgrad
        got = fn(a, b, r.offsets, rows).cpu()
        want = fn(a.cpu(), b.cpu(), r.offsets.cpu(),
                  None if rows is None else rows.cpu())
        chk = within(got, want, P13_RTOL * float(want.abs().max()))
        rp = rows.data_ptr() if rows is not None else None
        if kind == "mm":
            dst = torch.zeros((rows.numel() if rows is not None
                               else a.shape[0], N), device=dev)

            def launch(a=a, b=b, rp=rp, dst=dst, K=K, N=N):
                cuda.check("grouped_mm", mm_fn(
                    a.data_ptr(), rp, b.data_ptr(), dst.data_ptr(),
                    r.offsets.data_ptr(), None, c["held"], K, N,
                    dst.shape[0], a.stride(0), b.stride(0), b.stride(1),
                    stream))
            ea = torch.randn((c["held"], seg, K), generator=gen, device=dev)
            eb = torch.randn((c["held"], K, N), generator=gen, device=dev)
        else:
            dst = torch.empty((c["held"], K, N), device=dev)

            def launch(a=a, b=b, rp=rp, dst=dst, K=K, N=N):
                cuda.check("grouped_mm", wg_fn(
                    a.data_ptr(), rp, b.data_ptr(), dst.data_ptr(),
                    r.offsets.data_ptr(), c["held"], K, N, a.stride(0),
                    b.stride(0), stream))
            ea = torch.randn((c["held"], K, seg), generator=gen, device=dev)
            eb = torch.randn((c["held"], seg, N), generator=gen, device=dev)
        ms = timer(launch)
        plain = gmm.grouped_mm_plain if kind == "mm" \
            else gmm.grouped_wgrad_plain
        plain_ms = timer(lambda: plain(a, b, o, rows), iters=5)
        library_ms = timer(lambda: torch.bmm(ea, eb))
        bound_ms = 2.0 * pairs * K * N / f32_rate * 1e3
        row = {"kernel": kernel, "case": name, "pairs": pairs,
               "experts": c["held"], "K": K, "N": N, **chk, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": "ops",
               "share_of_bound": bound_ms / ms}
        rows_out.append(row)
        log(f"    {name}: err {chk['max_abs_err']:.2e} (tol "
            f"{chk['tol']:.2e}) {ms:.4f} ms, bound {bound_ms:.4f} "
            f"({100 * bound_ms / ms:.1f} %), plain {plain_ms:.4f}, "
            f"bmm over equal segments {library_ms:.4f}")
        del ea, eb, dst
    bad = [x for x in rows_out if not x["ok"]]
    if bad:
        raise AssertionError(f"phase 13: {len(bad)} grouped case(s) "
                             f"disagree with the plain version: {bad}")
    record = {"launches": launches, "pairs": pairs, "segments": o,
              "rows_written": counted, "ptxas": ptxas, "build_s": secs,
              "phase_s": time.perf_counter() - t_phase}
    log(f"  phase 13: {record['phase_s']:.1f} s")
    return rows_out, record


def _nano_kernels(rows, launches):
    """The kernels line's rows of the two grouped kernels: the up
    product's row and the up weight gradient's (the layer's first
    launch of each)."""
    out = []
    for name, case in (("grouped_mm", "up"),
                       ("grouped_mm_wgrad", "up weight gradient")):
        r = next(x for x in rows if x["case"] == case)
        out.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/grouped_mm.cu",
            "replaces": "none (the drop-free MoE's grouped products)",
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    return out


def main_nano(dev, smi, kind, f32_rate) -> int:
    """``chip_smoke.py --phase 13``: phase 13 alone."""
    log("phase 13: the drop-free MoE's grouped kernels at the Nemotron-H "
        "cell's shapes")
    rows, record = drive_nano_phase(dev, Timer(dev), f32_rate)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "phase13.json").write_text(json.dumps(
        {"card": smi, "kind": kind, "torch": torch.__version__,
         "phase13": record, "phase13_kernel_rows": rows}, indent=1,
        default=str))
    print(smi)
    print(json.dumps({"kernels": _nano_kernels(rows, record["launches"])}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


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

    if sys.argv[1:] == ["--phase", "13"]:
        OUT.mkdir(parents=True, exist_ok=True)
        return main_nano(dev, smi, kind, f32_rate)

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

    log("phase 8: sweeps through experiments.sweep (paper_table1 seeds "
        "0-2 x 4 rounds, vmap and sequential), kill and resume, the "
        "cohort threat path (100 UEs, 72 a round) and a cefl cohort run, "
        "two fuzzer draws")
    timer = Timer(dev)
    p_launches, p_shapes, p_records = drive_sweep_phase(dev, timer, bw,
                                                        f32_rate)
    del timer

    log("phase 9: mamba2-130m: served at full width and depth (bf16); "
        "2 layers card vs CPU; lm_smoke whole and lm_mamba2_130m at full "
        "width and depth (6 rounds) through experiments.run; both round "
        "kernels at the LM shapes")
    torch.cuda.empty_cache()
    l_launches, l_records = drive_lm_phase(dev, bw, f32_rate)

    log("phase 10: MoE, the flash backward and the encoder-decoder: "
        "jamba-v0.1-52b (16 layers) and llama4-maverick (one period) "
        "served at full width; whisper-medium trained at full width and "
        "depth through launch.train, then served; the flash backward at "
        "starcoder2-15b's attention shape; reduced configs card vs CPU")
    torch.cuda.empty_cache()
    timer = Timer(dev)
    x_launches, x_shapes, x_swa, x_records = drive_p10_phase(dev, timer)
    del timer

    log("phase 11: the sharded plane on ('dpu', 'rows') rank meshes: a "
        "one-rank NCCL group (1, 1) and a gloo group of 4 ranks on this "
        "card (2, 1), (1, 2), (2, 2), (4, 1): the sharded ops at the paper "
        "and LM planes, the engine (fednova), MeshExecutor(mesh_shape), "
        "the sequence-sharded decode")
    torch.cuda.empty_cache()
    h_launches, h_records = drive_mesh_phase(dev)

    log("phase 12: the five examples (python -m repro_torch.examples.*) "
        "through their main(argv): quickstart (and once through -m), the "
        "sanitizer through the front door, cefl_vs_baselines --full, "
        "mobility_demo, serve_lm on codeqwen1.5-7b (f32), train_lm_cefl "
        "--full")
    torch.cuda.empty_cache()
    e_launches, e_swa, e_shapes, e_lm_shapes, e_records = \
        drive_examples_phase(dev)

    log("phase 13: the drop-free MoE's grouped kernels at the Nemotron-H "
        "cell's shapes")
    torch.cuda.empty_cache()
    n_rows, n_record = drive_nano_phase(dev, Timer(dev), f32_rate)

    log(f"phase 4: kernels vs plain versions at the paths' shapes and extra "
        f"cases ({smi})")
    timer = Timer(dev)
    # each kernel at every shape any path launched it with
    checked = {"fedprox_accum": shapes["fedprox_accum"]
               + t_shapes["fedprox_accum"] + m_shapes["fedprox_accum"]
               + c_shapes["fedprox_accum"] + p_shapes["fedprox_accum"]
               + e_shapes["fedprox_accum"],
               "nova_aggregate": shapes["nova_aggregate"]
               + a_shapes["nova_aggregate"] + c_shapes["nova_aggregate"]
               + p_shapes["nova_aggregate"] + e_shapes["nova_aggregate"]}
    rows, main_rows = kernel_checks(dev, timer, bw, f32_rate, checked)
    r_rows, main_rows["robust_aggregate"] = robust_checks(
        dev, timer, bw, f32_rate, t_shapes["robust_aggregate"])
    crossover, network_faster = robust_crossover(dev, timer)
    s_rows, main_rows["nova_aggregate_stacked"] = stacked_checks(
        dev, timer, bw, f32_rate, m_shapes["nova_aggregate_stacked"]
        + e_shapes["nova_aggregate_stacked"])
    log("  nova_aggregate's launch plan against its neighbours (tile, "
        "bytes in flight, blocks an SM), per call")
    plan_sweep = nova_plan_sweep(dev, timer)
    u_rows, main_rows["fedprox_update"] = update_checks(
        dev, timer, bw, f32_rate, a_shapes["fedprox_update"])
    w_rows, main_rows["swa_decode_attention"] = swa_checks(
        dev, timer, bw, f32_rate, bf16_rate, s_shapes)
    log("  phase 10's path shapes: swa_decode_attention (its configs' "
        "heads), fedprox_accum and nova_aggregate_stacked (whisper-medium's "
        "plane and the reduced rounds; the stacked form at whisper's plane "
        "also as a run of 200)")
    x_rows = swa_checks(dev, timer, bw, f32_rate, bf16_rate, None,
                        cases=x_swa.cases())[0]
    x_rows += lm_kernel_checks(dev, timer, RunTimer(), bw, f32_rate,
                               x_shapes.shapes,
                               run_kernels=("nova_aggregate_stacked",))
    log("  phase 12's path shapes: swa_decode_attention at codeqwen1.5-7b's"
        " f32 decode (Hq = Hkv = 32, D 128, G 1), both timers and SDPA; "
        "fedprox_accum and nova_aggregate_stacked at train_lm_cefl's plane "
        "(the CE-FL examples' round kernels are in the rows above)")
    e_rows = swa_checks(dev, timer, bw, f32_rate, bf16_rate, None,
                        cases=e_swa.cases(), run_timer=RunTimer())[0]
    for r in e_rows:
        log(f"    run of 200: {r['run_ms'] * 1e3:.2f} us a launch")
    e_lm_rows = lm_kernel_checks(dev, timer, None, bw, f32_rate,
                                 e_lm_shapes)
    rows += r_rows + s_rows + u_rows + w_rows + x_rows + e_rows + e_lm_rows
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"{len(bad)} kernel case(s) disagree with the "
                             f"plain version: {bad}")
    log("  the main rows timed again as runs of 200 launches between one "
        "event pair (inputs rotated over copies past 2 x L2), beside the "
        "per-call timer's floor")
    run_ms, floor = run_column(dev, main_rows, timer, RunTimer(), rows)
    del timer
    for name, r in main_rows.items():
        r.setdefault("run_ms", run_ms[name])
    log("  every timed row above the empty kernel (per call, and per launch "
        "in a run of 200 where the row has one) beside its bound; phase 9's"
        " rows at the end")
    floor_rows = above_floor(rows + l_records["kernel_rows"], floor)

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
                c_launches, p_launches, l_launches, x_launches,
                h_launches, e_launches)),
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    kernels += _nano_kernels(n_rows, n_record["launches"])
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
        "above_floor": floor_rows, "nova_plan_sweep": plan_sweep,
        "cefl_rounds": c_records, "cefl_launches": c_launches,
        "cefl_launch_shapes": {k: [list(key) + [n] for key, n in c.items()]
                               for k, c in c_shapes.items()},
        "cefl_estimate_s": c_estimate, "cefl_solve_check": c_check,
        "phase8": p_records, "phase8_launches": p_launches,
        "phase8_launch_shapes": {k: [list(key) + [n] for key, n in c.items()]
                                 for k, c in p_shapes.items()},
        "phase9": l_records, "phase9_launches": l_launches,
        "phase10": x_records, "phase10_launches": x_launches,
        "phase10_launch_shapes": {
            k: [list(key) + [n] for key, n in c.items()]
            for k, c in x_shapes.shapes.items()},
        "phase10_swa_cases": [list(c) for c in x_swa.cases()],
        "phase10_kernel_rows": x_rows,
        "phase11": h_records, "phase11_launches": h_launches,
        "phase12": e_records, "phase12_launches": e_launches,
        "phase12_swa_cases": [list(c) for c in e_swa.cases()],
        "phase12_kernel_rows": e_rows + e_lm_rows,
        "phase12_launch_shapes": {
            part: {k: [list(key) + [n] for key, n in c.items()]
                   for k, c in sh.items()}
            for part, sh in (("cefl_examples", e_shapes),
                             ("train_lm_cefl", e_lm_shapes))},
        "phase13": n_record, "phase13_kernel_rows": n_rows,
        "seconds": time.perf_counter() - t_start}, indent=1, default=str))
    full, check = l_records["lm_mamba2_130m"], l_records["check"]
    log(f"phase 9 summary: lm_mamba2_130m loss {full['losses'][0]:.4f} -> "
        f"{full['losses'][-1]:.4f}, {full['round_s_median_after_first']:.3f}"
        f" s a round, {full['train_tokens_per_s']:.0f} tokens/s, peak "
        f"{full['peak_device_bytes'] / 2**30:.2f} GiB; card vs CPU logits "
        f"{check['serve_logits_max_abs_err']:.2e}, round "
        f"{check['round_max_abs_err']:.2e}; "
        + "; ".join(f"{r['kernel']} {r['ms']:.4f} ms (bound "
                    f"{r['bound_ms']:.4f})" for r in l_records["kernel_rows"]
                    if r["R"] == full["R"]))
    wt, fl = x_records["whisper_train"], x_records["flash"]
    log("phase 10 summary: " + "; ".join(
        f"{a} x{x_records[a]['layers']} decode "
        f"{x_records[a]['runs'][0]['decode_ms_median']:.2f} ms/step "
        f"({x_records[a]['runs'][0]['launches_per_step']:.0f} swa "
        f"launches a step), prefill {x_records[a]['runs'][0]['prefill_s']:.3f}"
        f" s" for a in (a for a, *_ in P10_SERVE))
        + f"; whisper-medium loss {wt['losses'][0]:.4f} -> "
        f"{wt['losses'][-1]:.4f}, {wt['round_s_median_after_first']:.3f} s "
        f"a round, {wt['train_tokens_per_s']:.0f} tokens/s, device busy "
        f"{100 * wt['round_profile']['busy_share']:.1f} %, serve decode "
        f"{x_records['whisper_serve']['runs'][0]['decode_ms_median']:.2f} "
        f"ms/step; flash dq err {fl['errors']['dq']['max_abs_err']:.2e}")
    eng = h_records["engine"]
    log("phase 11 summary: ops bitwise at every mesh (psum within rtol "
        "1e-6); engine " + "; ".join(
            f"{k} {v['verdict']} ({v['s']:.2f} s vs {v['single_s']:.2f})"
            for k, v in eng.items())
        + f"; MeshExecutor (2, 2) params err "
        f"{h_records['mesh_executor']['params_max_abs_err']:.1e}; "
        f"seq-sharded decode vs plain "
        + ", ".join(f"{v['vs_plain']['max_abs_err']:.2e}"
                    for v in h_records["decode"].values())
        + f"; lm_decode_step logits err "
        f"{h_records['lm_decode']['logits_max_abs_err']:.2e}; launches "
        f"{h_launches}")
    cv, mb = e_records["cefl_vs_baselines"], e_records["mobility_demo"]
    sv, tr = e_records["serve_lm"], e_records["train_lm_cefl"]
    log("phase 12 summary: " + f"{e_records['phase_s']:.1f} s; quickstart "
        f"{e_records['quickstart']['s']:.1f} s (-m "
        f"{e_records['quickstart_m_s']:.1f} s); cefl_vs_baselines --full "
        f"{cv['s']:.1f} s, energy " + ", ".join(
            f"{k} {v['cum_energy']:.1f} J" for k, v in cv["final"].items())
        + f"; mobility_demo {mb['s']:.1f} s, {mb['cefl_migrations']} "
        f"migrations, {mb['cefl_handovers']} handovers; serve_lm "
        f"{sv['arch']} decode {sv['decode_s_15_steps'] / 15 * 1e3:.2f} "
        f"ms/step, swa " + ", ".join(
            f"len {r['cache_len']} {r['ms'] * 1e3:.2f} / "
            f"{r['run_ms'] * 1e3:.2f} us (bound {r['bound_ms'] * 1e3:.2f}, "
            f"SDPA {r['library_ms'] * 1e3:.2f})" for r in e_rows)
        + f"; train_lm_cefl --full loss {tr['losses'][0]:.4f} -> "
        f"{tr['losses'][-1]:.4f}; launches {e_launches}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
