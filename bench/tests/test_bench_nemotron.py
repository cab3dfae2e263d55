"""The Nemotron-H cell (``nemotron3_nano_30b_a3b.b4s4k``): a whole run at a
CPU test's size judged correct, runs with the program's router broken
judged not correct, the frozen operation counts against a count by hand,
and the cell's per-layer readers on synthetic traces."""
from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from bench import nemotron_flops as nf
from bench import run
from bench.roofline import PEAK_F32_FLOPS, PEAK_HBM_BYTES
from bench.trace import Span, TraceData

ROOT = Path(__file__).resolve().parents[2]
CELL = "nemotron3_nano_30b_a3b.b4s4k"
SEED = 2 ** 31 + 91


def tiny():
    """The cell cut to a CPU test's widths (the limits as committed)."""
    spec, cell, config, workload = run.load_cell(CELL)
    config, workload = copy.deepcopy(config), copy.deepcopy(workload)
    config.update(hidden_size=64, mamba_num_heads=8, mamba_head_dim=16,
                  n_groups=2, ssm_state_size=16, chunk_size=16,
                  ssd_block=16, num_attention_heads=4,
                  num_key_value_heads=2, head_dim=16,
                  moe_intermediate_size=32,
                  moe_shared_expert_intermediate_size=48, router_experts=16,
                  n_routed_experts=4, num_experts_per_tok=3, vocab_size=256)
    workload.update(batch=4, seq=32)
    return spec, cell, config, workload


def measure(seconds=1.0):
    spec, cell, config, workload = tiny()
    return run.measure(CELL, SEED, seconds, False, spec=spec, cell=cell,
                       config=config, workload=workload,
                       device=torch.device("cpu"))


def test_sound_run():
    res = measure()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert {"setup_s", "lm_train_tokens_per_s"} <= set(res["metrics"])
    assert res["checks"]["moe_dropped"] == [0, 0]


def test_dropped_pairs_are_not_correct(monkeypatch):
    """An up product that leaves the last held expert's pairs out: the
    program's own count of rows written falls short of its routing."""
    from repro_torch.kernels import grouped_mm as gmm
    real = gmm.grouped_mm

    def lossy(a, w, offsets, rows=None, written=None):
        cut = offsets.clone()
        cut[-1] = cut[-2]
        return real(a, w, cut, rows, written)
    monkeypatch.setattr(gmm, "grouped_mm", lossy)
    res = measure(0.2)
    assert not res["correct"] and res["checks"]["moe_dropped"][0] > 0


def test_program_coefs_are_the_programs():
    """The diagnostic's coefficients equal the round step's own."""
    from bench.drivers.nemotron_train import program_coefs
    from repro_torch.core import round_step as rs
    a, a_sum = program_coefs(2, 3e-2, 0.01, torch.device("cpu"))
    g = torch.tensor([2])
    assert a_sum == float(rs.a_l1(g, 3e-2, 0.01)[0])
    assert a == [float(rs._a_k(g, k, 3e-2, 0.01)[0]) for k in range(2)]
    assert abs(a_sum / 1.9997 - 1.0) > 1e-5      # the cancellation


@pytest.mark.parametrize("fault", [{"routed_scale": 1.0},
                                   {"expert_offset": 1}],
                         ids=["no_scale", "wrong_share"])
def test_broken_router_is_not_correct(fault, monkeypatch):
    """The program routed wrongly: gates without the routed scale, or
    the held experts' weights read as the next experts'."""
    from repro_torch.models import moe
    route = moe.dropless_route
    monkeypatch.setattr(moe, "dropless_route", lambda r, h, m: route(
        r, h, dataclasses.replace(m, **fault)))
    assert not measure(0.2)["correct"]


def test_flop_count_by_hand():
    m = json.loads((ROOT / "bench" / "configs" /
                    "nemotron3_nano_30b_a3b.json").read_text())
    d, V, S = 2688, 16384, 4096
    mamba = 2 * d * (2 * 4096 + 2 * 8 * 128 + 64) + 2 * 4096 * d \
        + 2 * 128 * 128 * 8 + 2 * 128 * 64 * 64 + 4 * 64 * 64 * 128
    attn = 2 * d * (32 + 4) * 128 + 2 * 32 * 128 * d + 2 * 32 * 128 * S
    moe = 2 * d * 128 + 4 * d * 3712
    want = 3 * mamba + 3 * moe + attn + 2 * d * V
    assert nf.dense_forward_flops_per_token(m, S) == want
    assert nf.routed_flops(m, 10) == 10 * 4 * d * 1856
    assert nf.train_flops(m, S, 32768, 24576) == \
        3 * (want * 32768 + 24576 * 4 * d * 1856)
    # about 1.6 GFLOP a token's training outside the routed experts
    assert 1.5e9 < 3 * want < 1.7e9


def _reader(name):
    path = ROOT / "bench" / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.fixture
def program_spans(monkeypatch):
    """Program spans for the readers, in place of the recorder's."""
    from repro_torch import tracing
    held = []
    monkeypatch.setattr(tracing, "spans", lambda: list(held))
    return held


def _span(name, t0, **attrs):
    from repro_torch.tracing import Span as PSpan
    return PSpan(name, t0, t0 + 0.01, -1, 0, attrs)


def test_grouped_roofline_reader(program_spans):
    up = dict(kind="mm", pairs=6144, experts=16, K=2688, N=1856)
    wg = dict(kind="wgrad", pairs=6144, experts=16, K=2688, N=1856)
    program_spans += [_span("moe.grouped", 0.1, **up),
                      _span("moe.grouped", 0.2, **up),
                      _span("moe.grouped", 0.3, **wg)]
    b_up = max(2 * 6144 * 2688 * 1856 / PEAK_F32_FLOPS,
               4 * (6144 * 2688 + 6144 * 1856 + 16 * 2688 * 1856)
               / PEAK_HBM_BYTES)
    assert b_up == nf.grouped_bound_seconds(up)
    recs = [("grouped_mm_kernel", 0.1, 0.1 + 2 * b_up),
            ("grouped_mm_kernel", 0.2, 0.2 + 2 * b_up),
            ("grouped_wgrad_kernel", 0.3, 0.3 + 4 * b_up)]
    data = TraceData([], {}, [], recs, [0], (0.0, 1.0), {}, {}, {})
    read = _reader("nano.moe_grouped_roofline")
    assert abs(read(data) - 100 * 3 * b_up / (8 * b_up)) < 1e-9
    # a record the profiler dropped: the kind's mean bound, once a record
    data.records = recs[1:]
    assert abs(read(data) - 100 * 2 * b_up / (6 * b_up)) < 1e-9
    data.records = []
    assert read(data) is None


def test_counter_and_span_readers(program_spans):
    m = json.loads((ROOT / "bench" / "configs" /
                    "nemotron3_nano_30b_a3b.json").read_text())
    wl = json.loads((ROOT / "bench" / "workloads" /
                     f"{CELL}.json").read_text())
    program_spans += [
        _span("moe.counts", 0.5, moe_pairs_held=1000, moe_load_max=1.5,
              moe_dropped=0),
        _span("moe.counts", 1.5, moe_pairs_held=3000, moe_load_max=1.25,
              moe_dropped=0),
        _span("mamba.ssd", 0.2), _span("mamba.ssd", 1.2),
        _span("mamba.ssd", 5.0)]                    # outside the window
    data = TraceData([Span("round", 0.0, 1.0, 0), Span("round", 1.0, 2.0,
                                                       1)],
                     {0: {"tokens": 100}, 1: {"tokens": 300}}, [],
                     [("k", 0.0, 1.0)], [0, 1], (0.0, 2.0), m, wl, {})
    assert _reader("nano.moe_load_max")(data) == 1.375
    assert abs(_reader("nano.ssd_s")(data) - 0.01) < 1e-12
    want = 100 * nf.train_flops(m, 4096, 400, 4000) / 2.0 / PEAK_F32_FLOPS
    assert abs(_reader("nano.mfu")(data) - want) < 1e-9 * want
    program_spans.clear()
    assert _reader("nano.mfu")(data) is None
    assert _reader("nano.moe_load_max")(data) is None
