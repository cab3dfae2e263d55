"""The Moonlight cell (``moonlight_16b_a3b.b2s8k``): a whole run at a CPU
test's size judged correct, runs with the program's layers broken judged
not correct, the planted faults of the reference failing, the weights in
the program's tree, the frozen operation counts against a count by hand,
and the cell's per-layer readers on synthetic traces."""
from __future__ import annotations

import copy
import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from bench import moonlight_flops as mf
from bench import moonlight_inputs as mi
from bench import nemotron_flops as nf
from bench import run
from bench.roofline import PEAK_F32_FLOPS
from bench.trace import Span, TraceData

ROOT = Path(__file__).resolve().parents[2]
CELL = "moonlight_16b_a3b.b2s8k"
SEED = 2 ** 31 + 77


def tiny():
    """The cell cut to a CPU test's widths (the limits as committed)."""
    spec, cell, config, workload = run.load_cell(CELL)
    config, workload = copy.deepcopy(config), copy.deepcopy(workload)
    config.update(hidden_size=64, num_attention_heads=4,
                  num_key_value_heads=4, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=12, kv_lora_rank=16,
                  intermediate_size=96, moe_intermediate_size=16,
                  router_experts=16, n_routed_experts=4,
                  num_experts_per_tok=3, num_hidden_layers=3,
                  vocab_size=256, attn_block=8)
    workload.update(seq=32)
    return spec, cell, config, workload


def measure(seconds=1.0, trace=False):
    spec, cell, config, workload = tiny()
    return run.measure(CELL, SEED, seconds, trace, spec=spec, cell=cell,
                       config=config, workload=workload,
                       device=torch.device("cpu"))


def test_sound_run():
    res = measure()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert {"setup_s", "lm_train_tokens_per_s"} <= set(res["metrics"])
    assert res["checks"]["moe_dropped"] == [0, 0]


def test_weights_have_the_programs_tree():
    """The drawn weights have the program's leaves, shapes and plane."""
    from repro_torch.kernels.plane import tree_paths
    from repro_torch.models import lm as L
    _, _, config, _ = tiny()
    cfg = mi.model_config(config)
    want = L.init_lm_params(torch.Generator().manual_seed(0), cfg,
                            torch.float32)
    got = mi.weights(config, 5, torch.device("cpu"))
    assert [(p, tuple(x.shape)) for p, x in tree_paths(got)] == \
        [(p, tuple(x.shape)) for p, x in tree_paths(want)]
    # the analytic count holds all 16 routed experts, the file 4 of them
    total = sum(x.numel() for _, x in tree_paths(got))
    assert cfg.param_count() == total - 64 + 2 * 12 * 3 * 64 * 16


@pytest.mark.parametrize("fault", [
    {"routed_scale": 1.0}, {"expert_offset": 1}],
    ids=["no_scale", "wrong_share"])
def test_broken_router_is_not_correct(fault, monkeypatch):
    """The program routed wrongly: gates without the routed scale, or
    the held experts' weights read as the next experts'."""
    from repro_torch.models import moe
    route = moe.dropless_route
    monkeypatch.setattr(moe, "dropless_route", lambda r, h, m: route(
        r, h, dataclasses.replace(m, **fault)))
    assert not measure(0.2)["correct"]


def test_unnormed_latent_is_not_correct(monkeypatch):
    """The program's MLA without its latent RMSNorm."""
    from repro_torch.models import blocks
    real = blocks.rms_norm
    monkeypatch.setattr(blocks, "rms_norm", lambda x, w, eps=1e-5:
                        x if x.shape[-1] == 16 else real(x, w, eps))
    assert not measure(0.2)["correct"]


@pytest.mark.parametrize("mode", ["scale", "rope_nope", "no_kv_norm",
                                  "relu2", "no_scale", "half_batch"])
def test_planted_faults_fail(mode):
    """Each planted fault of the reference reads above a committed limit
    where the sound program reads under them."""
    from bench.drivers.moonlight_train import make
    from bench.trace import Tracer
    _, _, config, workload = tiny()
    r = make(config, workload, SEED, torch.device("cpu"), Tracer(False))
    r.setup()
    got = r.readings(mode)
    limits = workload["limits"]
    assert any(got[k] > limits[k] for k in limits if k in got), got


def test_flop_count_by_hand():
    m = json.loads((ROOT / "bench" / "configs" /
                    "moonlight_16b_a3b.json").read_text())
    d, H, V, S = 2048, 16, 20480, 8192
    proj = 2 * d * H * 192 + 2 * d * 576 + 2 * 512 * H * 256 + 2 * H * 128 * d
    core = 2 * H * (192 + 128) * S / 2
    assert abs(proj / 1e6 - 27.5) < 0.05 and abs(core / 1e6 - 41.9) < 0.05
    want = 6 * (proj + core) + 6 * d * 11264 \
        + 5 * (2 * d * 64 + 6 * d * 2816) + 2 * d * V
    assert mf.dense_forward_flops_per_token(m, S) == want
    assert mf.routed_flops(m, 10) == 10 * 6 * d * 1408
    assert mf.train_flops(m, S, 32768, 122880) == \
        3 * (want * 32768 + 122880 * 6 * d * 1408)
    # about 86 TFLOP a round at even load (0.75 held pairs a token a layer)
    assert 84e12 < mf.train_flops(m, S, 32768, 32768 * 0.75 * 5) < 88e12


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
    """The gate-up launch at N = 2 x 1,408, the down launch and a weight
    gradient, each at its own bound."""
    gu = dict(kind="mm", pairs=6144, experts=8, K=2048, N=2816)
    dn = dict(kind="mm", pairs=6144, experts=8, K=1408, N=2048)
    wg = dict(kind="wgrad", pairs=6144, experts=8, K=2048, N=2816)
    program_spans += [_span("moe.grouped", 0.1, **gu),
                      _span("moe.grouped", 0.2, **dn),
                      _span("moe.grouped", 0.3, **wg)]
    b = [nf.grouped_bound_seconds(x) for x in (gu, dn, wg)]
    assert b[0] == 2 * 6144 * 2048 * 2816 / PEAK_F32_FLOPS
    recs = [("grouped_mm_kernel", 0.1, 0.1 + 2 * b[0]),
            ("grouped_mm_kernel", 0.2, 0.2 + 2 * b[1]),
            ("grouped_wgrad_kernel", 0.3, 0.3 + 4 * b[2])]
    data = TraceData([], {}, [], recs, [0], (0.0, 1.0), {}, {}, {})
    read = _reader("moon.moe_grouped_roofline")
    want = 100 * sum(b) / (2 * b[0] + 2 * b[1] + 4 * b[2])
    assert abs(read(data) - want) < 1e-9 * want
    data.records = []
    assert read(data) is None


def test_counter_and_span_readers(program_spans):
    m = json.loads((ROOT / "bench" / "configs" /
                    "moonlight_16b_a3b.json").read_text())
    wl = json.loads((ROOT / "bench" / "workloads" /
                     f"{CELL}.json").read_text())
    program_spans += [
        _span("moe.counts", 0.5, moe_pairs_held=1000, moe_load_max=1.5,
              moe_dropped=0),
        _span("moe.counts", 1.5, moe_pairs_held=3000, moe_load_max=1.25,
              moe_dropped=0),
        _span("attn.mla", 0.2), _span("attn.mla", 1.2),
        _span("attn.mla", 5.0)]                     # outside the window
    data = TraceData([Span("round", 0.0, 1.0, 0), Span("round", 1.0, 2.0,
                                                       1)],
                     {0: {"tokens": 100}, 1: {"tokens": 300}}, [],
                     [("k", 0.0, 1.0)], [0, 1], (0.0, 2.0), m, wl, {})
    assert _reader("moon.moe_load_max")(data) == 1.375
    assert abs(_reader("moon.mla_s")(data) - 0.01) < 1e-12
    want = 100 * mf.train_flops(m, 8192, 400, 4000) / 2.0 / PEAK_F32_FLOPS
    assert abs(_reader("moon.mfu")(data) - want) < 1e-9 * want
    program_spans.clear()
    for name in ("moon.mfu", "moon.moe_load_max", "moon.mla_s"):
        assert _reader(name)(data) is None
