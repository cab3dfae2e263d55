"""The reader of ``lm.grad_plane_x`` on hand-built spans: the counts of
the window's ``round_step.backward`` spans summed, spans that start
outside the window left out, and None where no backward counts its plane
(a program without the counters, or without the recorder)."""
from __future__ import annotations

import sys
import time

import pytest
import torch

from bench import run
from bench.trace import TraceData
from repro_torch import tracing
from repro_torch.core import round_step as rs
from repro_torch.kernels.plane import ParamPlane
from repro_torch.tracing import Span

METRIC = "lm.grad_plane_x"
WINDOW = (10.0, 20.0)
CELLS = ["mamba2_130m.b8", "mamba2_130m.b32", "nemotron3_nano_30b_a3b.b4s4k"]


def _data(window=WINDOW):
    return TraceData(spans=[], counters={}, launches=[],
                     records=[("gemm", 11.0, 11.1)], rounds=[3, 4],
                     window=window, config={}, workload={}, completeness={})


def _program(monkeypatch, rows):
    spans = [Span(n, t0, t1, -1, 0, dict(a)) for n, t0, t1, a in rows]
    monkeypatch.setattr(tracing, "spans", lambda: spans)


COUNTED = [
    ("round_step.backward", 9.0, 9.5, {"grad_plane_bytes": 5300,
                                       "plane_bytes": 100}),
    ("round_step.backward", 11.0, 11.5, {"grad_plane_bytes": 100,
                                         "plane_bytes": 100}),
    ("round_step.forward", 11.5, 12.0, {"grad_plane_bytes": 900}),
    ("round_step.backward", 15.0, 15.5, {"grad_plane_bytes": 500,
                                         "plane_bytes": 100}),
    ("round_step.backward", 16.0, None, {"grad_plane_bytes": 900,
                                         "plane_bytes": 100}),
    ("round_step.backward", 20.0, 20.5, {"grad_plane_bytes": 900,
                                         "plane_bytes": 100}),
]


@pytest.mark.parametrize("rows,want", [
    (COUNTED, 600 / 200),
    ([r for r in COUNTED if r[3].get("grad_plane_bytes") != 500], 1.0),
    ([("round_step.backward", 12.0, 12.5, {"grad_plane_bytes": 5300,
                                           "plane_bytes": 100})], 53.0),
], ids=["summed", "one_write", "slice_path"])
def test_reader_value(rows, want, monkeypatch):
    _program(monkeypatch, rows)
    assert run.read_layer_metric(METRIC, _data()) == \
        pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("rows", [
    [], [r for r in COUNTED if not WINDOW[0] <= r[1] < WINDOW[1]],
    [("round_step.backward", 11.0, 11.5, {}),
     ("round_step.backward", 15.0, 15.5, {})],
], ids=["no_spans", "outside_the_window", "without_the_counts"])
def test_reader_without_counted_backwards(rows, monkeypatch):
    _program(monkeypatch, rows)
    assert run.read_layer_metric(METRIC, _data()) is None


def test_reader_without_the_recorder(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert run.read_layer_metric(METRIC, _data()) is None


def test_entry():
    spec = run.load_cell(CELLS[-1])[0]
    m = {m["name"]: m for m in spec["per_layer"]}[METRIC]
    assert (m["source"], m["moves"], m["unit"], m["better"]) == \
        ("program_span", "lm_train_tokens_per_s", "x", "lower")
    assert m["workloads"] == CELLS
    for cell in m["workloads"]:
        assert m in run.cell_metrics(spec["per_layer"], cell)


def test_a_traced_round_step_reads_one():
    """The program's own round step, traced on the CPU, reads 1.0."""
    tree = {"w": torch.randn(2, 3, 4), "b": torch.randn(2, 4)}
    plane = ParamPlane.from_tree({k: v[0] for k, v in tree.items()})
    params = ParamPlane(plane.broadcast(2).data.contiguous(), plane.spec)

    def loss_fn(p, batch, mask):
        out = torch.einsum("gbi,gio->gbo", batch["x"], p["w"]) \
            + p["b"][:, None]
        return ((out ** 2).mean(-1) * mask).sum(-1)
    step = rs.build_cefl_round_step(loss_fn, rs.CEFLHyper(gamma_max=2))
    batch = {"x": torch.randn(2, 1, 5, 3)}
    tracing.clear()
    tracing.enable()
    try:
        t0 = time.perf_counter()
        step(params, batch, rs.make_dpu_meta(2, device="cpu"))
        window = (t0, time.perf_counter())
        assert run.read_layer_metric(METRIC, _data(window)) == 1.0
    finally:
        tracing.disable()
        tracing.clear()
