"""The reader of ``sim.offload_copy_x`` on hand-built spans: the counts of
the window's ``engine.offload`` spans summed, spans that start outside
the window left out, and None where no split counts its bytes (a program
without the counters, or without the recorder)."""
from __future__ import annotations

import sys

import pytest

from bench import run
from bench.trace import TraceData
from repro_torch import tracing
from repro_torch.tracing import Span

METRIC = "sim.offload_copy_x"
WINDOW = (10.0, 20.0)


def _data():
    return TraceData(spans=[], counters={}, launches=[],
                     records=[("gemv", 11.0, 11.1)], rounds=[3, 4],
                     window=WINDOW, config={}, workload={}, completeness={})


def _program(monkeypatch, rows):
    spans = [Span(n, t0, t1, -1, 0, dict(a)) for n, t0, t1, a in rows]
    monkeypatch.setattr(tracing, "spans", lambda: spans)


COUNTED = [
    ("engine.offload", 9.0, 9.5, {"offload_bytes": 900, "round_bytes": 100}),
    ("engine.offload", 11.0, 11.5, {"offload_bytes": 300,
                                    "round_bytes": 200}),
    ("executor.stage", 11.5, 12.0, {"h2d_bytes": 5000}),
    ("engine.offload", 15.0, 15.5, {"offload_bytes": 700,
                                    "round_bytes": 600}),
    ("engine.offload", 16.0, None, {"offload_bytes": 900,
                                    "round_bytes": 100}),
    ("engine.offload", 20.0, 20.5, {"offload_bytes": 900,
                                    "round_bytes": 100}),
]


@pytest.mark.parametrize("rows,want", [
    (COUNTED, 1000 / 800),
    ([r for r in COUNTED if r[3].get("round_bytes") != 600], 1.5),
    ([("engine.offload", 12.0, 12.5, {"offload_bytes": 400,
                                      "round_bytes": 400})], 1.0),
], ids=["summed", "one_split", "one_copy"])
def test_reader_value(rows, want, monkeypatch):
    _program(monkeypatch, rows)
    assert run.read_layer_metric(METRIC, _data()) == \
        pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("rows", [
    [], [r for r in COUNTED if not WINDOW[0] <= r[1] < WINDOW[1]],
    [("engine.offload", 11.0, 11.5, {}),
     ("engine.offload", 15.0, 15.5, {})],
], ids=["no_spans", "outside_the_window", "without_the_counts"])
def test_reader_without_counted_splits(rows, monkeypatch):
    _program(monkeypatch, rows)
    assert run.read_layer_metric(METRIC, _data()) is None


def test_reader_without_the_recorder(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert run.read_layer_metric(METRIC, _data()) is None


def test_entry():
    spec = run.load_cell("paper_mlp.greedy")[0]
    m = {m["name"]: m for m in spec["per_layer"]}[METRIC]
    assert (m["source"], m["moves"], m["unit"], m["better"]) == \
        ("program_counter", "sim_round_s", "ratio", "lower")
    assert m["workloads"] == ["paper_mlp.cefl", "paper_mlp.greedy"]
    for cell in m["workloads"]:
        assert m in run.cell_metrics(spec["per_layer"], cell)
