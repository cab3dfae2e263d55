"""The reader of ``sim.sca_graph_share`` on hand-built spans: replays over
all outer steps of the window's ``sca.solve`` spans, spans that start
outside the window left out, and None where no solve counts its outer
steps (a program without the graph's counters, or without the recorder)."""
from __future__ import annotations

import sys

import pytest

from bench import run
from bench.trace import TraceData
from repro_torch import tracing
from repro_torch.tracing import Span

METRIC = "sim.sca_graph_share"
WINDOW = (10.0, 20.0)


def _data():
    return TraceData(spans=[], counters={}, launches=[],
                     records=[("gemv", 11.0, 11.1)], rounds=[3, 4],
                     window=WINDOW, config={}, workload={}, completeness={})


def _program(monkeypatch, rows):
    spans = [Span(n, t0, t1, -1, 0, dict(a)) for n, t0, t1, a in rows]
    monkeypatch.setattr(tracing, "spans", lambda: spans)


COUNTED = [
    ("sca.solve", 9.0, 9.5, {"graph_replays": 0, "eager_outer": 9}),
    ("sca.solve", 11.0, 12.0, {"graph_replays": 4, "graph_captures": 1,
                               "eager_outer": 0}),
    ("sca.solve", 15.0, 15.5, {"graph_replays": 0, "eager_outer": 2}),
    ("sca.solve", 16.0, 16.5, {"graph_replays": 2, "eager_outer": 0}),
    ("sca.outer", 11.0, 11.5, {"graph_replays": 50}),
    ("sca.solve", 20.0, 20.5, {"graph_replays": 0, "eager_outer": 9}),
]


@pytest.mark.parametrize("rows,want", [
    (COUNTED, 75.0),
    ([r for r in COUNTED if r[3].get("eager_outer") != 2], 100.0),
    ([("sca.solve", 11.0, 12.0, {"graph_replays": 0, "eager_outer": 4})],
     0.0),
], ids=["mixed", "all_replayed", "all_eager"])
def test_reader_value(rows, want, monkeypatch):
    _program(monkeypatch, rows)
    assert run.read_layer_metric(METRIC, _data()) == \
        pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("rows", [
    [], [r for r in COUNTED if not WINDOW[0] <= r[1] < WINDOW[1]],
    [("sca.solve", 11.0, 12.0, {"pd_live": 32, "pd_run": 32})],
], ids=["no_spans", "outside_the_window", "without_the_counts"])
def test_reader_without_counted_solves(rows, monkeypatch):
    _program(monkeypatch, rows)
    assert run.read_layer_metric(METRIC, _data()) is None


def test_reader_without_the_recorder(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert run.read_layer_metric(METRIC, _data()) is None


def test_entry():
    spec = run.load_cell("paper_mlp.cefl")[0]
    m = {m["name"]: m for m in spec["per_layer"]}[METRIC]
    assert (m["source"], m["moves"], m["workloads"], m["unit"]) == \
        ("program_span", "sim_round_s", ["paper_mlp.cefl"], "%")
    assert m in run.cell_metrics(spec["per_layer"], "paper_mlp.cefl")
