"""The readers of the program's own spans (``bench/program_spans.py`` and
the metrics that read it) on hand-built traces: each gives the value
computed by hand, leaves out spans that start outside the traced window,
and returns None where its spans are absent, as in a program without the
recorder.  On a card, a short traced run of a cell reports every such
metric the cell lists."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from bench import run
from bench.trace import TraceData
from repro_torch import tracing
from repro_torch.tracing import Span

WINDOW = (10.0, 20.0)
ROUNDS = [3, 4]
RECORDS = [("gemv", 11.0, 11.1), ("Memcpy HtoD", 11.2, 11.3),
           ("reduce", 11.9, 12.2),       # starts inside the first solve
           ("gemv", 12.5, 12.6),         # between the solves
           ("gemv", 15.0, 15.1)]         # inside the second solve

# name, t0, t1, attrs: spans inside the window, then one of each name
# starting outside it (before and after), which no reader may count
INSIDE = [
    ("scenario.step", 10.0, 10.5, {}), ("scenario.step", 14.0, 14.25, {}),
    ("engine.offload", 10.5, 10.75, {}), ("engine.offload", 14.5, 15.5, {}),
    ("executor.stage", 12.0, 12.125, {"h2d_bytes": 3_000_000}),
    ("executor.stage", 16.0, 16.5, {"h2d_bytes": 1_000_000}),
    ("executor.train", 12.125, 13.0, {}), ("executor.train", 17.0, 17.5, {}),
    ("sca.solve", 11.0, 12.0, {"pd_live": 12, "pd_run": 32}),
    ("sca.solve", 15.0, 15.5, {"pd_live": 20, "pd_run": 32}),
    ("sca.outer", 11.0, 11.5, {}), ("sca.outer", 15.0, 15.25, {}),
    ("sca.sync", 11.5, 11.75, {}), ("sca.sync", 15.25, 15.375, {}),
    ("round_step.forward", 10.0, 10.5, {}),
    ("round_step.forward", 14.0, 14.25, {}),
    ("round_step.backward", 10.5, 11.5, {}),
    ("round_step.backward", 14.25, 15.0, {}),
]
OUTSIDE = [(name, t0, t0 + 0.5, {"h2d_bytes": 7, "pd_live": 7, "pd_run": 9})
           for name in {s[0] for s in INSIDE} for t0 in (9.0, 20.0)]

EXPECTED = {
    "sim.scenario_s": 0.75,
    "sim.realize_s": 1.25,
    "sim.stage_s": 0.625,
    "sim.h2d_mb": 4.0 / len(ROUNDS),
    "sim.train_s": 1.375,
    "sim.sca_enqueue_s": 0.75,
    "sim.sca_sync_s": 0.375,
    "sim.sca_pd_live": 50.0,
    "sim.sca_launches": (3 + 1) / 2,
    "lm.forward_s": 0.75 / len(ROUNDS),
    "lm.backward_s": 1.75 / len(ROUNDS),
}


def _data():
    return TraceData(spans=[], counters={}, launches=[], records=RECORDS,
                     rounds=ROUNDS, window=WINDOW, config={}, workload={},
                     completeness={})


def _program(monkeypatch, rows):
    spans = [Span(n, t0, t1, -1, 0, dict(a)) for n, t0, t1, a in rows]
    monkeypatch.setattr(tracing, "spans", lambda: spans)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_value(metric, monkeypatch):
    _program(monkeypatch, OUTSIDE[:len(OUTSIDE) // 2] + INSIDE
             + OUTSIDE[len(OUTSIDE) // 2:])
    assert run.read_layer_metric(metric, _data()) == \
        pytest.approx(EXPECTED[metric], rel=1e-12)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_without_its_spans(metric, monkeypatch):
    _program(monkeypatch, OUTSIDE)
    assert run.read_layer_metric(metric, _data()) is None


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_without_the_recorder(metric, monkeypatch):
    """A program that lacks ``repro_torch.tracing``: None, no raise."""
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert run.read_layer_metric(metric, _data()) is None


def test_open_spans_are_left_out(monkeypatch):
    _program(monkeypatch, [("scenario.step", 11.0, None, {}),
                           ("scenario.step", 12.0, 12.5, {})])
    assert run.read_layer_metric("sim.scenario_s", _data()) == 0.5


def test_every_reader_has_an_entry():
    spec = run.load_cell("paper_mlp.cefl")[0]
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in EXPECTED:
        m = entries[name]
        assert m["source"] == ("device_trace" if name == "sim.sca_launches"
                               else "program_span")
        assert m["moves"] == ("sim_round_s" if name.startswith("sim.")
                              else "lm_train_tokens_per_s")


@pytest.mark.parametrize("name", ["paper_mlp.cefl", "mamba2_130m.b8"])
def test_traced_run_reports_program_spans(name, card):
    """A short traced run in a process of its own, as the benchmark runs
    it: a second profiler session in one process can lose the device
    records."""
    spec = run.load_cell(name)[0]
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", name,
                        "--seed", str(2 ** 31 + 4051), "--seconds", "6",
                        "--trace", "1"], cwd=run.ROOT, capture_output=True,
                       text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    listed = [m["name"] for m in run.cell_metrics(spec["per_layer"], name)
              if m["name"] in EXPECTED]
    assert listed
    for m in listed:
        assert res["metrics"].get(m, {}).get("value") is not None, m
