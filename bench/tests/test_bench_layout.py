"""BENCHMARK.json and the files the harness finds by name."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_cell_resolves(cell):
    wl = json.loads((ROOT / "bench" / "workloads" /
                     f"{cell['name']}.json").read_text())
    assert wl["config"] == cell["config"]
    assert (ROOT / "bench" / "drivers" / f"{wl['driver']}.py").is_file()
    cfg = next(c for c in SPEC["configs"] if c["name"] == cell["config"])
    assert (ROOT / cfg["file"]).is_file()
    assert cell["why"] == wl["why"] and len(cell["why"]) <= 200
    assert cell["chips"] == 1
    e2e = [m for m in SPEC["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layer = [m for m in SPEC["per_layer"]
             if cell["name"] in m.get("workloads", [])]
    assert layer
    assert set(wl["limits"]) and all(v >= 0 for v in wl["limits"].values())


@pytest.mark.parametrize("metric", SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_layer_metric_resolves(metric):
    assert (ROOT / "bench" / "layer_metrics" /
            f"{metric['name']}.py").is_file()
    moves = {m["name"]: m for m in SPEC["end_to_end"]}[metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in moves.get("workloads", [cell])


def test_names_units_and_bounds():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {c["config"] for c in SPEC["workloads"]} == \
        {c["name"] for c in SPEC["configs"]}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
