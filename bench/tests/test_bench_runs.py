"""Whole runs of each cell at a CPU test's size: the result's keys, a
sound run judged correct, and runs with the timed path broken underneath
judged not correct."""
from __future__ import annotations

import sys

import pytest
import torch

from bench import run
from bench.trace import Span, Tracer, assemble, breakdown
from conftest import tiny_cell

CELLS = ["paper_mlp.cefl", "paper_mlp.greedy", "mamba2_130m.b8",
         "mamba2_130m.b32"]
SEED = 2 ** 31 + 77


def measure(name, seconds=1.0):
    spec, cell, config, workload = tiny_cell(name)
    return run.measure(name, SEED, seconds, False, spec=spec, cell=cell,
                       config=config, workload=workload,
                       device=torch.device("cpu"))


@pytest.mark.parametrize("name", CELLS)
def test_sound_run(name):
    res = measure(name)
    assert list(res)[:3] == ["correct", "attempted", "failed"]
    assert list(res)[-1] == "checks"
    assert set(res) >= {"metrics", "device"}
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert "setup_s" in res["metrics"]
    assert all(v["value"] > 0 for k, v in res["metrics"].items()
               if k != "lm_peak_mem_gib")


def _state_unchanged(monkeypatch):
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "nova_aggregate_plane",
                        lambda x, d, w, te: x.clone())


def _half_batch(monkeypatch):
    from repro_torch.models import classifier, lm
    cl, lml = classifier.classifier_loss, lm.lm_loss

    def half_cl(params, batch, w=None):
        w = torch.ones(batch["y"].shape) if w is None else w.clone()
        w[..., w.shape[-1] // 2:] = 0       # mean over the first half
        return cl(params, batch, w)

    def half_lm(params, cfg, batch, **kw):
        half = batch["tokens"].shape[0] // 2
        kw["example_mask"] = kw["example_mask"][:half]
        return lml(params, cfg, {k: v[:half] for k, v in batch.items()},
                   **kw)
    monkeypatch.setattr(classifier, "classifier_loss", half_cl)
    monkeypatch.setattr(lm, "lm_loss", half_lm)


def _answer_altered(monkeypatch):
    from repro_torch.kernels import ops
    from repro_torch.network import costs
    agg, energy = ops.nova_aggregate_plane, costs.round_energy

    def altered(*a):
        out = agg(*a)
        out.view(-1)[0] += 1e-2
        return out
    monkeypatch.setattr(ops, "nova_aggregate_plane", altered)
    monkeypatch.setattr(costs, "round_energy",
                        lambda c, xi=(1.0,) * 6: energy(c, xi) * 1.001)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered],
                         ids=["state_unchanged", "half_batch",
                              "answer_altered"])
@pytest.mark.parametrize("name", ["paper_mlp.cefl", "mamba2_130m.b8"])
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    # the engine binds round_energy at import: patch its name too
    from repro_torch.core import engine
    from repro_torch.network import costs
    monkeypatch.setattr(engine, "round_energy", costs.round_energy)
    res = measure(name, seconds=0.2)
    assert res["correct"] is False, res["checks"]


def test_import_guard(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert run.forbidden_modules() == ["repro"]
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax", "repro"]


def test_trace_keeps_rounds_whose_records_match():
    tr = Tracer(True)
    tr.round_launches = {0: {"fedprox_accum": 2, "nova_aggregate": 1},
                         1: {"fedprox_accum": 2, "nova_aggregate": 1}}
    rounds = [Span("round", 0.0, 1.0, 0), Span("round", 1.0, 2.0, 1)]
    recs = [("fedprox_accum_kernel<float>", 0.1, 0.2),
            ("fedprox_accum_kernel<float>", 0.3, 0.4),
            ("nova_aggregate_kernel<float>", 0.5, 0.6),
            ("gemm", 0.55, 0.7),
            ("fedprox_accum_kernel<float>", 1.1, 1.2)]      # round 1 short
    data = assemble(tr, recs, rounds, {}, {})
    assert data.rounds == [0] and data.completeness["rounds_kept"] == 1
    assert abs(data.busy_s() - 0.4) < 1e-12
    tr.spans = [Span("decide", 0.0, 0.5, 0), Span("offload", 0.5, 1.0, 0)]
    data = assemble(tr, recs, rounds, {}, {})
    gaps = dict(breakdown(data, ("decide", "offload"))["idle_gaps"])
    # idle 0-0.1, 0.2-0.3, 0.4-0.5 under decide; 0.7-1.0 under offload
    assert abs(gaps["decide"] - 0.3) < 1e-12
    assert abs(gaps["offload"] - 0.3) < 1e-12


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files
    holds no program: the run exits non-zero and prints no result."""
    import shutil
    import subprocess
    root = run.ROOT
    shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(root / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "paper_mlp.cefl", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""
