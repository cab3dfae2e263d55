"""The port's CE-FL examples ``quickstart`` and ``cefl_vs_baselines`` on
the CPU, through ``main([..., "--device", "cpu"])``, against the
reference examples' output on the same arguments where it does not
depend on ``jax.random`` (the reference's values come from its host
path, ``tests/test_torch_examples.py``; accuracy is only checked
finite):

* ``quickstart`` cut to 2 rounds (a monkeypatched preset): the ``cefl``
  plan's aggregators and ``dc_points`` equal, energy and delay within
  ``tests/test_solver_diff.py``'s 1e-4 relative (each package solves P
  itself).
* ``cefl_vs_baselines --rounds 2``: the ``fednova`` and ``fedavg`` cells'
  aggregators and ``dc_points`` equal, energy and delay within f32
  rounding (1e-6 relative).  Their plans (no offloading, DC 0) read no
  ML constants, so the reference side runs with fixed constants instead
  of its ``jax.random`` estimation; the ``cefl`` cell's plan depends on
  the estimate and is only checked finite.
"""
import math

import numpy as np
import torch

from repro import experiments as jexp
from repro_torch import experiments as texp
from repro_torch.examples import cefl_vs_baselines, quickstart

from test_torch_examples import reference_host_reports

torch.set_num_threads(2)

SOLVER_RTOL = 1e-4


def test_quickstart_matches_the_reference_plan(monkeypatch, capsys):
    real = texp.get_experiment
    monkeypatch.setattr(texp, "get_experiment", lambda name: real(
        name).override(**{"engine.rounds": 2}))
    res = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "spec: quickstart — 6 UEs / 3 BSs / 2 DCs, strategy=cefl, " \
           "2 rounds" in out
    assert "final accuracy" in out and len(res) == 2
    want = reference_host_reports(
        jexp.get_experiment("quickstart").override(**{"engine.rounds": 2}))
    for got, ref in zip(res.reports, want):
        assert (got.aggregator, got.dc_points) == \
            (ref.aggregator, ref.dc_points)
        assert math.isclose(got.energy, ref.energy, rel_tol=SOLVER_RTOL)
        assert math.isclose(got.delay, ref.delay, rel_tol=SOLVER_RTOL)
        assert math.isfinite(got.acc) and math.isfinite(got.loss)
        assert f"DC{got.aggregator:<9d} {got.energy:9.2f}" in out


def test_cefl_vs_baselines_matches_the_reference_baselines(capsys):
    result = cefl_vs_baselines.main(["--rounds", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[1/3]" in out and "energy vs fedavg:" in out
    base = cefl_vs_baselines.base_spec(False, 2)
    for strat in ("fednova", "fedavg"):
        got = result.result(0, strat).reports
        want = reference_host_reports(jexp.ExperimentSpec.from_dict({
            **base.to_dict(), "name": strat, "strategy": strat,
            "consts": {"mode": "fixed"}}))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert (g.aggregator, g.dc_points) == (w.aggregator, w.dc_points)
            assert math.isclose(g.energy, w.energy, rel_tol=1e-6), strat
            assert math.isclose(g.delay, w.delay, rel_tol=1e-6), strat
        assert f"{strat:8s} acc" in out
    for strat in cefl_vs_baselines.STRATEGIES:
        for r in result.result(0, strat).reports:
            assert np.isfinite([r.acc, r.loss, r.energy, r.delay]).all()
