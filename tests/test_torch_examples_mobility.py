"""The port's ``mobility_demo`` example on the CPU, whole (20 rounds of
``campus_walk``), through ``main(["--rounds", "20", "--device",
"cpu"])``: its own asserts hold (at least one aggregator migration and
one handover under ``cefl``, none under ``fixed:0``), and the
``fixed:0`` cell's aggregators, handovers, active UEs, ``dc_points``,
energy and delay equal the reference example's (its host path,
``tests/test_torch_examples.py``: none of these depends on
``jax.random``); accuracy only finite.
"""
import math

import numpy as np
import torch

from repro import experiments as jexp
from repro_torch.examples import mobility_demo

from test_torch_examples import host_fields, reference_host_reports

torch.set_num_threads(2)


def test_mobility_demo_floats_and_matches_the_reference_baseline(capsys):
    results = mobility_demo.main(["--rounds", "20", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "OK: the aggregation point floats under cefl" in out
    cefl, fixed = results["cefl"], results["fixed"]
    assert len(cefl) == len(fixed) == 20
    assert sum(r.aggregator_moved for r in cefl.reports) >= 1
    assert sum(len(r.handovers) for r in cefl.reports) >= 1
    assert not any(r.aggregator_moved for r in fixed.reports)
    want = reference_host_reports(
        jexp.get_experiment("campus_walk_vs_fixed").override(**{
            "scenario": "campus_walk", "engine.rounds": 20, "seeds": (0,),
            "name": "fixed", "strategy": "fixed:0"}))
    assert [host_fields(r) for r in fixed.reports] == \
        [host_fields(r) for r in want]
    for g, w in zip(fixed.reports, want):
        assert math.isclose(g.energy, w.energy, rel_tol=1e-6)
        assert math.isclose(g.delay, w.delay, rel_tol=1e-6)
    for r in cefl.reports + fixed.reports:
        assert np.isfinite([r.acc, r.loss]).all()
