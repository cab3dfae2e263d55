"""The PyTorch port's scenario subsystem against the JAX package's.

Every preset a user selects by name is stepped for six rounds in both
packages from the same seed, at the quickstart size (6 UEs / 3 BSs /
2 DCs): the evolved network (``R_nb``, ``R_bn``, ``R_ss``, ``R_sb``,
``subnet_of_ue``, ``adjacency``), each UE's round data and every
``ScenarioEvents`` field must be EXACTLY equal, because both packages run
the same numpy code on the same ``RandomState`` stream.  The same holds
for the deterministic compromised-UE sets (``resolve_ues``).
"""
import dataclasses

import numpy as np
import pytest

from repro.core import api as japi
from repro.data import synthetic as jsyn
from repro.network import topology as jtopo
from repro.scenario import base as jbase
from repro.scenario.adversary import resolve_ues as j_resolve_ues
from repro_torch.core import api as tapi
from repro_torch.data import synthetic as tsyn
from repro_torch.network import topology as ttopo
from repro_torch.scenario import base as tbase
from repro_torch.scenario.adversary import resolve_ues as t_resolve_ues

N, B, S = 6, 3, 2
ROUNDS = 6
PRESETS = ["byzantine", "byzantine:0.0", "poisoned", "stragglers",
           "campus_walk", "campus_walk:fast", "vehicular", "flash_crowd",
           "label_shift", "churn", "static"] + \
    [f"fuzzmix:{seed}" for seed in range(8)]

_POOL = jsyn.make_image_dataset(1500, (8, 8, 1), seed=0)


def _world(pkg_topo, pkg_syn, opts):
    (x, y), _ = _POOL
    net = pkg_topo.make_network(pkg_topo.NetworkConfig(num_ue=N, num_bs=B,
                                                       num_dc=S, seed=0))
    ues = pkg_syn.make_online_ues(x, y, num_ue=N, mean_arrivals=80.0,
                                  std_arrivals=8.0, seed=0)
    return net, ues, opts


def _trace(scenario, net, ues, opts, seed):
    rng = np.random.RandomState(seed)
    scenario.bind(net, opts)
    out = []
    for t in range(ROUNDS):
        net_t, data, events = scenario.step(t, ues, rng)
        serving = getattr(scenario, "serving_bs", None)
        out.append((net_t, data, events,
                    None if serving is None else np.array(serving)))
    return out, rng.randint(2**31 - 1)


def test_registries_name_the_same_presets():
    assert tbase.available_scenarios() == jbase.available_scenarios()


@pytest.mark.parametrize("name", PRESETS)
def test_preset_trace_equals_jax(name):
    jnet, jues, jopts = _world(jtopo, jsyn, japi.EngineOptions())
    tnet, tues, topts = _world(ttopo, tsyn, tapi.EngineOptions())
    jtrace, jnext = _trace(jbase.get_scenario(name), jnet, jues, jopts, 3)
    ttrace, tnext = _trace(tbase.get_scenario(name), tnet, tues, topts, 3)
    assert tnext == jnext          # both consumed the same rng draws
    for t, ((jn, jd, je, js), (tn, td, te, ts)) in enumerate(
            zip(jtrace, ttrace)):
        for field in ("R_nb", "R_bn", "R_ss", "R_sb", "subnet_of_ue",
                      "adjacency"):
            np.testing.assert_array_equal(
                np.asarray(getattr(tn, field)),
                np.asarray(getattr(jn, field)),
                err_msg=f"{name} round {t}: {field}")
        assert len(td) == len(jd) == N
        for ue, (a, b) in enumerate(zip(td, jd)):
            np.testing.assert_array_equal(a["x"], np.asarray(b["x"]))
            np.testing.assert_array_equal(a["y"], np.asarray(b["y"]),
                                          err_msg=f"{name} t={t} ue={ue}")
        assert dataclasses.asdict(te) == dataclasses.asdict(je), \
            f"{name} round {t}"
        if js is None:
            assert ts is None
        else:
            np.testing.assert_array_equal(ts, js)


def test_threat_presets_fire_their_channels():
    """The traces above are only as strong as what the presets do in six
    rounds: the byzantine preset must corrupt, stragglers must scale
    compute and drop UEs, and the mobility presets must hand over."""
    _, tues, topts = _world(ttopo, tsyn, tapi.EngineOptions())
    tnet = _world(ttopo, tsyn, topts)[0]

    def events(name):
        trace, _ = _trace(tbase.get_scenario(name), tnet, tues, topts, 3)
        return [e for _, _, e, _ in trace]

    assert all(e.corrupted == ((0, "sign_flip", 4.0),)
               for e in events("byzantine"))
    assert all(e.corrupted == () for e in events("byzantine:0.0"))
    strag = events("stragglers")
    assert all(len(e.compute_scale) == N for e in strag)
    assert any(e.left for e in strag)
    assert sum(len(e.handovers) for e in events("vehicular")) > 0


@pytest.mark.parametrize("n_ue,frac,ues", [
    (10, 0.2, None), (10, 0.0, None), (6, 0.2, None), (10, 1.0, None),
    (20, 0.2, None), (20, 0.35, None), (7, 0.5, None),
    (5, 0.9, (4, 1, 1, 7, -2)), (3, 0.1, ())])
def test_resolve_ues_equals_jax(n_ue, frac, ues):
    assert t_resolve_ues(n_ue, frac, ues) == j_resolve_ues(n_ue, frac, ues)


def test_stragglers_fednova_median_run_matches_jax():
    """Mobility, handover, i.i.d. dropout (the live DPU count varies, odd
    and even) and the straggler slowdown charged through the delay, with
    the median under FedNova's unweighted-gamma theta; tolerances as in
    ``test_torch_robust_engine.py``."""
    from test_torch_robust_engine import (assert_reports_match, jax_run,
                                          torch_run)
    jr = jax_run("fednova", "stragglers", robust="median", rounds=5)
    tr = torch_run("fednova", "stragglers", robust="median", rounds=5)
    assert_reports_match(jr, tr)
    assert len({r.active_ues for r in tr.reports}) > 1
    assert tr.final.acc > 0.1
