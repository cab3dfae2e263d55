"""The PyTorch port's per-round client sampling (``EngineOptions.
cohort_size``) against the JAX package's, on the CPU.

* ``network.topology.subnetwork``, ``engine._gather_plan`` /
  ``_scatter_plan`` and the per-round cohort draws are numpy on the same
  ``RandomState`` streams, so they equal the reference's exactly (the
  plan's delay budgets and rates, which come out of f32 cost math, to
  ``rtol 1e-5``).
* A ``cefl`` cohort run through both packages' front doors, from the
  reference's initial params with its mini-batch draws replayed, at the
  bar of ``tests/test_torch_experiments.py``: identical indicators,
  aggregators and ``dc_points``, continuous decisions, energy, delay and
  loss within 1e-4 relative, accuracy within 2 eval examples.
* With the cohort off, and with K >= N, a run is bit-identical to one
  without cohorts (the cohort draw happens only on the cohort branch);
  the distributed solver is rejected; the spec field round-trips JSON.
* A cohort threat round with more DPUs than the register network takes
  (n > 64): one robust reduce over the whole stack, held against the
  reference's plain version on the same stack.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import experiments as jexp
from repro.core import api as japi
from repro.core import engine as jengine
from repro.core import fedprox as jfp
from repro.core.convergence import MLConstants as JConsts
from repro.kernels import ops as jops
from repro.network import topology as jtopo
from repro.solver.objective import ObjectiveWeights as JOW
from repro_torch import experiments as texp
from repro_torch.core import api as tapi
from repro_torch.core import engine as tengine
from repro_torch.core import fedprox as tfp
from repro_torch.core.convergence import MLConstants as TConsts
from repro_torch.experiments import build as tbuild
from repro_torch.kernels import ops as tops
from repro_torch.models import classifier as tcls
from repro_torch.network import topology as ttopo
from repro_torch.solver.objective import ObjectiveWeights as TOW

torch.set_num_threads(2)

N_UE, N_BS, N_DC = 8, 3, 2
EXACT = ("rho_nb", "rho_bs", "gamma", "m", "I_s", "I_nb", "I_bn")


def _nets():
    cfg = dict(num_ue=N_UE, num_bs=N_BS, num_dc=N_DC, seed=0)
    return (jtopo.make_network(jtopo.NetworkConfig(**cfg)),
            ttopo.make_network(ttopo.NetworkConfig(**cfg)))


def _assert_plan(t_plan, j_plan, where=""):
    for k, v in t_plan.to_w().items():
        want = np.asarray(getattr(j_plan, k))
        if k in EXACT:
            np.testing.assert_array_equal(v.numpy(), want,
                                          err_msg=f"{where} {k}")
        else:
            np.testing.assert_allclose(v.numpy(), want, rtol=1e-5,
                                       err_msg=f"{where} {k}")


def test_subnetwork_equals_the_reference():
    jnet, tnet = _nets()
    cohort = np.array([1, 4, 6])
    jsub, tsub = jtopo.subnetwork(jnet, cohort), ttopo.subnetwork(tnet,
                                                                 cohort)
    assert tsub.dims == jsub.dims == (3, N_BS, N_DC)
    assert dataclasses.asdict(tsub.cfg) == dataclasses.asdict(jsub.cfg)
    for f in ("R_nb", "R_bn", "R_bs_max", "R_s_max", "R_ss", "R_sb",
              "subnet_of_bs", "subnet_of_ue", "adjacency"):
        np.testing.assert_array_equal(np.asarray(getattr(tsub, f)),
                                      np.asarray(getattr(jsub, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(tsub.R_nb, tnet.R_nb[cohort])


def test_gather_and_scatter_equal_the_reference():
    jnet, tnet = _nets()
    consts = dict(L=5.0, theta_i=np.full(N_UE + N_DC, 2.0),
                  sigma_i=np.full(N_UE + N_DC, 3.0), zeta1=2.0, zeta2=1.0)
    jeng = jengine.Engine(jnet, "greedy_data", consts=JConsts(**consts),
                          ow=JOW(T=3), opts=japi.EngineOptions(seed=0))
    teng = tengine.Engine(tnet, "greedy_data", consts=TConsts(**consts),
                          ow=TOW(T=3), opts=tapi.EngineOptions(seed=0),
                          device="cpu")
    D_bar = np.linspace(200.0, 600.0, N_UE)
    jplan = jeng.decide(jnet, D_bar, 0, None)
    tplan = tapi.RoundPlan.from_w({k: np.array(v)
                                   for k, v in jplan.to_w().items()})
    cohort = np.array([0, 2, 5, 7])
    jsub = jengine._gather_plan(jplan, cohort, N_UE)
    tsub = tengine._gather_plan(tplan, cohort, N_UE)
    for k, v in tsub.to_w().items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(getattr(jsub, k)), k)
    assert tsub.rho_nb.shape == (4, N_BS) and tsub.gamma.shape == (6,)
    jfull = jengine._scatter_plan(jsub, cohort, jnet, jeng.opts)
    tfull = tengine._scatter_plan(tsub, cohort, tnet, teng.opts)
    tfull.validate(tnet)
    for k, v in tfull.to_w().items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(getattr(jfull, k)), k)
    rest = np.setdiff1d(np.arange(N_UE), cohort)
    assert np.all(tfull.rho_nb.numpy()[rest] == 0.0)
    assert np.all(tfull.f_n.numpy()[rest] == tnet.cfg.f_min)
    # the cohort constants: per-DPU rows gathered to the K + S rows
    c = teng._cohort_consts(N_UE, cohort)
    jc = jeng._cohort_consts(N_UE, cohort)
    np.testing.assert_array_equal(c.theta_i, jc.theta_i)
    assert c.theta_i.shape == (4 + N_DC,)


def _cohort_spec(pkg, **over):
    base = {"network.num_ue": N_UE, "engine.cohort_size": 4,
            "seeds": (0,)}
    base.update(over)
    return pkg.get_experiment("sweep_smoke").override(**base)


def test_cohort_draws_and_staged_rounds_equal_the_reference():
    """Four rounds of ``begin_round`` (scenario tick, cohort draw,
    greedy plan, offloading) from one seed in both packages."""
    over = {"strategy": "greedy_data", "scenario": "campus_walk",
            "engine.reoptimize_every": 2}
    jctx = jexp.build_context(_cohort_spec(jexp, **over))
    tctx = texp.build_context(_cohort_spec(texp, **over), device="cpu")
    loops = []
    for ctx in (jctx, tctx):
        eng = ctx.make_engine(0)
        ues = ctx.make_ues(0)
        loops.append((eng, ues, eng.init_loop(ues, init_params=ctx.p0)))
    cohorts = []
    for t in range(4):
        (jeng, jues, jst), (teng, tues, tst) = loops
        js, ts = jeng.begin_round(jst, jues), teng.begin_round(tst, tues)
        np.testing.assert_array_equal(ts.cohort, js.cohort)
        cohorts.append(tuple(ts.cohort))
        np.testing.assert_array_equal(ts.D_bar, js.D_bar)
        assert (ts.D_bar > 0).sum() <= 4
        _assert_plan(ts.plan, js.plan, f"round {t} plan")
        _assert_plan(ts.sub_plan, js.sub_plan, f"round {t} sub_plan")
        assert ts.sub_net.dims == js.sub_net.dims == (4, 2, 2)
        for a, b in zip(ts.datasets, js.datasets):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a["y"], np.asarray(b["y"]))
        tst.t += 1
        jst.t += 1
    assert len(set(cohorts)) > 1                 # drawn anew every round


def _record_jax_draws(monkeypatch):
    draws = []
    real = jfp._choice_all_steps

    def recording(num_examples, bsz):
        fn = real(num_examples, bsz)

        def draw(keys):
            idx = fn(keys)
            draws.append(np.array(idx))
            return idx
        return draw

    monkeypatch.setattr(jfp, "_choice_all_steps", recording)
    return draws


def _replay_draws(monkeypatch, draws):
    real = tfp._draw_indices
    queue = list(draws)

    def replaying(generator, Ds, bucket, gamma, m_frac, device):
        idx, wts = real(generator, Ds, bucket, gamma, m_frac, device)
        for j, D in enumerate(Ds):
            want = queue.pop(0)
            assert want.shape == (gamma, tfp.batch_size(D, m_frac))
            idx[:, j, :want.shape[1]] = torch.from_numpy(
                want.astype(np.int64))
        return idx, wts

    monkeypatch.setattr(tfp, "_draw_indices", replaying)
    return queue


def test_cefl_cohort_run_matches_jax(monkeypatch):
    over = {"strategy": "cefl", "scenario": "static",
            "engine.solver_outer": 1, "engine.rounds": 2}
    jspec, tspec = _cohort_spec(jexp, **over), _cohort_spec(texp, **over)
    draws = _record_jax_draws(monkeypatch)
    jr = jexp.run(jspec)
    p0 = {k: np.array(v) for k, v in jexp.build_context(jspec).p0.items()}
    queue = _replay_draws(monkeypatch, draws)
    monkeypatch.setattr(tbuild, "init_classifier_params",
                        lambda gen, cfg, device: tcls.params_from_numpy(
                            p0, device))
    texp.clear_context_cache()
    try:
        tr = texp.run(tspec, device="cpu")
    finally:
        texp.clear_context_cache()
    assert not queue
    for j, t in zip(jr.reports, tr.reports):
        assert t.aggregator == j.aggregator
        assert t.dc_points == j.dc_points
        for k, v in t.plan.to_w().items():
            want = np.asarray(getattr(j.plan, k))
            if k in ("I_s", "I_nb", "I_bn"):
                np.testing.assert_array_equal(v.numpy(), want, err_msg=k)
            else:
                np.testing.assert_allclose(v.numpy(), want, rtol=1e-4,
                                           atol=1e-9, err_msg=k)
        np.testing.assert_allclose(t.energy, j.energy, rtol=1e-4)
        np.testing.assert_allclose(t.delay, j.delay, rtol=1e-4)
        np.testing.assert_allclose(t.loss, j.loss, rtol=1e-4)
        assert abs(t.acc - j.acc) <= 2 / tspec.data.eval_examples + 1e-9
    # costs come from the K-UE subproblem: a half-strength cohort spends
    # less than full participation
    monkeypatch.undo()
    full = texp.run(tspec.override(**{"engine.cohort_size": None}),
                    device="cpu")
    assert tr.final.cum_energy < full.final.cum_energy


def _port_run(**over):
    return texp.run(_cohort_spec(texp, **over), device="cpu")


def test_cohort_off_is_bit_identical_and_k_ge_n_is_noop():
    a = _port_run(**{"engine.cohort_size": None})
    b = _port_run(**{"engine.cohort_size": None})
    big = _port_run(**{"engine.cohort_size": N_UE})
    for x, y in ((a, b), (a, big)):
        assert [(r.acc, r.loss, r.energy, r.dc_points) for r in x.reports] \
            == [(r.acc, r.loss, r.energy, r.dc_points) for r in y.reports]
        for k in x.params:
            assert torch.equal(x.params[k], y.params[k])


def test_cohort_rejects_distributed_solver():
    with pytest.raises(ValueError, match="cohort"):
        _port_run(**{"strategy": "cefl", "engine.distributed_solver": True,
                     "engine.rounds": 1})


def test_cohort_spec_roundtrips_through_json_as_the_reference():
    tspec = texp.ExperimentSpec().override(**{"engine.cohort_size": 4})
    back = texp.from_json(texp.to_json(tspec))
    assert back.engine.cohort_size == 4
    assert back.engine_options(0).cohort_size == 4
    jd = jexp.ExperimentSpec().override(
        **{"engine.cohort_size": 4}).to_dict()["engine"]
    td = back.to_dict()["engine"]
    assert td == {k: v for k, v in jd.items() if k != "kernel_backend"}


def test_cohort_threat_round_reduces_more_than_64_dpus(monkeypatch):
    """100 UEs, a cohort of 72, byzantine sign flips: the round's robust
    reduce sees the 72 + 2 live DPUs at once (above the register
    network's 64, where the card's kernel takes the radix select) and
    agrees with the reference's plain version on the same stack."""
    calls = []
    real = tops.robust_aggregate_plane

    def recording(x, d_stack, theta_eta, **kw):
        out = real(x, d_stack, theta_eta, **kw)
        calls.append((x.clone(), d_stack.clone(), theta_eta, kw, out))
        return out

    monkeypatch.setattr(tops, "robust_aggregate_plane", recording)
    for mode in ("trimmed_mean", "median"):
        res = _port_run(**{"network.num_ue": 100, "engine.cohort_size": 72,
                           "strategy": "greedy_data",
                           "scenario": "byzantine",
                           "engine.robust_agg": mode, "engine.trim_frac":
                           0.2, "engine.rounds": 1})
        assert np.isfinite(res.final.loss)
        x, d, theta_eta, kw, out = calls[-1]
        assert d.shape[0] == 74 > 64 and kw["mode"] == mode
        want = jops.robust_aggregate_plane(
            x.numpy(), d.numpy(), theta_eta, mode=mode,
            trim_frac=kw["trim_frac"], backend="cpu")
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)
    assert len(calls) == 2
