"""The PyTorch port's front door (``repro_torch.experiments``) and the
modules under it against the JAX package's, on the CPU.

* Specs and presets: every CE-FL preset equals the reference's field for
  field (less the engine fields the port has no counterpart for), the JSON
  round trip is exact, the LM presets raise naming their ROADMAP item.
* The CLI: ``list``, ``show``, ``validate`` in-process; ``run`` without
  ``--device`` asks for the card and raises here.
* A reduced ``quickstart`` (2 rounds, ``solver_outer=1``) through
  ``experiments.run`` in both packages, from the reference's initial
  params, with the reference's mini-batch draws replayed in the port
  (torch cannot reproduce ``jax.random``; the draws are recorded from the
  reference's ``_choice_all_steps`` and written into the port's staged
  index arrays).  The plans come from each package's own SCA solve, so
  they are held to ``tests/test_solver_diff.py``'s bar: identical
  indicators and aggregator, continuous decisions within 1e-4 relative,
  hence the same offloading split (identical ``dc_points``) and energy
  and delay within 1e-4 relative.  Training then sees the same data in
  the same order and differs only by f32 rounding: losses within 1e-4
  relative, accuracy on the 500 eval examples within 2 examples.
* The constants estimation (paper Algs. 4-6) with the reference's probes
  replayed, ``estimate_drift``, and the numpy convergence helpers.
"""
import dataclasses
import io
import json
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from repro import experiments as jexp
from repro.configs.cefl_paper import ClassifierConfig as JConfig
from repro.core import convergence as jconv
from repro.core import drift as jdrift
from repro.core import estimation as jest
from repro.core import fedprox as jfp
from repro.data import synthetic as jsyn
from repro.models import classifier as jcls
from repro_torch import experiments as texp
from repro_torch.core import convergence as tconv
from repro_torch.core import drift as tdrift
from repro_torch.core import estimation as test_
from repro_torch.core import fedprox as tfp
from repro_torch.experiments import __main__ as tcli
from repro_torch.experiments import build as tbuild
from repro_torch.experiments import trace as ttrace
from repro_torch.models import classifier as tcls

torch.set_num_threads(2)

# the reference's engine fields the port has no counterpart for (cohorts:
# ROADMAP queue 1 item 3; the sharded plane: item 5; kernel dispatch and
# the sanitizer: by device, no knob)
JAX_ONLY_ENGINE = ("kernel_backend", "sanitize", "mesh_shape", "cohort_size")
JAX_ONLY_MODEL = ("arch", "reduced", "batch", "seq", "n_dpu", "n_micro",
                  "gamma")
LM_PRESETS = ("lm_smoke", "lm_mamba2_130m")


def _jax_dict(spec):
    d = spec.to_dict()
    for k in JAX_ONLY_ENGINE:
        d["engine"].pop(k)
    for k in JAX_ONLY_MODEL:
        d["model"].pop(k)
    return d


def test_presets_equal_the_reference_and_round_trip_json():
    assert texp.available_experiments() == jexp.available_experiments()
    for name in texp.available_experiments():
        if name in LM_PRESETS:
            with pytest.raises(NotImplementedError, match="queue 1 item 6"):
                texp.get_experiment(name)
            continue
        spec = texp.get_experiment(name)
        assert spec.to_dict() == _jax_dict(jexp.get_experiment(name)), name
        assert texp.from_json(texp.to_json(spec)) == spec
        # the engine options: the reference's, field for field
        for seed in spec.run_seeds:
            t = dataclasses.asdict(spec.engine_options(seed))
            j = dataclasses.asdict(
                jexp.get_experiment(name).engine_options(seed))
            assert t == {k: v for k, v in j.items()
                         if k not in JAX_ONLY_ENGINE}, name
    over = texp.get_experiment("quickstart").override(
        **{"engine.rounds": "3", "seeds": "4,5", "strategy": "fixed:1"})
    assert (over.engine.rounds, over.seeds, over.strategy) == \
        (3, (4, 5), "fixed:1")
    assert texp.from_json(texp.to_json(over)) == over
    with pytest.raises(KeyError, match="no field"):
        over.override(**{"engine.kernel_backend": "cpu"})
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        texp.sweep("quickstart")


def _cli(*argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = tcli.main(list(argv))
    return rc, out.getvalue()


def test_cli_list_show_validate_and_the_device_rule():
    rc, out = _cli("list")
    assert rc == 0
    lines = {ln.split()[0]: ln for ln in out.splitlines()}
    assert sorted(lines) == jexp.available_experiments()
    assert "strategy=cefl" in lines["quickstart"]
    assert "not ported" in lines["lm_smoke"]
    rc, out = _cli("show", "quickstart", "--rounds", "3")
    assert rc == 0
    spec = texp.from_json(out)
    assert spec == texp.get_experiment("quickstart").override(
        **{"engine.rounds": 3})
    rc, out = _cli("validate", "quickstart", "--device", "cpu")
    assert rc == 0 and "OK" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            _cli("run", "quickstart", "--rounds", "1")


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
    real = tfp._stage_group_batches
    queue = list(draws)

    def replaying(datasets, generator, Ds, bucket, gamma, m_frac, device):
        data, idx, wts = real(datasets, generator, Ds, bucket, gamma,
                              m_frac, device)
        for j in range(len(datasets)):
            want = queue.pop(0)
            bsz = tfp.batch_size(Ds[j], m_frac)
            assert want.shape == (gamma, bsz)
            idx[:, j, :bsz] = torch.from_numpy(want.astype(np.int64))
        return data, idx, wts

    monkeypatch.setattr(tfp, "_stage_group_batches", replaying)
    return queue


def test_reduced_quickstart_run_matches_jax(monkeypatch, tmp_path):
    spec_over = {"engine.rounds": 2, "engine.solver_outer": 1}
    jspec = jexp.get_experiment("quickstart").override(**spec_over)
    tspec = texp.get_experiment("quickstart").override(**spec_over)
    draws = _record_jax_draws(monkeypatch)
    jr = jexp.run(jspec)
    p0 = {k: np.array(v) for k, v in
          jexp.build_context(jspec).p0.items()}
    queue = _replay_draws(monkeypatch, draws)
    monkeypatch.setattr(tbuild, "init_classifier_params",
                        lambda gen, cfg, device: tcls.params_from_numpy(
                            p0, device))
    texp.clear_context_cache()
    path = tmp_path / "trace.jsonl"
    with texp.TraceSink(path) as sink:
        tr = texp.run(tspec, device="cpu", trace=sink)
    texp.clear_context_cache()
    assert not queue                          # every draw replayed
    assert len(tr) == len(jr) == 2
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
        assert abs(t.acc - j.acc) <= 2 / 500
        assert (t.gamma_mean, t.m_mean) == pytest.approx(
            (j.gamma_mean, j.m_mean))
    # the trace: one record per round, an exact round trip of the report
    recs = texp.read_trace(path)
    assert [r["round"] for r in recs] == [0, 1]
    for rec, rep in zip(recs, tr.reports):
        back = ttrace.report_from_record(
            {**rec, "plan": ttrace.plan_to_lists(rep.plan)})
        assert ttrace.report_to_record(back) == ttrace.report_to_record(rep)


class _Replay(test_.Draws):
    """The reference's probes, in the order both packages draw them."""

    def __init__(self, params, choices):
        super().__init__(None)
        self.params, self.choices = list(params), list(choices)

    def params_like(self, template, scale):
        p = self.params.pop(0)
        assert sorted(p) == sorted(template)
        return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}

    def choice(self, D, n, device):
        idx = self.choices.pop(0)
        assert idx.shape == (n,) and idx.max() < D
        return torch.from_numpy(idx.astype(np.int64))


def test_estimate_constants_with_the_references_probes(monkeypatch):
    """Algs. 4-6 at a small size: the reference's ``jax.random`` probes
    (models and example subsets, recorded as drawn) replayed in the port.
    Theta, L and sigma within 1e-4 relative (the same f32 gradients,
    summed in other orders); zeta from a least-squares fit through those
    sums, within 1e-3."""
    params, choices = [], []
    real_like, real_choice = jest._rand_params_like, jax.random.choice

    def rec_like(key, tmpl, scale=1.0):
        out = real_like(key, tmpl, scale)
        params.append({k: np.array(v) for k, v in out.items()})
        return out

    def rec_choice(*a, **kw):
        out = real_choice(*a, **kw)
        choices.append(np.array(out))
        return out

    monkeypatch.setattr(jest, "_rand_params_like", rec_like)
    monkeypatch.setattr(jax.random, "choice", rec_choice)
    (x, y), _ = jsyn.make_image_dataset(1200, (8, 8, 1), seed=2)
    ues = jsyn.make_online_ues(x, y, num_ue=3, mean_arrivals=80.0,
                               std_arrivals=8.0, seed=5)
    data = [u.step() for u in ues]
    cfg = JConfig(input_shape=(8, 8, 1), hidden=(16,))
    p0 = jcls.init_classifier_params(jax.random.PRNGKey(0), cfg)
    want = jest.estimate_constants(jcls.classifier_loss, p0, data,
                                   key=jax.random.PRNGKey(7), iters=3)
    tdata = [{k: np.array(v) for k, v in d.items()} for d in data]
    got = test_.estimate_constants(
        tcls.classifier_loss, tcls.params_from_numpy(
            {k: np.array(v) for k, v in p0.items()}, "cpu"), tdata,
        draws=_Replay(params, choices), iters=3)
    np.testing.assert_allclose(got.theta_i, want.theta_i, rtol=1e-4)
    np.testing.assert_allclose(got.sigma_i, want.sigma_i, rtol=1e-6)
    np.testing.assert_allclose(got.L, want.L, rtol=1e-4)
    np.testing.assert_allclose([got.zeta1, got.zeta2],
                               [want.zeta1, want.zeta2], rtol=1e-3,
                               atol=1e-6)
    assert got.F0_gap == want.F0_gap


def test_estimate_drift_and_convergence_helpers_equal_jax():
    (x, y), _ = jsyn.make_image_dataset(1500, (8, 8, 1))
    ds = jdrift.OnlineDataset(features=x, labels=y,
                              label_support=np.arange(4), mean_arrivals=150,
                              std_arrivals=10, seed=3, drift_labels=True)
    d_t, d_tp1 = ds.step(), ds.step()
    cfg = JConfig(input_shape=(8, 8, 1), hidden=(16,))
    jprobes = [jcls.init_classifier_params(jax.random.PRNGKey(i), cfg)
               for i in range(4)]
    args = (len(d_t["y"]) * 2, len(d_tp1["y"]) * 2)
    want = jdrift.estimate_drift(jcls.classifier_loss, jprobes, d_t, d_tp1,
                                 *args, tau=0.5)
    tprobes = [tcls.params_from_numpy({k: np.array(v) for k, v in
                                       p.items()}, "cpu") for p in jprobes]
    td = [{k: np.array(v) for k, v in d.items()} for d in (d_t, d_tp1)]
    got = tdrift.estimate_drift(tcls.classifier_loss, tprobes, *td, *args,
                                tau=0.5)
    loop = tdrift._estimate_drift_loop(tcls.classifier_loss, tprobes, *td,
                                       *args, tau=0.5)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(got, loop, rtol=1e-5)
    with pytest.raises(ValueError, match="probe"):
        tdrift.estimate_drift(tcls.classifier_loss, [], *td, *args, tau=1.0)
    # the numpy helpers of the bound: the reference's numbers exactly
    consts = dict(L=4.0, theta_i=np.array([1.5, 2.0, 2.5]),
                  sigma_i=np.array([0.5, 1.0, 1.5]), zeta1=2.0, zeta2=1.0)
    tc, jc = tconv.MLConstants(**consts), jconv.MLConstants(**consts)
    g = np.array([1.0, 2.5, 4.0])
    for a, b in zip(tconv.a_norm_stats(g, 0.1, 0.01),
                    jconv.a_norm_stats(g, 0.1, 0.01)):
        np.testing.assert_array_equal(a, b)
    kw = dict(p_i=[0.2, 0.3, 0.5], D_i=[100, 300, 500], m_i=[0.5, 0.4, 1.0],
              gamma_i=g, tau_sum_drift=3.0, eta=0.1, theta=1.0, T=20)
    assert tconv.theorem1_bound(consts=tc, **kw) == \
        jconv.theorem1_bound(consts=jc, **kw)
    kw = dict(d=3, gamma_bar=2.0, T=50, theta=1.0, tau_tilde=4.0,
              m_min=0.4, gamma_max=4.0)
    assert tconv.corollary_bound(consts=tc, **kw) == \
        jconv.corollary_bound(consts=jc, **kw)
    for eta in (1e-3, 0.5):
        assert tconv.step_size_condition(g, eta, 0.01, 4.0, 2.0) == \
            jconv.step_size_condition(g, eta, 0.01, 4.0, 2.0)
    assert json.loads(json.dumps(tconv.a_norm_stats(2.0, 0.1, 0.0)[0]
                                 .tolist())) == 2.0
