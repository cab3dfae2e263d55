"""The PyTorch port's multi-seed sweeps and kill-safe resume, on the CPU.

The parity contract:

* Bit for bit between each seed of a sweep and ``experiments.run`` of
  that seed, and between a killed and resumed sweep and an uninterrupted
  one: the run's structure (plans, aggregators, ``dc_points``, handovers,
  active UEs, energy, delay), the losses, the accuracy and the final
  params.
* Against the JAX package: one ``sweep_smoke`` seed through both
  packages' sequential sweeps, from the reference's initial params with
  its mini-batch draws replayed, at ``tests/test_torch_experiments.py``'s
  bar: identical plans' indicators and ``dc_points``, energy, delay and
  loss within 1e-4 relative, accuracy within 2 eval examples.
"""
import dataclasses
import importlib
import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import experiments as jexp
from repro.core import fedprox as jfp
from repro_torch import experiments as texp
from repro_torch.core import fedprox as tfp
from repro_torch.experiments import __main__ as tcli
from repro_torch.experiments import build as tbuild
from repro_torch.models import classifier as tcls

torch.set_num_threads(2)

# the module (the package exports the function ``sweep`` under its name)
jsweep = importlib.import_module("repro.experiments.sweep")


def _smoke(**over):
    return texp.get_experiment("sweep_smoke").override(**over)


STRUCTURE = ("round", "aggregator", "dc_points", "handovers", "active_ues",
             "energy", "delay", "cum_energy", "cum_delay", "gamma_mean",
             "m_mean", "aggregator_moved")


def _assert_same_structure(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a.reports, b.reports):
        for f in STRUCTURE:
            assert getattr(ra, f) == getattr(rb, f), f
        for k, v in ra.plan.to_w().items():
            assert torch.equal(v, rb.plan.to_w()[k]), k


def _assert_identical(a, b):
    _assert_same_structure(a, b)
    assert [r.loss for r in a.reports] == [r.loss for r in b.reports]
    assert [r.acc for r in a.reports] == [r.acc for r in b.reports]
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


@pytest.mark.parametrize("over", [
    {},
    {"strategy": "cefl", "scenario": "static", "seeds": (0, 1, 2),
     "network.num_ue": 6},
    {"scenario": "byzantine:0.34", "engine.robust_agg": "trimmed_mean"},
    {"strategy": "fedavg", "scenario": "churn"},
    {"network.num_ue": 6, "engine.cohort_size": 4},
], ids=["greedy_campus_walk", "cefl_many_groups", "byzantine_trimmed",
        "fedavg_churn", "cohort"])
def test_sweep_against_run(over):
    spec = _smoke(**over)
    res = texp.sweep(spec, device="cpu")
    assert res.seeds == list(spec.run_seeds)
    for seed in spec.run_seeds:
        _assert_identical(res.result(seed),
                          texp.run(spec, seed=seed, device="cpu"))
    st = res.stats()["sweep_smoke"]
    assert st["runs"] == len(spec.run_seeds)
    assert 0.0 <= st["final_acc_mean"] <= 1.0


def test_stats_equal_the_reference_and_grid_names_merge():
    base = _smoke(**{"engine.rounds": 2, "scenario": "static",
                     "seeds": (0,)})
    grid = [base.override(**{"name": "a"}),
            base.override(**{"name": "b", "strategy": "fixed:0"})]
    res = texp.sweep(grid, device="cpu")
    assert len(res) == 2 and [k.experiment for k, _ in res.runs] == \
        ["a", "b"]
    assert set(res.stats()) == {"a", "b"}
    ref = jsweep.SweepResult(runs=[
        (jsweep.RunKey(k.experiment, k.seed), r) for k, r in res.runs])
    assert res.stats() == ref.stats()
    merged = res.merged(res)
    assert len(merged) == 4 and merged.stats()["a"]["runs"] == 2
    with pytest.raises(ValueError, match="unique names"):
        texp.sweep([base, base], device="cpu")


@pytest.mark.parametrize("reoptimize_every,stop_after", [
    (1, 2), (3, 2), (3, 1)])
def test_kill_and_resume_matches_uninterrupted(reoptimize_every, stop_after,
                                               tmp_path):
    """A sweep killed after round ``stop_after`` (full-state snapshot) and
    resumed reproduces the uninterrupted run's traces and final params bit
    for bit, under the dynamic campus_walk scenario (mobility state,
    stream PRNGs, the torch generators, warm starts all round-trip).  With
    ``reoptimize_every=3`` the resumed rounds run on the restored plan
    itself."""
    spec = _smoke(**{"engine.rounds": 4,
                     "engine.reoptimize_every": reoptimize_every})
    assert spec.scenario == "campus_walk"
    full = texp.sweep(spec, device="cpu")
    ck = tmp_path / "ck"
    part = texp.sweep(spec, device="cpu", checkpoint_dir=ck,
                      stop_after=stop_after)
    for seed in spec.run_seeds:
        assert len(part.result(seed)) == stop_after
    res = texp.sweep(spec, device="cpu", checkpoint_dir=ck, resume=True)
    for seed in spec.run_seeds:
        _assert_identical(full.result(seed), res.result(seed))


def test_resume_refuses_spec_mismatch(tmp_path):
    spec = _smoke(**{"engine.rounds": 3})
    ck = tmp_path / "ck"
    texp.sweep(spec, device="cpu", checkpoint_dir=ck, stop_after=1)
    other = spec.override(**{"engine.eta": 0.2})
    with pytest.raises(ValueError, match="different spec"):
        texp.sweep(other, device="cpu", checkpoint_dir=ck, resume=True)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        texp.sweep(spec, device="cpu", stop_after=1)


def _cli(*argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = tcli.main(list(argv))
    return rc, out.getvalue()


def test_cli_checkpoint_stop_resume_and_trace_append(tmp_path):
    ck, trace = tmp_path / "ck", tmp_path / "trace.jsonl"
    args = ("run", "sweep_smoke", "--device", "cpu", "--rounds", "4",
            "--checkpoint", str(ck), "--trace", str(trace))
    rc, out = _cli(*args, "--stop-after", "2")
    assert rc == 0 and "rounds=2" in out
    assert [(r["seed"], r["round"]) for r in texp.read_trace(trace)] == \
        [(0, 0), (1, 0), (0, 1), (1, 1)]
    rc, out = _cli(*args, "--resume")
    assert rc == 0 and "rounds=4" in out and "aggregate stats" in out
    recs = texp.read_trace(trace)
    assert [(r["seed"], r["round"]) for r in recs] == \
        [(s, t) for t in range(4) for s in (0, 1)]
    assert all(r["executor"] == "sequential" and r["kind"] == "round"
               for r in recs)
    full = texp.sweep(_smoke(**{"engine.rounds": 4}), device="cpu")
    for r in recs:
        rep = full.result(r["seed"]).reports[r["round"]]
        assert (r["loss"], r["acc"], r["energy"]) == \
            (rep.loss, rep.acc, rep.energy)
    with pytest.raises(SystemExit, match="need --checkpoint"):
        _cli("run", "sweep_smoke", "--device", "cpu", "--resume")


def test_sweep_killed_inside_a_snapshot_resumes_from_the_last_one(
        tmp_path, monkeypatch):
    """A sweep snapshotting every round is killed while it writes round
    3's snapshot, before the manifest lands; the resume starts from round
    2's snapshot and ends where the uninterrupted sweep ends, bit for
    bit."""
    from repro_torch.training import checkpoint as tck
    spec = _smoke(**{"engine.rounds": 4})
    full = texp.sweep(spec, device="cpu")
    real, saves = tck.os.replace, []

    def killed(src, dst):
        if Path(dst).name == tck.MANIFEST:
            saves.append(dst)
            if len(saves) == 3:
                raise KeyboardInterrupt("killed")
        return real(src, dst)

    ck = tmp_path / "ck"
    monkeypatch.setattr(tck.os, "replace", killed)
    with pytest.raises(KeyboardInterrupt):
        texp.sweep(spec, device="cpu", checkpoint_dir=ck,
                   checkpoint_every=1)
    monkeypatch.setattr(tck.os, "replace", real)
    assert tck.read_manifest(ck)["step"] == 2
    res = texp.sweep(spec, device="cpu", checkpoint_dir=ck, resume=True)
    for seed in spec.run_seeds:
        _assert_identical(full.result(seed), res.result(seed))


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


_REAL_DRAW_INDICES = tfp._draw_indices


def _replay_draws(monkeypatch, draws):
    real = _REAL_DRAW_INDICES
    queue = list(draws)

    def replaying(generator, Ds, bucket, gamma, m_frac, device):
        idx, wts = real(generator, Ds, bucket, gamma, m_frac, device)
        for j, D in enumerate(Ds):
            want = queue.pop(0)
            bsz = tfp.batch_size(D, m_frac)
            assert want.shape == (gamma, bsz)
            idx[:, j, :bsz] = torch.from_numpy(want.astype(np.int64))
        return idx, wts

    monkeypatch.setattr(tfp, "_draw_indices", replaying)
    return queue


def test_one_sweep_smoke_seed_matches_the_jax_sequential_sweep(monkeypatch):
    over = {"seeds": (1,), "engine.rounds": 3}
    jspec = jexp.get_experiment("sweep_smoke").override(**over)
    tspec = texp.get_experiment("sweep_smoke").override(**over)
    draws = _record_jax_draws(monkeypatch)
    jr = jexp.sweep(jspec, executor="sequential").result(1)
    p0 = {k: np.array(v) for k, v in jexp.build_context(jspec).p0.items()}
    monkeypatch.setattr(tbuild, "init_classifier_params",
                        lambda gen, cfg, device: tcls.params_from_numpy(
                            p0, device))
    texp.clear_context_cache()
    try:
        queue = _replay_draws(monkeypatch, draws)
        tr = texp.sweep(tspec, device="cpu").result(1)
        assert not queue                      # every draw replayed
    finally:
        texp.clear_context_cache()
    assert len(tr) == len(jr) == 3
    for j, t in zip(jr.reports, tr.reports):
        assert t.aggregator == j.aggregator
        assert t.dc_points == j.dc_points
        assert t.handovers == j.handovers
        assert t.active_ues == j.active_ues
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


def test_sweep_and_cli_ask_for_the_card_by_default():
    assert json.loads(texp.to_json(_smoke()))["engine"]["rounds"] == 3
    assert dataclasses.is_dataclass(texp.SweepResult)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            texp.sweep("sweep_smoke")
        with pytest.raises(RuntimeError, match="cuda"):
            _cli("run", "sweep_smoke", "--rounds", "1")
