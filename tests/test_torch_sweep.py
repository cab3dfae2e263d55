"""The PyTorch port's multi-seed sweeps, kill-safe resume and the local
training entry points they use, on the CPU.

The parity contract:

* Exact between the vmap and the sequential executors, between the
  sequential executor and ``experiments.run``, and between a killed and
  resumed sweep and an uninterrupted one: the run's structure (plans,
  aggregators, ``dc_points``, handovers, active UEs, energy, delay).
* Parameters, losses and accuracy: every element's math is the same in
  both executors, but the classifier's ``torch.bmm``
  (``models/classifier.classifier_logits``, and its backward) and the
  batched eval run over a group whose batch count differs between them
  (a run's own group against the cross-run group), and a BLAS may choose
  its algorithm by batch count: the CPU torch build does at some shapes (a
  ``(64, 784) @ (784, 200)`` product differs between a batch of 1 and of
  7).  At the shapes here the two agree bit for bit, and the tests hold
  them so; ``chip_smoke.py`` holds the card's cuBLAS at ``rtol 1e-6``.
* Against the JAX package: one ``sweep_smoke`` seed through both
  packages' sequential (and the port's vmap) sweeps, from the reference's
  initial params with its mini-batch draws replayed, at
  ``tests/test_torch_experiments.py``'s bar: identical plans' indicators
  and ``dc_points``, energy, delay and loss within 1e-4 relative,
  accuracy within 2 eval examples.
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
from repro_torch.kernels.plane import ParamPlane
from repro_torch.models import classifier as tcls
from repro_torch.models.classifier import classifier_loss

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
], ids=["greedy_campus_walk", "cefl_many_groups", "byzantine_trimmed",
        "fedavg_churn"])
def test_vmap_against_sequential_and_sequential_against_run(over):
    spec = _smoke(**over)
    seq = texp.sweep(spec, executor="sequential", device="cpu")
    vm = texp.sweep(spec, executor="vmap", device="cpu")
    assert seq.seeds == vm.seeds == list(spec.run_seeds)
    for seed in spec.run_seeds:
        _assert_identical(vm.result(seed), seq.result(seed))
        _assert_identical(seq.result(seed),
                          texp.run(spec, seed=seed, device="cpu"))
    st = vm.stats()["sweep_smoke"]
    assert st["runs"] == len(spec.run_seeds)
    assert 0.0 <= st["final_acc_mean"] <= 1.0


def test_stats_equal_the_reference_and_grid_names_merge():
    base = _smoke(**{"engine.rounds": 2, "scenario": "static",
                     "seeds": (0,)})
    grid = [base.override(**{"name": "a"}),
            base.override(**{"name": "b", "strategy": "fixed:0"})]
    res = texp.sweep(grid, executor="sequential", device="cpu")
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
    with pytest.raises(KeyError, match="unknown sweep executor"):
        texp.sweep(base, executor="nope", device="cpu")


@pytest.mark.parametrize("executor,reoptimize_every", [
    ("vmap", 1), ("sequential", 1), ("vmap", 3)])
def test_kill_and_resume_matches_uninterrupted(executor, reoptimize_every,
                                               tmp_path):
    """A sweep killed after round 2 (full-state snapshot) and resumed
    reproduces the uninterrupted run's traces and final params bit for
    bit, under the dynamic campus_walk scenario (mobility state, stream
    PRNGs, the torch generators, warm starts all round-trip).  With
    ``reoptimize_every=3`` round 2 runs on the restored plan itself."""
    spec = _smoke(**{"engine.rounds": 4,
                     "engine.reoptimize_every": reoptimize_every})
    assert spec.scenario == "campus_walk"
    full = texp.sweep(spec, executor=executor, device="cpu")
    ck = tmp_path / "ck"
    part = texp.sweep(spec, executor=executor, device="cpu",
                      checkpoint_dir=ck, stop_after=2)
    for seed in spec.run_seeds:
        assert len(part.result(seed)) == 2
    res = texp.sweep(spec, executor=executor, device="cpu",
                     checkpoint_dir=ck, resume=True)
    for seed in spec.run_seeds:
        _assert_identical(full.result(seed), res.result(seed))


def test_resume_refuses_spec_mismatch(tmp_path):
    spec = _smoke(**{"engine.rounds": 3})
    ck = tmp_path / "ck"
    texp.sweep(spec, executor="sequential", device="cpu",
               checkpoint_dir=ck, stop_after=1)
    other = spec.override(**{"engine.eta": 0.2})
    with pytest.raises(ValueError, match="different spec"):
        texp.sweep(other, executor="sequential", device="cpu",
                   checkpoint_dir=ck, resume=True)
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
    assert all(r["executor"] == "vmap" and r["kind"] == "round"
               for r in recs)
    full = texp.sweep(_smoke(**{"engine.rounds": 4}), device="cpu")
    for r in recs:
        rep = full.result(r["seed"]).reports[r["round"]]
        assert (r["loss"], r["acc"], r["energy"]) == \
            (rep.loss, rep.acc, rep.energy)
    with pytest.raises(SystemExit, match="need --checkpoint"):
        _cli("run", "sweep_smoke", "--device", "cpu", "--resume")


def _local_world(G, seed=0, D=(90, 70, 100, 120)):
    rng = np.random.RandomState(seed)
    params = {"w0": torch.from_numpy(rng.normal(0, 0.3, (16, 8))
                                     .astype(np.float32)),
              "b0": torch.zeros(8),
              "w1": torch.from_numpy(rng.normal(0, 0.3, (8, 3))
                                     .astype(np.float32)),
              "b1": torch.zeros(3)}
    datasets = [{"x": rng.normal(size=(D[j % len(D)], 4, 4, 1))
                 .astype(np.float32),
                 "y": rng.randint(0, 3, D[j % len(D)]).astype(np.int32)}
                for j in range(G)]
    return ParamPlane.from_tree(params), datasets


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _same_result(a, b):
    assert torch.equal(a.params.data, b.params.data)
    assert torch.equal(a.d_i.data, b.d_i.data)
    assert (a.loss, a.num_examples, a.gamma) == (b.loss, b.num_examples,
                                                 b.gamma)


def test_train_multi_staged_against_per_run_local_train_batched():
    """Elements of two runs, each proximal to its own run's model and
    drawn one DPU at a time from its run's generator in group order,
    train in one staged group to the results each run's own group gives,
    and leave each generator where the run's own group leaves it."""
    (p_a, d_a), (p_b, d_b) = _local_world(3, seed=1), _local_world(2, 2)
    p_b = p_b.with_data(p_b.data * 0.5)
    kw = dict(gamma=2, m_frac=0.5, eta=0.1, mu=0.01)
    ga_want, gb_want = _gen(1), _gen(2)
    want = tfp.local_train_batched(p_a, classifier_loss, d_a,
                                   generator=ga_want, **kw) + \
        tfp.local_train_batched(p_b, classifier_loss, d_b,
                                generator=gb_want, **kw)
    datasets = d_a + d_b
    Ds = [len(d["y"]) for d in datasets]
    bucket = tfp._bucket(max(tfp.batch_size(D, 0.5) for D in Ds))
    ga, gb = _gen(1), _gen(2)
    cols = [tfp._draw_indices(g, [D], bucket, 2, 0.5, "cpu")
            for g, D in zip([ga] * 3 + [gb] * 2, Ds)]
    p_stack, acc, losses = tfp.train_multi_staged(
        torch.stack([p_a.data] * 3 + [p_b.data] * 2), p_a.spec,
        classifier_loss, tfp._stack_data(datasets, Ds, "cpu"),
        torch.cat([c[0] for c in cols], dim=1),
        torch.cat([c[1] for c in cols], dim=1), gamma=2, eta=0.1, mu=0.01)
    got = tfp._group_results(p_a.spec, p_stack, acc, losses, Ds, gamma=2,
                             m_frac=0.5, eta=0.1, mu=0.01)
    for a, b in zip(got, want):
        _same_result(a, b)
    assert torch.equal(ga.get_state(), ga_want.get_state())
    assert torch.equal(gb.get_state(), gb_want.get_state())


@pytest.mark.parametrize("over", [
    {},
    {"strategy": "cefl", "scenario": "static", "seeds": (0, 1, 2),
     "network.num_ue": 6},
    {"strategy": "fedavg", "scenario": "churn"},
], ids=["greedy_all_merge", "cefl_none_merge", "fedavg_churn_mixed"])
def test_vmap_merges_only_the_groups_runs_share(over, monkeypatch):
    """Each round, the vmap executor trains across runs exactly the runs
    that hold a (gamma, m, bucket) group another run holds too; every
    other run goes through its own SimExecutor, as in the sequential
    executor."""
    from repro_torch.core.engine import Engine, dpu_groups, live_dpus
    sw = importlib.import_module("repro_torch.experiments.sweep")
    keys, solo, merged = {}, {}, {}
    real_begin, real_exec = Engine.begin_round, Engine.execute_round
    real_merged = sw.VmapSweepExecutor._merged_rounds

    def begin_round(self, state, ues):
        st = real_begin(self, state, ues)
        keys.setdefault(st.t, {})[id(self)] = set(
            dpu_groups(st.plan, live_dpus(st.datasets)))
        return st

    def execute_round(self, state, st):
        solo.setdefault(st.t, set()).add(id(self))
        return real_exec(self, state, st)

    def merged_rounds(ctx, runs, staged, plans, run_keys):
        merged[staged[0].t] = {id(r.engine) for r in runs}
        return real_merged(ctx, runs, staged, plans, run_keys)

    monkeypatch.setattr(Engine, "begin_round", begin_round)
    monkeypatch.setattr(Engine, "execute_round", execute_round)
    monkeypatch.setattr(sw.VmapSweepExecutor, "_merged_rounds",
                        staticmethod(merged_rounds))
    spec = _smoke(**over)
    texp.sweep(spec, executor="vmap", device="cpu")
    assert sorted(keys) == list(range(spec.engine.rounds))
    for t, by_run in keys.items():
        shared = {r for r, ks in by_run.items()
                  if any(ks & o for q, o in by_run.items() if q != r)}
        assert merged.get(t, set()) == shared, t
        assert solo.get(t, set()) == set(by_run) - shared, t


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
        results = {}
        for executor in ("sequential", "vmap"):
            queue = _replay_draws(monkeypatch, draws)
            results[executor] = texp.sweep(tspec, executor=executor,
                                           device="cpu").result(1)
            assert not queue                  # every draw replayed
    finally:
        texp.clear_context_cache()
    _assert_identical(results["vmap"], results["sequential"])
    tr = results["sequential"]
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
