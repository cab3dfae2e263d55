"""The port's span recorder (``repro_torch.tracing``) and the spans the
program records with it, on the CPU at the quickstart size (6 UEs / 3 BSs
/ 2 DCs, 14x14x1 -> 64 -> 10).

Recording is off unless enabled or a profiler session is live; on, every
span of the round nests inside its parent and carries the round's id;
tracing on and off give the same bits; the counts equal what they count.
"""
import ast
import collections
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs.cefl_paper import ClassifierConfig
from repro_torch.core import api, engine, fedprox
from repro_torch.core.convergence import MLConstants
from repro_torch.data import synthetic as syn
from repro_torch.kernels import cuda as kcuda
from repro_torch.kernels.plane import as_plane
from repro_torch.models import classifier as cls
from repro_torch.network import topology as topo
from repro_torch.solver import sca
from repro_torch.solver.objective import ObjectiveWeights
from repro_torch.solver.primal_dual import PDHyper

torch.set_num_threads(2)

N, B, S = 6, 3, 2
ROUND_SPANS = {"scenario.step", "engine.offload", "executor.stage",
               "executor.train"}
SCA_SPANS = {"sca.solve", "sca.outer", "sca.sync"}
PARENT = {"scenario.step": "engine.round", "engine.offload": "engine.round",
          "sca.solve": "engine.round", "sca.outer": "sca.solve",
          "sca.sync": "sca.solve", "executor.stage": "engine.round",
          "executor.train": "engine.round"}


@pytest.fixture(autouse=True)
def fresh_store():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


@pytest.fixture(scope="module")
def world():
    (trx, tr_y), (tex, tey) = syn.make_image_dataset(6000, (14, 14, 1),
                                                     seed=0)
    net = topo.make_network(topo.NetworkConfig(num_ue=N, num_bs=B, num_dc=S,
                                               seed=0))
    consts = MLConstants(L=5.0, theta_i=np.full(N + S, 2.0),
                         sigma_i=np.full(N + S, 3.0))
    p0 = cls.init_classifier_params(
        torch.Generator().manual_seed(0),
        ClassifierConfig(input_shape=(14, 14, 1), hidden=(64,)),
        device="cpu")
    return dict(pool=(trx, tr_y), eval=(torch.from_numpy(tex[:500]),
                                        torch.from_numpy(tey[:500])),
                net=net, consts=consts, p0=p0)


def _engine(world, strategy):
    trx, tr_y = world["pool"]
    ex, ey = world["eval"]
    ues = syn.make_online_ues(trx, tr_y, num_ue=N, mean_arrivals=300.0,
                              std_arrivals=30.0, seed=0)
    eng = engine.Engine(world["net"], strategy, consts=world["consts"],
                        ow=ObjectiveWeights(),
                        opts=api.EngineOptions(rounds=3, eta=0.1, seed=0),
                        device="cpu")
    state = eng.init_loop(ues, init_params=world["p0"],
                          loss_fn=cls.classifier_loss,
                          eval_fn=lambda p: cls.classifier_accuracy(p, ex,
                                                                    ey))
    return eng, state, ues


def _rounds(world, strategy, n):
    """Run ``n`` rounds; returns the engine's state, the reports and the
    kernel launches of each round."""
    eng, state, ues = _engine(world, strategy)
    reports, launches = [], []
    for _ in range(n):
        before = dict(kcuda.LAUNCHES)
        staged = eng.begin_round(state, ues)
        loss, acc = eng.execute_round(state, staged)
        reports.append(eng.finish_round(state, staged, loss, acc))
        launches.append({k: v - before.get(k, 0)
                         for k, v in kcuda.LAUNCHES.items()})
    return state, reports, launches


def _inside(child, parent):
    return parent.t0 <= child.t0 <= child.t1 <= parent.t1


def test_off_by_default(world):
    assert not tracing.recording()
    _, reports, _ = _rounds(world, "greedy_data", 1)
    assert tracing.spans() == []
    assert reports[0].wall_time > 0


@pytest.mark.parametrize("strategy", ["cefl", "greedy_data"])
def test_round_span_tree(world, strategy):
    tracing.enable()
    state, reports, _ = _rounds(world, strategy, 2)
    spans = tracing.spans()
    assert all(s.t1 is not None for s in spans)
    rounds = [s for s in spans if s.name == "engine.round"]
    assert [s.round for s in rounds] == [0, 1] == \
        [r.round for r in reports]
    assert all(s.parent == -1 for s in rounds)
    want = ROUND_SPANS | (SCA_SPANS if strategy == "cefl" else set())
    # round 0 solves (reoptimize_every 1), every round stages and trains
    for t in (0, 1):
        names = {s.name for s in spans if s.round == t} - {"engine.round"}
        assert names == want, (t, names)
    for s in spans:
        if s.name == "engine.round":
            continue
        parent = spans[s.parent]
        assert parent.name == PARENT[s.name], (s, parent)
        assert _inside(s, parent)
        assert s.round == parent.round
    for sp, rep in zip(rounds, reports):
        # wall_time: the clock and bounds of engine.round
        assert 0 < rep.wall_time
        assert abs(rep.wall_time - (sp.t1 - sp.t0)) < 1e-3
    assert state.t == 2


def test_profiler_session_records(world):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.recording()
        eng, state, ues = _engine(world, "greedy_data")
        staged = eng.begin_round(state, ues)
        loss, acc = eng.execute_round(state, staged)
        eng.finish_round(state, staged, loss, acc)
    n = len(tracing.spans())
    assert n > 0 and {s.name for s in tracing.spans()} >= \
        ROUND_SPANS | {"engine.round"}
    assert not tracing.recording()
    staged = eng.begin_round(state, ues)
    loss, acc = eng.execute_round(state, staged)
    eng.finish_round(state, staged, loss, acc)
    assert len(tracing.spans()) == n


def _report_fields(rep):
    d = {k: v for k, v in vars(rep).items()
         if k not in ("wall_time", "plan")}
    d["plan"] = {k: v.numpy().copy() for k, v in rep.plan.to_w().items()}
    return d


@pytest.mark.parametrize("strategy", ["cefl", "greedy_data"])
def test_on_and_off_give_the_same_bits(world, strategy):
    off_state, off_reps, off_launches = _rounds(world, strategy, 2)
    assert tracing.spans() == []
    tracing.enable()
    on_state, on_reps, on_launches = _rounds(world, strategy, 2)
    assert tracing.spans()
    assert on_launches == off_launches
    assert torch.equal(as_plane(on_state.params).data,
                       as_plane(off_state.params).data)
    for a, b in zip(on_reps, off_reps):
        fa, fb = _report_fields(a), _report_fields(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            if k == "plan":
                for name in fa[k]:
                    np.testing.assert_array_equal(fa[k][name], fb[k][name])
            elif isinstance(fa[k], float) and np.isnan(fa[k]):
                assert np.isnan(fb[k]), k
            else:
                assert fa[k] == fb[k], k


@pytest.mark.parametrize("path", ["fused", "grouped"])
def test_h2d_bytes_are_the_staged_arrays(world, path):
    trx, tr_y = world["pool"]
    sizes = (150, 180, 170)
    datasets, start = [], 0
    for n in sizes:
        datasets.append({"x": trx[start:start + n],
                         "y": tr_y[start:start + n]})
        start += n
    want = sum(d["x"].nbytes + d["y"].nbytes for d in datasets)
    kw = dict(gamma=2, m_frac=0.25, eta=0.1, mu=0.01,
              generator=torch.Generator().manual_seed(0))
    tracing.enable()
    if path == "fused":
        fedprox.local_round_plane(world["p0"], cls.classifier_loss,
                                  datasets, theta=1.0, **kw)
    else:
        fedprox.local_train_batched(world["p0"], cls.classifier_loss,
                                    datasets, **kw)
    spans = tracing.spans()
    assert [s.name for s in spans] == ["executor.stage", "executor.train"]
    assert spans[0].attrs == {"h2d_bytes": want}
    assert spans[0].t1 <= spans[1].t0


@pytest.mark.parametrize("offload", ["greedy", "all"])
def test_offload_counts(world, offload, monkeypatch):
    """One round's ``engine.offload`` span counts the bytes of the rows
    the split was handed and of the rows it allocated: about one copy of
    each, and at most two even when every UE offloads all but one
    point."""
    eng, state, ues = _engine(world, "greedy_data")
    if offload == "all":
        decide = eng.decide

        def all_offload(*args, **kw):       # each UE's data to its BS
            plan = decide(*args, **kw)
            return plan.replace(rho_nb=plan.I_nb)

        monkeypatch.setattr(eng, "decide", all_offload)
    tracing.enable()
    staged = eng.begin_round(state, ues)
    (span,) = [s for s in tracing.spans() if s.name == "engine.offload"]
    if offload == "all":
        assert [len(d["y"]) for d in staged.datasets[:N]] == [1] * N
    # the split conserves rows, so its outputs hold the input's bytes
    held = sum(d["x"].nbytes + d["y"].nbytes for d in staged.datasets
               if d is not None)
    assert set(span.attrs) == {"offload_bytes", "round_bytes"}
    assert span.attrs["round_bytes"] == held > 0
    assert held <= span.attrs["offload_bytes"] <= 2 * held


@pytest.mark.parametrize("max_outer", [1, 3])
def test_sca_counts(world, max_outer):
    D_bar = torch.full((N,), 300.0)
    tracing.enable()
    res = sca.solve(world["net"], D_bar, world["consts"],
                    ObjectiveWeights(), max_outer=max_outer, tol=0.0)
    spans = tracing.spans()
    solve = spans[0]
    assert solve.name == "sca.solve" and solve.parent == -1
    # on the CPU every outer step runs eagerly: no graph is captured
    assert solve.attrs == {
        "pd_live": sum(res.pd_iterations),
        "pd_run": res.iterations * PDHyper().max_iters,
        "graph_replays": 0, "graph_captures": 0,
        "eager_outer": res.iterations}
    kids = [s for s in spans[1:] if s.parent == 0]
    assert len(kids) == len(spans) - 1
    names = [s.name for s in kids]
    assert names.count("sca.outer") == res.iterations
    assert names.count("sca.sync") == res.iterations + 1
    # the first read, then each outer step's enqueue and its one read
    assert names == ["sca.sync"] + ["sca.outer", "sca.sync"] * res.iterations
    assert all(_inside(s, solve) for s in kids)


def test_lm_step_spans():
    from repro_torch import configs
    from repro_torch.core.round_step import make_dpu_meta
    from repro_torch.data.synthetic import make_token_batches
    from repro_torch.experiments.lm import build_lm_step
    from repro_torch.experiments.spec import ModelSpec
    from repro_torch.kernels.plane import ParamPlane
    from repro_torch.models.lm import init_lm_params

    cfg = configs.reduced(configs.get_config("mamba2-130m"))
    plane = ParamPlane.from_tree(
        init_lm_params(torch.Generator().manual_seed(0), cfg))
    params = plane.with_data(plane.broadcast(2).data.contiguous())
    step = build_lm_step(cfg, ModelSpec(kind="lm", batch=4, seq=32, n_dpu=2,
                                        n_micro=1, gamma=2),
                         eta=1e-2, mu=1e-2)
    meta = make_dpu_meta(2, gammas=[2, 2], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_token_batches(
        cfg.vocab_size, 2, 1, 2, 32, seed=0).items()}
    params, _ = step(params, batch, meta)          # call 0, not recorded
    tracing.enable()
    step(params, batch, meta)
    every = tracing.spans()
    # each SSD layer's span sits inside a forward (or, recomputed under
    # remat, a backward): 2 layers x 2 DPUs, twice a local step
    ssd = [s for s in every if s.name == "mamba.ssd"]
    assert len(ssd) == 2 * 2 * 2 * 2
    assert all(every[s.parent].name in ("round_step.forward",
                                        "round_step.backward")
               for s in ssd)
    spans = [s for s in every if s.name != "mamba.ssd"]
    assert [(s.name, s.parent) for s in spans] == [
        ("round_step", -1),
        ("round_step.forward", 0), ("round_step.backward", 0),
        ("round_step.forward", 0), ("round_step.backward", 0)]
    assert {s.round for s in every} == {1}
    assert all(_inside(s, spans[0]) for s in every[1:])
    assert all(a.t1 <= b.t0 for a, b in zip(spans[1:], spans[2:]))


def test_mla_spans():
    """Each latent-attention layer call opens an ``attn.mla`` span with its
    tokens, S, heads and head dims, inside a forward (or, recomputed
    under remat, a backward); the leading dense layer's MLP sits in a
    ``mlp.dense`` span."""
    from repro_torch import configs
    from repro_torch.core.round_step import make_dpu_meta
    from repro_torch.data.synthetic import make_token_batches
    from repro_torch.experiments.lm import build_lm_step
    from repro_torch.experiments.spec import ModelSpec
    from repro_torch.kernels.plane import ParamPlane
    from repro_torch.models.lm import init_lm_params

    cfg = configs.reduced(configs.get_config("moonlight-16b-a3b"))
    plane = ParamPlane.from_tree(
        init_lm_params(torch.Generator().manual_seed(0), cfg,
                       torch.float32))
    params = plane.with_data(plane.broadcast(2).data.contiguous())
    step = build_lm_step(cfg, ModelSpec(kind="lm", batch=4, seq=32, n_dpu=2,
                                        n_micro=1, gamma=2),
                         eta=1e-2, mu=1e-2)
    batch = {k: torch.from_numpy(v) for k, v in make_token_batches(
        cfg.vocab_size, 2, 1, 2, 32, seed=0).items()}
    tracing.enable()
    step(params, batch, make_dpu_meta(2, gammas=[2, 2], device="cpu"))
    every = tracing.spans()
    mla = [s for s in every if s.name == "attn.mla"]
    # 2 layers x 2 DPUs, twice a local step (forward, remat recompute)
    assert len(mla) == 2 * 2 * 2 * 2
    assert all(s.attrs == {"tokens": 64, "S": 32, "heads": 4, "qk": 32,
                           "v": 16} for s in mla)
    dense = [s for s in every if s.name == "mlp.dense"]
    assert len(dense) == 1 * 2 * 2 * 2
    for s in mla + dense:
        assert every[s.parent].name in ("round_step.forward",
                                        "round_step.backward")
        assert _inside(s, every[s.parent])


def test_full_store_drops_oldest(monkeypatch):
    monkeypatch.setattr(tracing, "_store", collections.deque(maxlen=3))
    tracing.enable()
    with tracing.span("a", round=7):
        for name in "bcde":
            with tracing.span(name):
                tracing.count("n", 1)
        tracing.count("n", 5)
    spans = tracing.spans()
    assert [s.name for s in spans] == ["c", "d", "e"]
    assert [s.parent for s in spans] == [-1, -1, -1]      # "a" was dropped
    assert all(s.round == 7 and s.attrs == {"n": 1} for s in spans)
    assert tracing.dropped() == 2
    tracing.clear()
    assert tracing.spans() == [] and tracing.dropped() == 0


def test_begin_end_tokens_and_the_off_path():
    assert tracing.begin("x") is None
    tracing.end(None)
    assert tracing.span("x") is tracing.span("y")      # the shared no-op
    tracing.count("n", 1)                              # no open span
    tracing.enable()
    tok = tracing.begin("outer", round=3)
    with tracing.span("inner"):
        tracing.count("n", 2)
        tracing.count("n", 3)
    tracing.end(tok)
    outer, inner = tracing.spans()
    assert (outer.name, outer.parent, outer.round) == ("outer", -1, 3)
    assert (inner.name, inner.parent, inner.round) == ("inner", 0, 3)
    assert inner.attrs == {"n": 5} and outer.attrs == {}
    assert _inside(inner, outer)


def test_recorder_touches_no_tensor():
    """tracing.py imports only torch's profiler module, for its flag, and
    calls nothing of torch: no tensor op, no synchronize."""
    src = Path(tracing.__file__).read_text()
    tree = ast.parse(src)
    imports = [a.name for n in ast.walk(tree)
               if isinstance(n, (ast.Import, ast.ImportFrom))
               for a in n.names]
    modules = [n.module for n in ast.walk(tree)
               if isinstance(n, ast.ImportFrom)]
    assert [m for m in imports + modules if m and "torch" in m] == \
        ["torch.autograd.profiler"]
    used = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)
            and isinstance(n.value, ast.Name) and n.value.id == "_prof"}
    assert used == {"_is_profiler_enabled"}
    assert not any(isinstance(n, ast.Attribute) and n.attr == "synchronize"
                   for n in ast.walk(tree))
