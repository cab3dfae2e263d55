"""The SCA solve's CUDA graph (``solver/sca.py``) against its eager outer
step.

On the CPU: the owner constants the solver caches per (dims, device) equal
the numpy constructions they replace, and a solve runs every outer step
eagerly.  On a card (tests marked ``card``, skipped without one): solves
that replay the captured step against the same solves with the step run
eagerly on the card, at paper width (20/10/5) and on a small world,
distributed and centralized: two solves on differently jittered rates
(the static inputs are refreshed, not stale), a warm-started solve, a
``tol`` that exits early, and a change of dims, which captures again.
The iteration counts, the rounded indicators, ``w`` and the objective
and violation histories must be equal bit for bit.

Two eager distributed solves on the card do not agree bit for bit:
``node_sq_norms`` sums with ``index_add``, whose atomics add in a varying
order, and the primal-dual loop carries the last-bit differences into
most components.  So the distributed solves compared bit for bit sum
those norms with the dense ownership matrix instead (no atomics), in
the eager and the replayed solve alike, and one more test holds the
replayed solve with the atomics against an eager one to a limit set from
the spread of eager against eager: relative gaps of 1.5e-8 to 5.5e-8
between eager solves at paper width (28 pairs on an NVIDIA H100), and
up to 9.2e-8 between a replayed and an eager one; the limit is 1e-6.

This file imports no JAX, so the card tests run where JAX is absent:
``python -m pytest --noconftest -o addopts= -p no:cacheprovider
tests/test_torch_sca_graph.py``.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core.convergence import MLConstants
from repro_torch.network.topology import NetworkConfig, make_network
from repro_torch.solver import sca
from repro_torch.solver import variables as V
from repro_torch.solver.objective import ObjectiveWeights

WORLDS = {"paper": (20, 10, 5), "small": (6, 3, 2)}
OW = ObjectiveWeights(xi1=1.0, xi2=1e-2, xi3=2.0)


@pytest.fixture(autouse=True)
def fresh():
    sca._graphs.clear()
    tracing.disable()
    tracing.clear()
    yield
    sca._graphs.clear()
    tracing.disable()
    tracing.clear()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _world(dims, seed=0):
    N, B, S = dims
    net = make_network(NetworkConfig(num_ue=N, num_bs=B, num_dc=S, seed=0))
    rng = np.random.RandomState(seed)
    consts = MLConstants(L=5.0, theta_i=rng.uniform(1.0, 3.0, N + S),
                         sigma_i=rng.uniform(2.0, 4.0, N + S), zeta1=2.0,
                         zeta2=1.0, F0_gap=2.3)
    D_bar = rng.normal(2000.0, 200.0, N)
    return net, consts, D_bar


def _solve(net, D_bar, consts, dev, **kw):
    """(result, the ``sca.solve`` span's counts)."""
    tracing.clear()
    tracing.enable()
    try:
        res = sca.solve(net, torch.as_tensor(D_bar, dtype=torch.float32,
                                             device=dev), consts, OW, **kw)
    finally:
        tracing.disable()
    solve = [s for s in tracing.spans() if s.name == "sca.solve"]
    assert len(solve) == 1
    return res, solve[0].attrs


def _eager(monkeypatch, *a, **kw):
    """The same solve with every outer step run eagerly on the card:
    (result, counts)."""
    with monkeypatch.context() as m:
        m.setattr(sca, "_graph_step", lambda key, step, args: (None, 0))
        return _solve(*a, **kw)


def _gap(a, b) -> float:
    """The relative 2-norm gap between two solves' ``w`` (each key over
    its largest magnitude in ``b``) and objective and violation histories
    (each over its largest entry in ``b``); 0.0 exactly when they agree
    bit for bit."""
    def vec(r):
        parts = [r.w[k].reshape(-1).double().cpu()
                 / max(float(b.w[k].abs().max()), 1e-30) for k in V.W_KEYS]
        for h in ("objective_history", "violation_history"):
            parts.append(torch.tensor(getattr(r, h), dtype=torch.float64)
                         / max(np.abs(getattr(b, h)).max(), 1e-30))
        return torch.cat(parts)
    x, y = vec(a), vec(b)
    return float((x - y).norm() / y.norm())


def _assert_same(got, want, limit=0.0):
    """Equal counts and rounded indicators, and ``w`` and the histories
    within ``limit`` (0: bit for bit)."""
    assert got.iterations == want.iterations
    assert got.pd_iterations == want.pd_iterations
    for k in ("I_s", "I_nb", "I_bn"):
        assert torch.equal(got.w_rounded[k], want.w_rounded[k]), k
    assert _gap(got, want) <= limit


@functools.lru_cache(maxsize=None)
def _ownership(dims, device):
    return torch.as_tensor(V.ownership_matrix(dims), device=device)


def _dense_sq_norms(d, dims):
    """``node_sq_norms`` by the dense (V, P) ownership matrix: a sum with
    no atomics, so eager solves repeat bit for bit."""
    return ((_ownership(tuple(dims), d.device) * d) ** 2).sum(1)


@pytest.fixture
def exact(monkeypatch):
    """``exact(distributed)``: sum the node norms without atomics where
    the solve is distributed."""
    def use(distributed):
        if distributed:
            monkeypatch.setattr(V, "node_sq_norms", _dense_sq_norms)
    return use


def _warm_start(res):
    w0 = {k: v.clone() for k, v in res.w_rounded.items()}
    for k, ax in (("I_s", 0), ("I_nb", 1), ("I_bn", 0)):
        w0[k] = 0.5 * w0[k] + 0.5 / w0[k].shape[ax]
    return w0


# ------------------------------------------------------------------ CPU

@pytest.mark.parametrize("dims", sorted(WORLDS.values()))
def test_owner_constants_equal_numpy(dims):
    own = V.owner_index(dims)
    got = V.owner_tensors(dims, "cpu")
    assert [t.dtype for t in got] == [torch.int64, torch.int64,
                                      torch.float32]
    np.testing.assert_array_equal(got[0].numpy(), own)
    np.testing.assert_array_equal(got[1].numpy(), np.maximum(own, 0))
    np.testing.assert_array_equal(got[2].numpy(),
                                  (own >= 0).astype(np.float32))
    # built once per (dims, device): the same tensors on every call
    again = V.owner_tensors(list(dims), torch.device("cpu"))
    assert all(a is b for a, b in zip(got, again))


@pytest.mark.parametrize("dims", sorted(WORLDS.values()))
def test_segment_ops_equal_the_ownership_matrix(dims):
    """The masked merge, each node's mask and the per-node squared norms
    on the cached constants against the dense (V, P) matrix."""
    M = torch.as_tensor(V.ownership_matrix(dims))
    Vn, P = M.shape
    g = torch.Generator().manual_seed(sum(dims))
    cands = torch.randn((Vn, P), generator=g)
    d = torch.randn(P, generator=g)
    merged = V.ownership_merge(cands, dims)
    torch.testing.assert_close(merged, (M * cands).sum(0), rtol=1e-6,
                               atol=1e-6)
    for v in range(Vn):
        assert torch.equal(V.owner_mask(torch.tensor(v), dims), M[v])
    torch.testing.assert_close(V.node_sq_norms(d, dims),
                               ((M * d) ** 2).sum(1), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("distributed", [False, True])
def test_cpu_solve_runs_every_outer_step_eagerly(distributed):
    net, consts, D_bar = _world(WORLDS["small"])
    res, counts = _solve(net, D_bar, consts, torch.device("cpu"),
                         max_outer=3, tol=0.0, distributed=distributed)
    assert res.iterations == 3
    assert counts["eager_outer"] == res.iterations
    assert counts["graph_replays"] == counts["graph_captures"] == 0
    assert not sca._graphs


# ----------------------------------------------------------------- card

@pytest.mark.card
@pytest.mark.parametrize("distributed", [False, True],
                         ids=["centralized", "distributed"])
@pytest.mark.parametrize("world", sorted(WORLDS))
def test_replays_equal_the_eager_step(world, distributed, card, exact,
                                      monkeypatch):
    """Two solves on differently jittered rates, then a warm-started one:
    one capture, every outer step a replay, each solve equal to the eager
    one bit for bit."""
    exact(distributed)
    net, consts, D_bar = _world(WORLDS[world])
    rng = np.random.RandomState(7)
    kw = dict(max_outer=4, tol=0.0, distributed=distributed)
    prev = None
    for i in range(3):
        net_i = net.resample_rates(rng, 0.15)
        if i == 2:
            kw["w0"] = _warm_start(prev)
        got, counts = _solve(net_i, D_bar, consts, card, **kw)
        want, eager = _eager(monkeypatch, net_i, D_bar, consts, card, **kw)
        _assert_same(got, want)
        if i:
            assert _gap(got, prev) > 0.0       # the new inputs were read
        assert counts["graph_captures"] == (i == 0)
        assert counts["graph_replays"] == got.iterations == 4
        assert counts["eager_outer"] == 0
        assert eager["eager_outer"] == 4 and eager["graph_replays"] == 0
        assert got.w["rho_nb"].device.type == "cuda"
        prev = got
    assert len(sca._graphs) == 1


@pytest.mark.card
def test_distributed_atomics_within_eager_spread(card, monkeypatch):
    """The distributed solve as the program runs it, ``index_add``'s
    atomics included: equal counts and rounded indicators, ``w`` and the
    histories within the limit set from eager solves' spread."""
    net, consts, D_bar = _world(WORLDS["paper"])
    net = net.resample_rates(np.random.RandomState(7), 0.15)
    kw = dict(max_outer=4, tol=0.0, distributed=True)
    for _ in range(2):
        got, counts = _solve(net, D_bar, consts, card, **kw)
        want, _ = _eager(monkeypatch, net, D_bar, consts, card, **kw)
        _assert_same(got, want, limit=1e-6)
        assert counts["graph_replays"] == 4


@pytest.mark.card
@pytest.mark.parametrize("distributed", [False, True],
                         ids=["centralized", "distributed"])
def test_tol_exits_early_as_eager(distributed, card, exact, monkeypatch):
    """A ``tol`` between the third and the second outer step's gain: the
    replayed solve stops after the third step, as the eager one does."""
    exact(distributed)
    net, consts, D_bar = _world(WORLDS["paper"])
    kw = dict(max_outer=8, distributed=distributed)
    full, _ = _eager(monkeypatch, net, D_bar, consts, card, tol=0.0, **kw)
    h = full.objective_history
    gains = np.diff(h) * -1.0 / abs(h[0])
    assert gains[0] > gains[1] > gains[2]
    kw["tol"] = float(np.sqrt(gains[1] * gains[2]))
    got, counts = _solve(net, D_bar, consts, card, **kw)
    want, _ = _eager(monkeypatch, net, D_bar, consts, card, **kw)
    _assert_same(got, want)
    assert got.iterations == 3
    assert counts["graph_replays"] == 3 and counts["eager_outer"] == 0


@pytest.mark.card
def test_new_dims_capture_again(card, monkeypatch):
    """A change of dims captures anew; the oldest of more than
    ``GRAPH_CACHE`` shapes is dropped and captured again on its return."""
    kw = dict(max_outer=2, tol=0.0, distributed=False)
    dims = [(6, 3, 2), (7, 3, 2), (8, 4, 2), (9, 4, 3), (10, 5, 3)]
    assert len(dims) > sca.GRAPH_CACHE
    for d in dims + dims[:1]:
        net, consts, D_bar = _world(d)
        got, counts = _solve(net, D_bar, consts, card, **kw)
        assert counts["graph_captures"] == 1, d
        want, _ = _eager(monkeypatch, net, D_bar, consts, card, **kw)
        _assert_same(got, want)
    assert len(sca._graphs) == sca.GRAPH_CACHE
    net, consts, D_bar = _world(dims[-1])
    _, counts = _solve(net, D_bar, consts, card, **kw)
    assert counts["graph_captures"] == 0


@pytest.mark.card
def test_failed_capture_runs_eagerly(card, monkeypatch):
    """A step that cannot be captured (here one that reads a number back
    to the host mid-step) warns once and runs eagerly, with the eager
    step's result."""
    outer = sca._outer_step

    def syncing(*a, **k):
        step = outer(*a, **k)

        def synced(*args):
            w, Lambda, reads = step(*args)
            float(reads[0])
            return w, Lambda, reads
        return synced

    net, consts, D_bar = _world(WORLDS["small"])
    kw = dict(max_outer=2, tol=0.0, distributed=False)
    want, _ = _eager(monkeypatch, net, D_bar, consts, card, **kw)
    monkeypatch.setattr(sca, "_outer_step", syncing)
    with pytest.warns(RuntimeWarning, match="capture"):
        got, counts = _solve(net, D_bar, consts, card, **kw)
    _assert_same(got, want)
    assert counts == dict(counts, graph_captures=0, graph_replays=0,
                          eager_outer=2)
    got, counts = _solve(net, D_bar, consts, card, **kw)  # no new attempt
    _assert_same(got, want)
    assert counts["eager_outer"] == 2 and counts["graph_captures"] == 0
