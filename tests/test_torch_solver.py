"""The PyTorch port's SCA solver (Algorithms 1-3) against the JAX package's
batched ``"jit"`` backend, on the CPU.

Parity bar: the one ``tests/test_solver_diff.py`` holds the reference's
two backends to (``_assert_parity`` below is a copy of it, reading each
package's own constraint vector): objective history within 1e-4 relative
at every outer iterate, identical rounded indicators, relaxed decisions
within 5e-3 of their scale, the rounded plans' constraint residuals
within 1e-3 of their scale and the violation history within 1e-2.  The
same grid of networks (including a single BS, a zero-data UE and a cut
server mesh), centralized and distributed.

Also: ``select_aggregator``, ``consensus_scan`` at J = 30 and the
primal-dual iteration count of the frozen-carry loop against the
reference's ``lax.while_loop``.  The solver's smaller pieces and its
device rule are in ``test_torch_solver_parts.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.convergence import MLConstants as JConsts
from repro.network import NetworkConfig as JNetCfg
from repro.network import make_network as jmake
from repro.solver import ObjectiveWeights as JOW
from repro.solver import PDHyper as JPD
from repro.solver import consensus as jcons
from repro.solver import constraints as jK
from repro.solver import primal_dual as jpd
from repro.solver import sca as jsca
from repro.solver import variables as jV
from repro_torch.core.convergence import MLConstants as TConsts
from repro_torch.network.topology import NetworkConfig as TNetCfg
from repro_torch.network.topology import make_network as tmake
from repro_torch.solver import consensus as tcons
from repro_torch.solver import constraints as tK
from repro_torch.solver import primal_dual as tpd
from repro_torch.solver import sca as tsca
from repro_torch.solver import variables as tV
from repro_torch.solver.objective import ObjectiveWeights as TOW

torch.set_num_threads(2)

PD = dict(max_iters=3, consensus_rounds=15)


def _cut_server_mesh(net):
    """Disconnect the DC-DC part of the consensus graph (degenerate mesh)."""
    N, B, S = net.dims
    A = np.array(net.adjacency)
    A[N + B:, N + B:] = 0
    return dataclasses.replace(net, adjacency=A)


GRID = [
    # (cfg kwargs, degenerate transform, zero-data UE)
    (dict(num_ue=6, num_bs=3, num_dc=2, seed=0), None, False),
    (dict(num_ue=5, num_bs=1, num_dc=2, seed=1), None, False),
    (dict(num_ue=8, num_bs=4, num_dc=3, seed=2), None, True),
    (dict(num_ue=6, num_bs=3, num_dc=3, seed=3), _cut_server_mesh, False),
]
IDS = ["base", "single_bs", "zero_data_ue", "cut_server_mesh"]


def _nets(cfg, transform):
    jn, tn = jmake(JNetCfg(**cfg)), tmake(TNetCfg(**cfg))
    if transform is not None:
        jn, tn = transform(jn), transform(tn)
    return jn, tn


def _consts(cfg):
    nd = cfg["num_ue"] + cfg["num_dc"]
    rng = np.random.RandomState(cfg["seed"] + 7)
    th, sg = rng.uniform(1.0, 3.0, nd), rng.uniform(0.5, 1.5, nd)
    kw = dict(L=4.0, zeta1=2.0, zeta2=1.0)
    return (JConsts(theta_i=th, sigma_i=sg, **kw),
            TConsts(theta_i=th, sigma_i=sg, **kw))


def _d_bar(cfg, zero_ue=False):
    rng = np.random.RandomState(cfg["seed"] + 13)
    D = rng.normal(1000.0, 100.0, cfg["num_ue"]).clip(100)
    if zero_ue:
        D[0] = 0.0
    return D


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_parity(jnet, tnet, D_bar, res_ref, res_port):
    # objective trajectory: 1e-4 relative agreement at every outer iterate
    ref_h = np.asarray(res_ref.objective_history)
    port_h = np.asarray(res_port.objective_history)
    assert ref_h.shape == port_h.shape
    np.testing.assert_allclose(port_h, ref_h, rtol=1e-4)
    # identical rounded plans (the executable decision)
    for k in ("I_s", "I_nb", "I_bn"):
        np.testing.assert_array_equal(
            _np(res_ref.w_rounded[k]), _np(res_port.w_rounded[k]),
            err_msg=f"rounded {k} differs")
    # continuous decisions agree tightly in physical units
    for k in ("rho_nb", "rho_bs", "f_n", "z_s", "gamma", "m", "R_bs"):
        a, b = _np(res_ref.w[k]), _np(res_port.w[k])
        scale = max(1.0, float(np.abs(a).max()))
        np.testing.assert_allclose(b, a, atol=5e-3 * scale,
                                   err_msg=f"relaxed {k} differs")
    # feasibility residuals of the rounded plan match
    v_ref = np.asarray(jK.constraint_vector(res_ref.w_rounded, jnet, D_bar))
    v_port = tK.constraint_vector(
        res_port.w_rounded, tV.NetView.from_network(tnet),
        torch.as_tensor(D_bar, dtype=torch.float32)).numpy()
    scale = max(1.0, float(np.abs(v_ref).max()))
    np.testing.assert_allclose(v_port, v_ref, atol=1e-3 * scale)
    np.testing.assert_allclose(res_port.violation_history,
                               res_ref.violation_history, atol=1e-2)


@pytest.mark.parametrize("cfg,transform,zero_ue", GRID, ids=IDS)
@pytest.mark.parametrize("distributed", [False, True],
                         ids=["centralized", "distributed"])
def test_port_solve_matches_jax_jit(cfg, transform, zero_ue, distributed):
    jnet, tnet = _nets(cfg, transform)
    D_bar = _d_bar(cfg, zero_ue)
    jc, tc = _consts(cfg)
    kw = dict(distributed=distributed, max_outer=2)
    res_ref = jsca.solve(jnet, D_bar, jc, JOW(), backend="jit",
                         pd=JPD(**PD), **kw)
    res_port = tsca.solve(tnet, torch.as_tensor(D_bar, dtype=torch.float32),
                          tc, TOW(), pd=tpd.PDHyper(**PD), **kw)
    _assert_parity(jnet, tnet, D_bar, res_ref, res_port)
    assert res_port.iterations == res_ref.iterations
    assert all(1 <= i <= PD["max_iters"] for i in res_port.pd_iterations)
    # the executable plan: the aggregator the enumeration picks
    jw = {k: jnp.asarray(_np(v)) for k, v in res_ref.w_rounded.items()}
    s_ref = jsca.select_aggregator(jw, jnet, jnp.asarray(D_bar, jnp.float32),
                                   jc, JOW())
    s_port = tsca.select_aggregator(res_port.w_rounded, tnet,
                                    torch.as_tensor(D_bar,
                                                    dtype=torch.float32),
                                    tc, TOW())
    assert s_port == s_ref


@pytest.mark.parametrize("cfg,transform,zero_ue", GRID[:3], ids=IDS[:3])
def test_select_aggregator_matches_jax(cfg, transform, zero_ue):
    """The exact enumeration of the floating aggregation point on plans
    whose relaxed I_s is near uniform (the case it exists for), with
    seeded offloading: the same DC in both packages."""
    jnet, tnet = _nets(cfg, transform)
    D_bar = _d_bar(cfg, zero_ue)
    jc, tc = _consts(cfg)
    N, B, S = tnet.dims
    rng = np.random.RandomState(cfg["seed"])
    for trial in range(4):
        w = {k: _np(v) for k, v in tV.project(
            tV.init_w(tnet, torch.as_tensor(D_bar, dtype=torch.float32)),
            tnet).items()}
        w["rho_nb"] = (rng.dirichlet(np.ones(B + 1), N)[:, :B] * 0.8) \
            .astype(np.float32)
        w["rho_bs"] = rng.dirichlet(np.ones(S), B).astype(np.float32)
        w["I_s"] = (np.full(S, 1.0 / S) + rng.normal(0, 1e-3, S)) \
            .astype(np.float32)
        s_ref = jsca.select_aggregator(
            {k: jnp.asarray(v) for k, v in w.items()}, jnet,
            jnp.asarray(D_bar, jnp.float32), jc, JOW(xi3=2.0))
        s_port = tsca.select_aggregator(
            {k: torch.from_numpy(np.asarray(v)) for k, v in w.items()},
            tnet, torch.as_tensor(D_bar, dtype=torch.float32), tc,
            TOW(xi3=2.0))
        assert s_port == s_ref, trial


def test_consensus_weights_and_scan_at_30_rounds():
    """Doubly stochastic Xiao-Boyd weights (numpy in both packages, equal
    bit for bit) and the J = 30 mixing rounds as 30 successive products:
    f32 matrix products that XLA and torch may sum in other orders, so
    rtol 1e-5 against the reference's ``lax.scan``."""
    net = tmake(TNetCfg(num_ue=20, num_bs=10, num_dc=5, seed=0))
    W = tcons.consensus_weights(net.adjacency)
    np.testing.assert_array_equal(W, jcons.consensus_weights(net.adjacency))
    np.testing.assert_allclose(W.sum(axis=0), 1.0, atol=1e-12)
    vals = np.random.RandomState(1).uniform(0, 2, (35, 85)) \
        .astype(np.float32)
    W32 = W.astype(np.float32)
    got = tcons.consensus_scan(torch.from_numpy(vals),
                               torch.from_numpy(W32), 30).numpy()
    want = np.asarray(jcons.consensus_scan(jnp.asarray(vals),
                                           jnp.asarray(W32), 30))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got, tcons.consensus_rounds(vals, W, 30), rtol=1e-4, atol=1e-5)
    # averaging preserves the network-wide mean
    np.testing.assert_allclose(got.mean(axis=0), vals.mean(axis=0),
                               rtol=1e-4)


def _surrogates(distributed, hyper):
    cfg = GRID[0][0]
    jnet, tnet = _nets(cfg, None)
    D_bar = _d_bar(cfg)
    jc, tc = _consts(cfg)
    spec_j, spec_t = jV.WSpec(jnet.dims), tV.WSpec(tnet.dims)
    ow_j, ow_t = JOW(), TOW()
    cs = (4.0, 2.0, 1.0, 1.0)
    jfn = jpd.make_surrogate(spec_j, JPD(**hyper), ow_j, cs,
                             distributed=distributed)
    tfn = tpd.make_surrogate(spec_t, tpd.PDHyper(**hyper), ow_t, cs,
                             distributed=distributed)
    nv_j = jV.NetView.from_network(jnet)
    nv_t = tV.NetView.from_network(tnet)
    scale_j = jV.Scaler(jnet).flat(spec_j)
    scale_t = tV.Scaler(nv_t).flat(spec_t)
    wj = jV.project(jV.init_w(jnet, D_bar), jnet)
    wj = jsca.apply_required_deltas(wj, jnet, D_bar, slack=1.05)
    x = np.array(spec_j.flatten(wj) / scale_j)
    V_n = jnet.node_count() if distributed else 1
    nC = jK.num_constraints(jnet)
    W = jcons.consensus_weights(jnet.adjacency).astype(np.float32) \
        if distributed else np.zeros((1, 1), np.float32)
    j_out = jfn(jnp.asarray(x), jnp.zeros((V_n, nC)), nv_j,
                jnp.asarray(D_bar, jnp.float32),
                jnp.asarray(jc.theta_i, jnp.float32),
                jnp.asarray(jc.sigma_i, jnp.float32), scale_j,
                jnp.asarray(W))
    t_out = tfn(torch.from_numpy(x), torch.zeros((V_n, nC)), nv_t,
                torch.as_tensor(D_bar, dtype=torch.float32),
                torch.as_tensor(tc.theta_i, dtype=torch.float32),
                torch.as_tensor(tc.sigma_i, dtype=torch.float32), scale_t,
                torch.from_numpy(W))
    return j_out, t_out


@pytest.mark.parametrize("distributed", [False, True],
                         ids=["centralized", "distributed"])
@pytest.mark.parametrize("hyper", [
    dict(max_iters=1, consensus_rounds=5),
    dict(max_iters=8, consensus_rounds=30),
    dict(max_iters=8, consensus_rounds=30, tol=0.5),
], ids=["one", "eight", "early_exit"])
def test_pd_iteration_count_matches_the_while_loop(distributed, hyper):
    """The frozen-carry loop runs every iteration and freezes once the
    reference's exit test fails: the same count of alternations (1, up to
    8, and an early exit at a loose tol), the same iterate and duals."""
    (jw, jL, jit_, jv), (tw, tL, tit, tv) = _surrogates(distributed, hyper)
    assert int(tit) == int(jit_)
    if hyper.get("tol"):
        assert int(tit) < hyper["max_iters"]
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tL.numpy(), np.asarray(jL), rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-3, atol=1e-4)
