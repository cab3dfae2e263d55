"""The pieces of the PyTorch port's SCA solver against the JAX package's,
on the CPU: the flat decision vector, its scale, the distributed solver's
segment ops over the flat owner index, the constraint vector's maximum;
the rule that every solver tensor is made on its inputs' device (under a
``meta`` default device, a constructor without ``device=`` would make a
meta tensor and the mix would raise); and the reference's numpy oracle
staying in the reference.  The solve itself is held to the reference in
``test_torch_solver.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.solver import constraints as jK
from repro.solver import variables as jV
from repro_torch.network.topology import NetworkConfig as TNetCfg
from repro_torch.network.topology import make_network as tmake
from repro_torch.solver import consensus as tcons
from repro_torch.solver import constraints as tK
from repro_torch.solver import primal_dual as tpd
from repro_torch.solver import sca as tsca
from repro_torch.solver import variables as tV
from repro_torch.solver.objective import ObjectiveWeights as TOW
from test_torch_solver import GRID, IDS, _consts, _d_bar, _nets

torch.set_num_threads(2)


def test_solver_tensors_follow_their_inputs_device():
    """``project(init_w(...))`` and one primal-dual iteration (both forms)
    on CPU inputs under a ``meta`` default device: every tensor the
    solver makes must take its inputs' device, so nothing is meta and
    nothing mixes.  (The port's first solver pieces built theirs on the
    default device, which on the card mixed CUDA and CPU tensors.)"""
    net = tmake(TNetCfg(num_ue=6, num_bs=3, num_dc=2, seed=0))
    nv = tV.NetView.from_network(net, "cpu")
    D = torch.full((6,), 1000.0)
    W = torch.as_tensor(tcons.consensus_weights(net.adjacency),
                        dtype=torch.float32)
    th, sg = torch.full((8,), 2.0), torch.ones(8)
    spec = tV.WSpec(net.dims)
    scale = tV.Scaler(nv).flat(spec)
    zeros = {d: torch.zeros((net.node_count() if d else 1,
                             tK.num_constraints(spec.dims)))
             for d in (False, True)}
    torch.set_default_device("meta")
    try:
        w = tV.project(tV.init_w(nv, D), nv)
        assert {v.device.type for v in w.values()} == {"cpu"}
        x = spec.flatten(w) / scale
        for distributed in (False, True):
            fn = tpd.make_surrogate(
                spec, tpd.PDHyper(max_iters=1, consensus_rounds=2), TOW(),
                (4.0, 2.0, 1.0, 1.0), distributed=distributed)
            out = fn(x, zeros[distributed], nv, D, th, sg, scale, W)
            assert [o.device.type for o in out] == ["cpu"] * 4
            assert int(out[2]) == 1
    finally:
        torch.set_default_device("cpu")


def test_ref_backend_stays_in_the_reference():
    net = tmake(TNetCfg(num_ue=6, num_bs=3, num_dc=2, seed=0))
    _, tc = _consts(GRID[0][0])
    with pytest.raises(ValueError, match="repro.solver.ref"):
        tsca.solve(net, torch.full((6,), 1000.0), tc, TOW(), backend="ref")


@pytest.mark.parametrize("cfg,transform,zero_ue", GRID, ids=IDS)
def test_flat_spec_scaler_and_ownership_ops_equal_jax(cfg, transform,
                                                      zero_ue):
    """The flat decision vector, its scale, and the distributed solver's
    segment ops over the flat owner index (the masked merge, one node's
    mask, the per-node squared norms) against the reference's, and
    against the dense (V, P) ownership matrix they stand in for."""
    jnet, tnet = _nets(cfg, transform)
    dims = tnet.dims
    spec_t, spec_j = tV.WSpec(dims), jV.WSpec(dims)
    assert (spec_t.total, spec_t.offsets) == (spec_j.total, spec_j.offsets)
    np.testing.assert_array_equal(tV.owner_index(dims), jV.owner_index(dims))
    M = tV.ownership_matrix(dims)
    np.testing.assert_array_equal(M, jV.ownership_matrix(dims))
    rng = np.random.RandomState(cfg["seed"])
    Vn, P = M.shape
    cands = rng.normal(size=(Vn, P)).astype(np.float32)
    d = rng.normal(size=P).astype(np.float32)
    merged = tV.ownership_merge(torch.from_numpy(cands), dims).numpy()
    np.testing.assert_allclose(merged, np.einsum("vp,vp->p", M, cands),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        merged, np.asarray(jV.ownership_merge(jnp.asarray(cands), dims)),
        rtol=1e-6, atol=1e-6)
    for v in (0, Vn - 1, dims[0]):
        np.testing.assert_array_equal(
            tV.owner_mask(torch.tensor(v), dims).numpy(), M[v])
    sq = tV.node_sq_norms(torch.from_numpy(d), dims).numpy()
    np.testing.assert_allclose(sq, ((M * d) ** 2).sum(axis=1), rtol=1e-5)
    np.testing.assert_allclose(
        sq, np.asarray(jV.node_sq_norms(jnp.asarray(d), dims)), rtol=1e-5)
    # the scale vector, and the flat round trip of a feasible point
    nv = tV.NetView.from_network(tnet)
    sc = tV.Scaler(nv)
    np.testing.assert_allclose(
        sc.flat(spec_t).numpy(),
        np.asarray(jV.Scaler(jnet).flat(spec_j)), rtol=1e-7)
    D = torch.as_tensor(_d_bar(cfg, zero_ue), dtype=torch.float32)
    w = tV.project(tV.init_w(tnet, D), tnet)
    back = spec_t.unflatten(spec_t.flatten(w))
    assert all(torch.equal(back[k], w[k]) for k in w)
    # the most violated constraint of that point: the reference's value
    jw = jV.project(jV.init_w(jnet, D.numpy()), jnet)
    np.testing.assert_allclose(
        tK.max_violation(w, nv, D),
        jK.max_violation(jw, jnet, jnp.asarray(D.numpy())), rtol=1e-5)
