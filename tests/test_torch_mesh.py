"""The PyTorch port's mesh round (``repro_torch.core.round_step`` and
``engine.MeshExecutor``) against the JAX package's, on the CPU, at the
small size of ``tests/test_plane.py`` (8x8x1 -> 16 -> 10, 4 UEs / 2 DCs).

The mesh round draws nothing, so both packages compute the same round on
the same numpy inputs, from the JAX package's initial params; the JAX
step runs with ``kernel_backend="cpu"`` (its plain references, as its own
CPU tests run it).  Tolerance of a round: ``rtol=1e-5, atol=1e-6`` on the
new params and the loss.  The two packages run the same f32 arithmetic in
different orders (XLA's and the CPU BLAS's dot products, XLA's fused
multiply-adds), so they differ by a few f32 ulps of each operand, and a
few SGD steps at eta 0.1 keep that below 1e-6 absolute at params near 1.

Also here: the port's own agreements (the plane form with the tree form,
the mesh executor with the simulation executor at m = 1) and the
executor's refusals.  The whole-engine runs against the JAX
``MeshExecutor`` live in ``test_torch_mesh_engine.py``, so that their JAX
compiles go to another worker.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.cefl_paper import ClassifierConfig as JConfig
from repro.core import round_step as jrs
from repro.kernels.plane import as_plane as j_as_plane
from repro.models import classifier as jcls
from repro_torch.core import api as tapi
from repro_torch.core import engine as tengine
from repro_torch.core import round_step as trs
from repro_torch.core.convergence import MLConstants as TConsts
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import ops
from repro_torch.kernels.plane import as_plane as t_as_plane
from repro_torch.models import classifier as tcls
from repro_torch.network import topology as ttopo
from repro_torch.solver.objective import ObjectiveWeights as TOW

torch.set_num_threads(2)

CFG = JConfig(input_shape=(8, 8, 1), hidden=(16,))
P0 = {k: np.array(v) for k, v in
      jcls.init_classifier_params(jax.random.PRNGKey(0), CFG).items()}
RTOL, ATOL = 1e-5, 1e-6


def _inputs(n_micro, mb=10, seed=0):
    rng = np.random.RandomState(seed)
    n = 3
    x = rng.normal(size=(n, n_micro, mb, 8, 8, 1)).astype(np.float32)
    y = rng.randint(0, 10, size=(n, n_micro, mb)).astype(np.int32)
    # m * mb lands on a ceil boundary: f32(0.1) * 10 rounds to 1.0 in f32
    # (one example) but exceeds 1 in f64 (two); 0.7 * 10 and 1.0 * 10 are
    # the other two cases
    meta = dict(gammas=[3, 2, 1], m_fracs=[0.1, 0.7, 1.0],
                weights=[120.0, 300.0, 45.0])
    return {"x": x, "y": y}, meta


def _jax_step(form, batch, meta, hyper):
    def micro_loss(p, micro, mask):
        return jcls.classifier_loss(p, micro, mask), {}

    step = jrs.build_cefl_round_step(micro_loss, jrs.CEFLHyper(
        kernel_backend="cpu", **hyper))
    n = batch["y"].shape[0]
    tree = {k: jnp.asarray(v) for k, v in P0.items()}
    if form == "plane":
        params = j_as_plane(tree).broadcast(n)
    else:
        params = {k: jnp.broadcast_to(v[None], (n,) + v.shape)
                  for k, v in tree.items()}
    new, metrics = step(params, {k: jnp.asarray(v) for k, v in batch.items()},
                        jrs.make_dpu_meta(n, **meta))
    if form == "plane":
        new = new.data
    else:
        new = {k: np.asarray(v) for k, v in new.items()}
    return new, float(metrics["loss"])


def _torch_step(form, batch, meta, hyper):
    step = trs.build_cefl_round_step(tcls.classifier_loss,
                                     trs.CEFLHyper(**hyper))
    n = batch["y"].shape[0]
    tree = tcls.params_from_numpy(P0, "cpu")
    if form == "plane":
        plane = t_as_plane(tree)
        params = plane.with_data(plane.broadcast(n).data.contiguous())
    else:
        params = {k: v.unsqueeze(0).expand((n,) + tuple(v.shape))
                  .contiguous() for k, v in tree.items()}
    new, metrics = step(params, {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                        trs.make_dpu_meta(n, device="cpu", **meta))
    if form == "plane":
        new = new.data
    else:
        new = {k: v.numpy() for k, v in new.items()}
    return new, float(metrics["loss"])


@pytest.mark.parametrize("form", ["plane", "tree"])
@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("mu", [0.0, 0.05])
def test_round_step_matches_jax(form, n_micro, mu):
    batch, meta = _inputs(n_micro)
    hyper = dict(eta=0.1, mu=mu, theta=1.5, gamma_max=3, n_micro=n_micro)
    jnew, jloss = _jax_step(form, batch, meta, hyper)
    tnew, tloss = _torch_step(form, batch, meta, hyper)
    if form == "plane":
        np.testing.assert_allclose(tnew.numpy(), np.asarray(jnew),
                                   rtol=RTOL, atol=ATOL)
        # every replica row holds the same global update
        assert torch.equal(tnew[0], tnew[2])
    else:
        assert set(tnew) == set(jnew)
        for k in jnew:
            np.testing.assert_allclose(tnew[k], jnew[k], rtol=RTOL,
                                       atol=ATOL)
    np.testing.assert_allclose(tloss, jloss, rtol=RTOL)


def test_round_step_coefficients_match_jax():
    """a_l1 and the mini-batch mask in the JAX package's f32 forms."""
    gam = np.array([1, 2, 3, 7], np.int32)
    for eta, mu in ((0.1, 0.01), (0.05, 0.2), (0.1, 0.0)):
        want = np.asarray(jrs.a_l1(jnp.asarray(gam), eta, mu))
        got = trs.a_l1(torch.from_numpy(gam), eta, mu).numpy()
        np.testing.assert_array_equal(got, want)
    mask = trs._example_mask(torch.tensor([0.1, 0.7, 1.0, 0.25]), 10)
    assert mask.sum(dim=1).tolist() == [1.0, 7.0, 10.0, 3.0]


@pytest.mark.parametrize("n_micro", [1, 2])
def test_plane_form_matches_tree_form(n_micro):
    """The port's plane form (kernels, plain versions here) against its
    own tree form (per-leaf torch): the same f32 math on the same data,
    to rtol 1e-6 / atol 1e-7 (the flat plane and the leaves take their
    matrix products over identical shapes; only the eq.-11 reduction
    differs, an einsum against a tensordot)."""
    batch, meta = _inputs(n_micro, seed=1)
    hyper = dict(eta=0.1, mu=0.05, theta=1.0, gamma_max=3, n_micro=n_micro)
    plane_new, plane_loss = _torch_step("plane", batch, meta, hyper)
    tree_new, tree_loss = _torch_step("tree", batch, meta, hyper)
    spec = t_as_plane(tcls.params_from_numpy(P0, "cpu")).spec
    got = spec.unflatten_batched(plane_new)
    for k in tree_new:
        np.testing.assert_allclose(got[k].numpy(), tree_new[k], rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose(plane_loss, tree_loss, rtol=1e-6)


def test_plane_round_launch_pattern_on_the_plane_ops(monkeypatch):
    """gamma_max fedprox_accum calls over all n DPUs with the per-DPU
    anchor, then one eq.-11 call on the (n, R, LANE) replica stack."""
    calls = []
    real_accum, real_nova = ops.fedprox_accum_plane, ops.nova_aggregate_plane

    def accum(x, g, anchor, acc, coef, active, eta, mu):
        calls.append(("accum", tuple(x.shape), tuple(anchor.shape),
                      [float(a) for a in active]))
        return real_accum(x, g, anchor, acc, coef, active, eta, mu)

    def nova(x, d, w, theta_eta):
        calls.append(("nova", tuple(x.shape), tuple(d.shape)))
        return real_nova(x, d, w, theta_eta)

    monkeypatch.setattr(ops, "fedprox_accum_plane", accum)
    monkeypatch.setattr(ops, "nova_aggregate_plane", nova)
    batch, meta = _inputs(1)
    _torch_step("plane", batch, meta, dict(eta=0.1, mu=0.01, gamma_max=3))
    shape = (3, 8, 1024)
    assert calls == [("accum", shape, shape, [1.0, 1.0, 1.0]),
                     ("accum", shape, shape, [1.0, 1.0, 0.0]),
                     ("accum", shape, shape, [1.0, 0.0, 0.0]),
                     ("nova", shape, shape)]


# ------------------------------------------------ engine, port only -----

def _port_engine(strategy, executor, **opt_kw):
    net = ttopo.make_network(ttopo.NetworkConfig(num_ue=4, num_bs=2,
                                                 num_dc=2))
    (trx, try_), (tex, tey) = tsyn.make_image_dataset(1200, (8, 8, 1))
    consts = TConsts(L=5.0, theta_i=np.ones(6) * 2, sigma_i=np.ones(6) * 3,
                     zeta1=2.0, zeta2=1.0)
    eng = tengine.Engine(net, strategy, consts=consts, ow=TOW(),
                         opts=tapi.EngineOptions(rounds=3, eta=0.1,
                                                 **opt_kw),
                         executor=executor, device="cpu")
    ues = tsyn.make_online_ues(trx, try_, num_ue=4, mean_arrivals=120,
                               std_arrivals=12, seed=0)
    ex, ey = torch.from_numpy(tex[:200]), torch.from_numpy(tey[:200])
    return eng.run(ues, init_params=tcls.params_from_numpy(P0, "cpu"),
                   loss_fn=tcls.classifier_loss,
                   eval_fn=lambda p: tcls.classifier_accuracy(p, ex, ey))


def test_sim_vs_mesh_executor_agree_at_full_batches():
    """``fixed:0`` with m = 1: the simulation executor's without-replacement
    draws are a permutation of each DPU's data, so both executors take the
    same full-batch steps up to summation order (the reference's
    ``test_api.py`` tolerances: accuracy within 0.02, params within
    1e-3); the plans, and so the energy, are identical."""
    kw = dict(m_default=1.0, gamma_default=2)
    sim = _port_engine("fixed:0", tengine.SimExecutor(), **kw)
    mesh = _port_engine("fixed:0", tengine.MeshExecutor(), **kw)
    np.testing.assert_allclose(sim.series("acc"), mesh.series("acc"),
                               atol=0.02)
    for k in sim.params:
        np.testing.assert_allclose(sim.params[k].numpy(),
                                   mesh.params[k].numpy(), atol=1e-3)
    np.testing.assert_allclose(sim.series("energy"), mesh.series("energy"),
                               rtol=1e-6)
    assert sim.series("aggregator") == mesh.series("aggregator")


def test_mesh_plane_path_matches_tree_path():
    """The reference's ``test_plane.py`` check, on the port: loss within
    1e-4 and params within 1e-5 over three ``fixed:0`` rounds."""
    plane = _port_engine("fixed:0", tengine.MeshExecutor(use_plane=True))
    tree = _port_engine("fixed:0", tengine.MeshExecutor(use_plane=False))
    np.testing.assert_allclose(plane.series("loss"), tree.series("loss"),
                               atol=1e-4)
    for k in plane.params:
        np.testing.assert_allclose(plane.params[k].numpy(),
                                   tree.params[k].numpy(), atol=1e-5)


def test_mesh_executor_refuses_what_the_mesh_round_cannot_run():
    mesh = tengine.MeshExecutor()
    kw = dict(loss_fn=tcls.classifier_loss, eta=0.1, mu=0.0, theta=None)
    with pytest.raises(NotImplementedError, match="FedAvg"):
        mesh.run_round(None, None, [], agg="fedavg", **kw)
    with pytest.raises(NotImplementedError, match="corruption"):
        mesh.run_round(None, None, [], agg="cefl",
                       corrupt=((0, "sign_flip", 4.0),), **kw)
    with pytest.raises(NotImplementedError, match="robust"):
        mesh.run_round(None, None, [], agg="cefl", robust_agg="median",
                       **kw)
    # the engine hands the executor its round's robust option
    with pytest.raises(NotImplementedError, match="robust"):
        _port_engine("fixed:0", tengine.MeshExecutor(),
                     robust_agg="trimmed_mean")


def test_mesh_step_cache_is_keyed_on_the_round_shape():
    mesh = tengine.MeshExecutor()
    a = mesh._get_step(tcls.classifier_loss, 3, 64, 2, 0.01, 0.1)
    assert mesh._get_step(tcls.classifier_loss, 3, 64, 2, 0.01, 0.1) is a
    assert mesh._get_step(tcls.classifier_loss, 4, 64, 2, 0.01, 0.1) is not a
    assert len(mesh._cache) == 2


def _old_mesh_batch(datasets, layout):
    """``MeshExecutor.stage``'s batch as its own staging loop built it:
    one zero-padded ``(n, 1, bucket, ...)`` stack per field, each live
    DPU copied in."""
    batch = {}
    for name, first in datasets[layout.dpus[0]].items():
        first = torch.as_tensor(first)
        stack = torch.zeros((len(layout.dpus), 1, layout.bucket)
                            + tuple(first.shape[1:]), dtype=first.dtype)
        for j, (i, D) in enumerate(zip(layout.dpus, layout.sizes)):
            stack[j, 0, :D].copy_(torch.as_tensor(datasets[i][name]))
        batch[name] = stack
    return batch


@pytest.mark.parametrize("sizes", [(40, 40, 40, 40), (30, 57, 12, 64)],
                         ids=["equal", "ragged"])
def test_mesh_stage_is_the_sim_staging(sizes):
    """``MeshExecutor.stage`` stages through ``fedprox._stack_data``: the
    batch equals the old layout bit for bit, zero padding included, over
    the live DPUs only (a DPU with no dataset and an empty one are
    left out), and the host bytes of every field are counted once as
    ``h2d_bytes`` of the open span."""
    from repro_torch import tracing

    rng = np.random.RandomState(3)
    datasets = [{"x": rng.normal(size=(D, 8, 8, 1)).astype(np.float32) + 1,
                 "y": rng.randint(1, 10, D).astype(np.int32)}
                for D in sizes]
    datasets.insert(1, None)
    datasets.insert(3, {"x": np.zeros((0, 8, 8, 1), np.float32),
                        "y": np.zeros((0,), np.int32)})
    n = len(datasets)
    zeros = {k: np.zeros(s, np.float32) for k, s in (
        ("rho_nb", (3, 2)), ("rho_bs", (2, 3)), ("f_n", 3), ("z_s", 3),
        ("I_s", 3), ("I_nb", (3, 2)), ("I_bn", (2, 3)), ("R_bs", (2, 3)),
        ("delta_A", ()), ("delta_R", ()))}
    plan = tapi.RoundPlan.from_w(dict(
        zeros, gamma=np.arange(n) % 3 + 1.0,
        m=np.linspace(0.2, 1.0, n)))
    layout = tengine.mesh_layout(plan, datasets)
    assert layout.dpus == [0, 2, 4, 5]
    tracing.clear()
    tracing.enable()
    try:
        with tracing.span("stage"):
            staged = tengine.MeshExecutor().stage(
                plan, datasets, agg="cefl", theta=None, device="cpu")
        (rec,) = tracing.spans()
    finally:
        tracing.disable()
        tracing.clear()
    want = _old_mesh_batch(datasets, layout)
    assert list(staged.batch) == list(want) == ["x", "y"]
    for k, v in want.items():
        assert staged.batch[k].dtype == v.dtype
        assert torch.equal(staged.batch[k], v), k
    assert rec.attrs == {"h2d_bytes": sum(
        datasets[i][k].nbytes for i in layout.dpus for k in ("x", "y"))}
