"""The PyTorch port's local training and aggregation against the JAX
package's, on the same staged inputs.

``jax.random`` (mini-batch draws) cannot be reproduced in torch, so the
rounds are compared at the staged-input level: the JAX helpers stage one
group's data stack, mini-batch indices and weights, and both packages run
their round function on exactly those arrays.  Tolerances: the new plane
``rtol=1e-5, atol=1e-6`` and the per-step losses ``rtol=1e-5`` (f32
matrix products and reductions summed in another order by XLA and by
torch on the CPU, over a few SGD steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.cefl_paper import ClassifierConfig as JConfig
from repro.core import aggregation as jagg
from repro.core import fedprox as jfp
from repro.kernels.plane import ParamPlane as JPlane
from repro.models import classifier as jcls
from repro_torch.core import aggregation as tagg
from repro_torch.core import fedprox as tfp
from repro_torch.kernels.plane import ParamPlane as TPlane
from repro_torch.models import classifier as tcls

torch.set_num_threads(2)

GAMMA, M_FRAC, ETA, MU, THETA = 3, 0.5, 0.1, 0.01, 1.7
SIZES = (150, 170, 200)           # batch sizes 75 / 85 / 100: one bucket


def _world():
    """JAX initial params of the quickstart classifier (as numpy), three
    DPU datasets and an eval set, all made from seeds."""
    cfg = JConfig(input_shape=(14, 14, 1), hidden=(64,))
    p0 = {k: np.array(v) for k, v in
          jcls.init_classifier_params(jax.random.PRNGKey(0), cfg).items()}
    rng = np.random.RandomState(1)
    datasets = [{"x": rng.normal(size=(D, 14, 14, 1)).astype(np.float32),
                 "y": rng.randint(0, 10, D).astype(np.int32)}
                for D in SIZES]
    ex = rng.normal(size=(300, 14, 14, 1)).astype(np.float32)
    ey = rng.randint(0, 10, 300).astype(np.int32)
    return p0, datasets, (ex, ey)


def _jax_staged(p0, datasets):
    """The ten arguments ``local_round_plane`` hands ``_plane_round_fn``,
    built with the JAX helpers from fixed keys."""
    plane = JPlane.from_tree({k: jnp.asarray(v) for k, v in p0.items()})
    G = len(datasets)
    Ds = [len(d["y"]) for d in datasets]
    bucket = jfp._bucket(max(jfp.batch_size(D, M_FRAC) for D in Ds))
    keys = [jax.random.PRNGKey(10 + j) for j in range(G)]
    step_keys = jax.vmap(lambda k: jax.random.split(k, GAMMA))(
        jnp.stack(keys))
    jd = [{k: jnp.asarray(v) for k, v in d.items()} for d in datasets]
    data_stack, idx, weights = jfp._stage_group_batches(
        jd, step_keys, Ds, bucket, GAMMA, M_FRAC)
    a = jfp.a_coefficients(GAMMA, ETA, MU)
    args = (plane.broadcast(G).data, plane.data, data_stack, idx, weights,
            a, jnp.asarray(ETA, jnp.float32), jnp.asarray(MU, jnp.float32),
            jnp.asarray(Ds, jnp.float32),
            jnp.asarray(THETA * ETA, jnp.float32))
    return plane, keys, jd, args


def _to_torch(x):
    return torch.from_numpy(np.array(x))


def _torch_staged(args):
    """The JAX staged tuple as CPU tensors (copied: arrays from JAX are
    read-only)."""
    p0, anchor, data_stack, idx, weights, a, eta, mu, w_abs, te = args
    return (_to_torch(p0), _to_torch(anchor),
            {k: _to_torch(v) for k, v in data_stack.items()},
            _to_torch(idx).long(), _to_torch(weights), _to_torch(a),
            float(eta), float(mu), _to_torch(w_abs), float(te))


def test_fused_round_matches_jax():
    p0, datasets, (ex, ey) = _world()
    jplane, _, _, args = _jax_staged(p0, datasets)
    jex, jey = jnp.asarray(ex), jnp.asarray(ey)
    jrun = jfp._plane_round_fn(
        jcls.classifier_loss, jplane.spec, "cpu",
        lambda p: jcls.classifier_accuracy(p, jex, jey))
    jnew, jlosses, jacc = jrun(*args)

    tplane = TPlane.from_numpy(p0, device="cpu")
    tex, tey = torch.from_numpy(ex), torch.from_numpy(ey).long()
    trun = tfp._plane_round_fn(
        tcls.classifier_loss, tplane.spec,
        lambda p: tcls.classifier_accuracy(p, tex, tey))
    tnew, tlosses, tacc = trun(*_torch_staged(args))

    np.testing.assert_allclose(tnew.numpy(), np.asarray(jnew),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses),
                               rtol=1e-5)
    # the same model up to f32 rounding classifies the same examples; one
    # example may flip where its top two logits tie to within that rounding
    assert abs(float(tacc) - float(jacc)) * len(ey) <= 1


def test_unfused_group_and_aggregation_match_jax(monkeypatch):
    p0, datasets, _ = _world()
    jplane, keys, jd, args = _jax_staged(p0, datasets)
    jres = jfp._local_train_batched_plane(
        jplane, jcls.classifier_loss, jd, gamma=GAMMA, m_frac=M_FRAC,
        eta=ETA, mu=MU, keys=keys, keep_planes=True, kernel_backend="cpu")

    tplane = TPlane.from_numpy(p0, device="cpu")
    staged = _torch_staged(args)
    # the group's mini-batches are the JAX package's draws
    monkeypatch.setattr(tfp, "_draw_indices",
                        lambda *a: (staged[3], staged[4]))
    tres = tfp.local_train_batched(
        tplane, tcls.classifier_loss, datasets, gamma=GAMMA, m_frac=M_FRAC,
        eta=ETA, mu=MU, generator=torch.Generator())

    for j, t in zip(jres, tres):
        np.testing.assert_allclose(t.params.data.numpy(),
                                   np.asarray(j.params.data),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(t.d_i.data.numpy(),
                                   np.asarray(j.d_i.data),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(t.loss, j.loss, rtol=1e-5)
        assert (t.num_examples, t.gamma) == (j.num_examples, j.gamma)
        assert t.sgd_flops == pytest.approx(j.sgd_flops)

    Ds = list(SIZES)
    jnew = jagg.aggregate(jplane, [r.d_i for r in jres], Ds, theta=THETA,
                          eta=ETA)
    tnew = tagg.aggregate(tplane, [r.d_i for r in tres], Ds, theta=THETA,
                          eta=ETA)
    np.testing.assert_allclose(tnew.data.numpy(), np.asarray(jnew.data),
                               rtol=1e-5, atol=1e-6)
    jnova = jagg.fednova_aggregate(jplane, [r.d_i for r in jres], Ds,
                                   [GAMMA, 2, 4], eta=ETA)
    tnova = tagg.fednova_aggregate(tplane, [r.d_i for r in tres], Ds,
                                   [GAMMA, 2, 4], eta=ETA)
    np.testing.assert_allclose(tnova.data.numpy(), np.asarray(jnova.data),
                               rtol=1e-5, atol=1e-6)
    javg = jagg.fedavg_aggregate([r.params for r in jres], Ds)
    tavg = tagg.fedavg_aggregate([r.params for r in tres], Ds)
    np.testing.assert_allclose(tavg.data.numpy(), np.asarray(javg.data),
                               rtol=1e-5, atol=1e-6)


def test_bs_relay_sum_matches_jax():
    rng = np.random.RandomState(3)
    planes = [rng.normal(size=(8, 1024)).astype(np.float32)
              for _ in range(4)]
    groups = [[0, 2], [], [1, 3]]
    jp = jagg.bs_relay_sum([JPlane(jnp.asarray(p), None) for p in planes],
                           groups)
    tp = tagg.bs_relay_sum([TPlane(torch.from_numpy(p), None)
                            for p in planes], groups)
    assert len(tp) == len(jp) == 2
    for t, j in zip(tp, jp):
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))


def test_fused_round_equals_unfused_round_in_the_port():
    """``local_round_plane`` is ``local_train_batched`` + ``aggregate``:
    from the same generator seed both draw the same mini-batches."""
    p0, datasets, _ = _world()
    plane = TPlane.from_numpy(p0, device="cpu")
    fused, losses, acc = tfp.local_round_plane(
        plane, tcls.classifier_loss, datasets, gamma=GAMMA, m_frac=M_FRAC,
        eta=ETA, mu=MU, generator=torch.Generator().manual_seed(5),
        theta=THETA)
    assert acc is None
    res = tfp.local_train_batched(
        plane, tcls.classifier_loss, datasets, gamma=GAMMA, m_frac=M_FRAC,
        eta=ETA, mu=MU, generator=torch.Generator().manual_seed(5))
    unfused = tagg.aggregate(plane, [r.d_i for r in res], list(SIZES),
                             theta=THETA, eta=ETA)
    np.testing.assert_allclose(fused.data.numpy(), unfused.data.numpy(),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(losses, [r.loss for r in res], rtol=1e-6)


def test_empty_dpus_train_nothing():
    p0, datasets, _ = _world()
    plane = TPlane.from_numpy(p0, device="cpu")
    empty = {"x": datasets[0]["x"][:0], "y": datasets[0]["y"][:0]}
    res = tfp.local_train_batched(
        plane, tcls.classifier_loss, [empty, datasets[1]], gamma=2,
        m_frac=M_FRAC, eta=ETA, mu=MU,
        generator=torch.Generator().manual_seed(0))
    assert res[0].num_examples == 0 and np.isnan(res[0].loss)
    assert torch.equal(res[0].params.data, plane.data)
    assert not torch.any(res[0].d_i.data)
    assert res[1].num_examples == SIZES[1]


@pytest.mark.parametrize("gamma", [1, 2, 5])
@pytest.mark.parametrize("eta,mu", [(0.1, 0.01), (0.05, 0.0), (0.3, 0.5)])
def test_a_coefficients_match_jax(gamma, eta, mu):
    np.testing.assert_allclose(
        tfp.a_coefficients(gamma, eta, mu).numpy(),
        np.asarray(jfp.a_coefficients(gamma, eta, mu)), rtol=1e-7)


@pytest.mark.parametrize("D", [0, 1, 2, 7, 150, 301, 2000])
@pytest.mark.parametrize("m", [0.05, 0.5, 1.0])
def test_batch_size_and_bucket_match_jax(D, m):
    b = tfp.batch_size(D, m)
    assert b == jfp.batch_size(D, m)
    assert tfp._bucket(b) == jfp._bucket(b)


def test_batched_loss_is_per_dpu_loss():
    p0, datasets, _ = _world()
    params = tcls.params_from_numpy(p0, device="cpu")
    x = torch.from_numpy(datasets[0]["x"][:32])
    y = torch.from_numpy(datasets[0]["y"][:32])
    w = torch.ones(32)
    single = tcls.classifier_loss(params, {"x": x, "y": y}, w)
    batched = tcls.classifier_loss(
        {k: torch.stack([v, v]) for k, v in params.items()},
        {"x": torch.stack([x, x]), "y": torch.stack([y, y])},
        torch.stack([w, w]))
    assert batched.shape == (2,)
    torch.testing.assert_close(batched, torch.stack([single, single]))
    jloss = jcls.classifier_loss({k: jnp.asarray(v) for k, v in p0.items()},
                                 {"x": jnp.asarray(datasets[0]["x"][:32]),
                                  "y": jnp.asarray(datasets[0]["y"][:32])},
                                 jnp.ones(32))
    np.testing.assert_allclose(float(single), float(jloss), rtol=1e-5)
