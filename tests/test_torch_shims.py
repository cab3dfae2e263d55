"""The port's deprecated shims (``repro_torch.core.cefl``) and the paper
helpers against the JAX package's, on the CPU.

* ``run_cefl`` warns and equals ``Engine(...).run(...).to_history()``
  under ``fixed:0`` (as ``tests/test_api.py``'s shim test does);
  ``decide`` warns and equals ``get_strategy(...).decide(...).to_w()``,
  and the reference's ``decide`` on the same network.
* ``dynamic_update``, ``sgd_variance_bound``, ``consensus_error``,
  ``a_norms`` and ``verify_accumulation_identity`` equal the reference's
  on seeded numpy inputs: within 1e-12 in f64, 1e-6 in f32.
* eq. (9) at mu = 0 after real local training stays within
  ``tests/test_fedprox.py``'s bar (1e-4).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cefl as jcefl
from repro.core import convergence as jconv
from repro.core import estimation as jest
from repro.core import fedprox as jfp
from repro.network import NetworkConfig as JNetworkConfig
from repro.network import make_network as jmake_network
from repro.solver import consensus as jcons
from repro.solver import ObjectiveWeights as JObjectiveWeights
from repro_torch.configs.cefl_paper import ClassifierConfig
from repro_torch.core import (CEFLOptions, Engine, EngineOptions,
                              MLConstants, SimExecutor, get_strategy,
                              realize_offloading, run_cefl)
from repro_torch.core import api as tapi
from repro_torch.core import cefl as tcefl
from repro_torch.core import engine as tengine
from repro_torch.core import estimation as test_
from repro_torch.core import fedprox as tfp
from repro_torch.data import make_image_dataset, make_online_ues
from repro_torch.kernels import ParamPlane
from repro_torch.models.classifier import (classifier_accuracy,
                                           classifier_loss,
                                           init_classifier_params)
from repro_torch.network import NetworkConfig, make_network
from repro_torch.solver import ObjectiveWeights, consensus_error
from repro_torch.solver.consensus import consensus_rounds, consensus_weights

torch.set_num_threads(2)

NET = make_network(NetworkConfig(num_ue=4, num_bs=2, num_dc=2))
JNET = jmake_network(JNetworkConfig(num_ue=4, num_bs=2, num_dc=2))
CONSTS = MLConstants(L=5.0, theta_i=np.ones(6) * 2, sigma_i=np.ones(6) * 3,
                     zeta1=2.0, zeta2=1.0)
D_BAR = np.array([500.0, 420.0, 610.0, 380.0])
CCFG = ClassifierConfig(input_shape=(8, 8, 1), hidden=(16,))


def test_shim_aliases_are_the_engine_names():
    assert CEFLOptions is EngineOptions
    assert tcefl.realize_offloading is realize_offloading \
        is tengine.realize_offloading


def test_run_cefl_shim_warns_and_matches_engine():
    (trx, tr_y), (tex, te_y) = make_image_dataset(2000, (8, 8, 1))
    p0 = init_classifier_params(torch.Generator().manual_seed(0), CCFG,
                                device="cpu")
    x, y = torch.from_numpy(tex[:200]), torch.from_numpy(te_y[:200])

    def eval_fn(p):
        return classifier_accuracy(p, x, y)

    def ues():
        return make_online_ues(trx, tr_y, num_ue=4, mean_arrivals=150,
                               std_arrivals=15, seed=0)

    opts = CEFLOptions(rounds=2, strategy="fixed:0", eta=0.1, solver_outer=2)
    with pytest.warns(DeprecationWarning, match="run_cefl is deprecated"):
        h = run_cefl(NET, ues(), init_params=p0, loss_fn=classifier_loss,
                     eval_fn=eval_fn, consts=CONSTS, ow=ObjectiveWeights(),
                     opts=opts, device="cpu")
    h2 = Engine(NET, "fixed:0", consts=CONSTS, ow=ObjectiveWeights(),
                opts=opts, executor=SimExecutor(), device="cpu").run(
        ues(), init_params=p0, loss_fn=classifier_loss,
        eval_fn=eval_fn).to_history()
    assert h == h2
    assert h["aggregator"] == [0, 0]
    assert np.isfinite(h["loss"]).all()


@pytest.mark.parametrize("strategy", ["fixed:0", "greedy_data", "fednova"])
def test_decide_shim_warns_and_matches_the_registry(strategy):
    opts = EngineOptions(solver_outer=2)
    with pytest.warns(DeprecationWarning, match="decide is deprecated"):
        w = tcefl.decide(strategy, NET, D_BAR, CONSTS, ObjectiveWeights(),
                         opts, device="cpu")
    ctx = tapi.DecisionContext(round=0, consts=CONSTS, ow=ObjectiveWeights(),
                               opts=opts, device=torch.device("cpu"))
    want = get_strategy(strategy).decide(
        NET, torch.as_tensor(D_BAR, dtype=torch.float32), ctx).to_w()
    assert w.keys() == want.keys()
    for k in w:
        assert torch.equal(w[k], want[k]), k
    # and the reference's shim on the same network
    jconsts = jconv.MLConstants(**dataclasses.asdict(CONSTS))
    with pytest.warns(DeprecationWarning, match="decide is deprecated"):
        jw = jcefl.decide(strategy, JNET, D_BAR, jconsts,
                          JObjectiveWeights(),
                          jcefl.EngineOptions(solver_outer=2))
    for k in w:
        np.testing.assert_allclose(w[k].numpy(), np.asarray(jw[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def _consts(rs, n):
    return dict(L=float(rs.rand() * 5), theta_i=rs.rand(n) * 3,
                sigma_i=rs.rand(n) * 2, zeta1=float(1 + rs.rand()),
                zeta2=float(rs.rand()), F0_gap=float(rs.rand() * 3))


def test_dynamic_update_and_sgd_variance_bound_equal_the_reference():
    rs = np.random.RandomState(3)
    for _ in range(5):
        old, new = _consts(rs, 7), _consts(rs, 7)
        got = test_.dynamic_update(MLConstants(**old), MLConstants(**new))
        want = jest.dynamic_update(jconv.MLConstants(**old),
                                   jconv.MLConstants(**new))
        for f in dataclasses.fields(got):
            np.testing.assert_allclose(getattr(got, f.name),
                                       getattr(want, f.name), rtol=0,
                                       atol=1e-12, err_msg=f.name)
    for m, D, sigma, theta in [(0.1, 500, 2.0, 3.0), (1.0, 10, 1.0, 1.0),
                               (0.0, 100, 0.5, 4.0), (0.37, 1, 1.3, 0.2),
                               (rs.rand(), 1234, rs.rand(), rs.rand())]:
        got = test_.sgd_variance_bound(m, D, sigma, theta)
        want = jest.sgd_variance_bound(m, D, sigma, theta)
        assert abs(got - want) <= 1e-12 * max(1.0, abs(want)), (got, want)


def test_consensus_error_equals_the_reference():
    rs = np.random.RandomState(1)
    W = consensus_weights(NET.adjacency)
    for shape in [(NET.node_count(), 5), (NET.node_count(), 2, 3)]:
        vals = rs.randn(*shape)
        for j in (0, 3, 30):
            v = consensus_rounds(vals, W, j)
            want = jcons.consensus_error(v)
            assert abs(consensus_error(v) - want) <= 1e-12
            assert abs(consensus_error(torch.from_numpy(v)) - want) <= 1e-12
            v32 = v.astype(np.float32)
            assert abs(consensus_error(torch.from_numpy(v32))
                       - jcons.consensus_error(jnp.asarray(v32))) <= 1e-6


def test_a_norms_equal_the_reference():
    for gamma, eta, mu in [(1, 0.1, 0.01), (4, 0.1, 0.5), (7, 0.05, 0.0),
                           (20, 0.2, 1.0)]:
        got = tfp.a_norms(gamma, eta, mu)
        want = jfp.a_norms(gamma, eta, mu)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            assert abs(float(g) - float(w)) <= 1e-6 * max(1.0, float(w))


def test_verify_accumulation_identity_equals_the_reference():
    rs = np.random.RandomState(5)
    shapes = {"b": (3,), "w": (6, 4)}

    def tree():
        return {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}

    for gamma, eta, mu in [(3, 0.05, 0.0), (5, 0.1, 0.2)]:
        p0, p, d = tree(), tree(), tree()
        want = jfp.verify_accumulation_identity(
            {k: jnp.asarray(v) for k, v in p0.items()},
            jfp.LocalResult(params={k: jnp.asarray(v) for k, v in p.items()},
                            d_i={k: jnp.asarray(v) for k, v in d.items()},
                            num_examples=10, gamma=gamma, sgd_flops=0.0),
            eta=eta, mu=mu)
        planes = [ParamPlane.from_numpy(t, device="cpu") for t in (p0, p, d)]
        got = tfp.verify_accumulation_identity(
            planes[0].to_tree(),
            tfp.LocalResult(params=planes[1], d_i=planes[2],
                            num_examples=10, gamma=gamma, sgd_flops=0.0),
            eta=eta, mu=mu)
        assert abs(got - want) <= 1e-6 * max(1.0, want), (got, want)


def test_eq9_identity_mu0():
    """eq. (9): with mu=0, sum_l a_l grad F == (x^t - x^{t,gamma})/eta."""
    cfg = ClassifierConfig(input_shape=(6, 6, 1), hidden=(16,))
    p0 = init_classifier_params(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    rs = np.random.RandomState(1)
    data = {"x": torch.from_numpy(rs.randn(16, 6, 6, 1).astype(np.float32)),
            "y": torch.from_numpy(rs.randint(0, 10, 16))}
    (res,) = tfp.local_train_batched(
        p0, classifier_loss, [data], gamma=3, m_frac=1.0, eta=0.05, mu=0.0,
        generator=torch.Generator().manual_seed(0))
    dev = tfp.verify_accumulation_identity(p0, res, eta=0.05, mu=0.0)
    assert dev < 1e-4, dev
