"""A whole ``Engine(executor=MeshExecutor())`` run of the PyTorch port
against the JAX package's, on the CPU, at the small size of
``tests/test_plane.py`` (4 UEs / 2 BSs / 2 DCs, 8x8x1 -> 16 -> 10), from
the JAX package's initial params, three rounds.

The mesh round draws nothing (its mini-batches are the leading slice of
each DPU's data), and plans, offloading and costs run on the same numpy
streams in both packages, so the two runs compute the same rounds.
Tolerances: plans, energy and delay to ``rtol=1e-5`` (f32 rounding of
the cost model, as in ``test_torch_engine.py``); the per-round loss to
``rtol=1e-5`` and the final params to ``rtol=1e-5, atol=1e-6``, the f32
arithmetic of ``test_torch_mesh.py`` carried over three rounds; the
count of correct predictions on 200 eval examples exactly (the two
packages' f32 means of it may differ in the last bit).

The ``greedy_data`` and ``fednova`` runs live in
``test_torch_mesh_engine_greedy.py`` so that the JAX runs (mostly XLA
compiles) go to two test workers.
"""
import jax
import jax.numpy as jnp
import numpy as np

from repro.configs.cefl_paper import ClassifierConfig as JConfig
from repro.core import api as japi
from repro.core import engine as jengine
from repro.core.convergence import MLConstants as JConsts
from repro.data import synthetic as jsyn
from repro.models import classifier as jcls
from repro.network import topology as jtopo
from repro.solver.objective import ObjectiveWeights as JOW
from repro_torch.core import api as tapi
from repro_torch.core import engine as tengine
from repro_torch.core.convergence import MLConstants as TConsts
from repro_torch.data import synthetic as tsyn
from repro_torch.models import classifier as tcls
from repro_torch.network import topology as ttopo
from repro_torch.solver.objective import ObjectiveWeights as TOW

import torch

torch.set_num_threads(2)

N, B, S = 4, 2, 2
ROUNDS = 3
N_EVAL = 200
CFG = JConfig(input_shape=(8, 8, 1), hidden=(16,))


def _world():
    p0 = {k: np.array(v) for k, v in
          jcls.init_classifier_params(jax.random.PRNGKey(0), CFG).items()}
    return p0, jsyn.make_image_dataset(1200, (8, 8, 1), seed=0)


def _jax_run(strategy, p0, pool):
    (trx, try_), (tex, tey) = pool
    net = jtopo.make_network(jtopo.NetworkConfig(num_ue=N, num_bs=B,
                                                 num_dc=S))
    consts = JConsts(L=5.0, theta_i=np.ones(N + S) * 2,
                     sigma_i=np.ones(N + S) * 3, zeta1=2.0, zeta2=1.0)
    eng = jengine.Engine(net, strategy, consts=consts, ow=JOW(),
                         opts=japi.EngineOptions(rounds=ROUNDS, eta=0.1,
                                                 kernel_backend="cpu"),
                         executor=jengine.MeshExecutor(kernel_backend="cpu"))
    ues = jsyn.make_online_ues(trx, try_, num_ue=N, mean_arrivals=120,
                               std_arrivals=12, seed=0)
    ex, ey = jnp.asarray(tex[:N_EVAL]), jnp.asarray(tey[:N_EVAL])
    return eng.run(ues, init_params={k: jnp.asarray(v)
                                     for k, v in p0.items()},
                   loss_fn=jcls.classifier_loss,
                   eval_fn=lambda p: jcls.classifier_accuracy(p, ex, ey))


def _torch_run(strategy, p0, pool):
    (trx, try_), (tex, tey) = pool
    net = ttopo.make_network(ttopo.NetworkConfig(num_ue=N, num_bs=B,
                                                 num_dc=S))
    consts = TConsts(L=5.0, theta_i=np.ones(N + S) * 2,
                     sigma_i=np.ones(N + S) * 3, zeta1=2.0, zeta2=1.0)
    eng = tengine.Engine(net, strategy, consts=consts, ow=TOW(),
                         opts=tapi.EngineOptions(rounds=ROUNDS, eta=0.1),
                         executor=tengine.MeshExecutor(), device="cpu")
    ues = tsyn.make_online_ues(trx, try_, num_ue=N, mean_arrivals=120,
                               std_arrivals=12, seed=0)
    ex = torch.from_numpy(tex[:N_EVAL])
    ey = torch.from_numpy(tey[:N_EVAL])
    return eng.run(ues, init_params=tcls.params_from_numpy(p0, "cpu"),
                   loss_fn=tcls.classifier_loss,
                   eval_fn=lambda p: tcls.classifier_accuracy(p, ex, ey))


def check_mesh_run_matches_jax(strategy):
    p0, pool = _world()
    jr = _jax_run(strategy, p0, pool)
    tr = _torch_run(strategy, p0, pool)
    assert len(tr) == len(jr) == ROUNDS
    for j, t in zip(jr.reports, tr.reports):
        assert t.round == j.round
        assert t.aggregator == j.aggregator
        assert t.dc_points == j.dc_points
        assert (t.gamma_mean, t.m_mean) == (j.gamma_mean, j.m_mean)
        np.testing.assert_allclose(t.energy, j.energy, rtol=1e-5)
        np.testing.assert_allclose(t.delay, j.delay, rtol=1e-5)
        np.testing.assert_allclose(t.cum_energy, j.cum_energy, rtol=1e-5)
        np.testing.assert_allclose(t.loss, j.loss, rtol=1e-5)
        assert round(t.acc * N_EVAL) == round(j.acc * N_EVAL)
    for k in p0:
        np.testing.assert_allclose(tr.params[k].numpy(),
                                   np.asarray(jr.params[k]), rtol=1e-5,
                                   atol=1e-6)
    assert tr.final.loss < tr.reports[0].loss


def test_fixed_mesh_run_matches_jax():
    check_mesh_run_matches_jax("fixed:0")
