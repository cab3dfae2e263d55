"""The PyTorch port's engine under the threat scenarios against the JAX
package's, end to end on the CPU, at the size of the JAX package's own
adversary tests (6 UEs / 3 BSs / 2 DCs, 8x8x1 -> 16 -> 10).

Plans, the aggregator, the offloading split and the delay/energy model
run on the same numpy streams in both packages (scenario ticks included),
so per round they agree to f32 rounding (``rtol=1e-5``).  The mini-batch
draws do not (torch cannot reproduce ``jax.random``), so loss and accuracy
are held to a statistical tolerance: the mean loss over some 800 drawn
examples per round has a standard error near 2% of its value, so the two
runs must agree within 5%; the accuracy on 400 eval examples has a
standard error near 0.025, and two runs must agree within 0.05.

The robustness check follows the JAX package's acceptance test
(``tests/test_adversary.py``) under ``greedy_data``, since ``cefl`` is not
ported: a clean twin (``byzantine:0.0``, the same rng draws), the
unprotected ``byzantine`` run and ``byzantine`` with the trimmed mean.
The port must keep the ordering the JAX runs show, with thresholds taken
from those JAX runs in the same test.
"""
import jax
import numpy as np
import torch

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
from repro_torch.kernels import ops
from repro_torch.models import classifier as tcls
from repro_torch.network import topology as ttopo
from repro_torch.solver.objective import ObjectiveWeights as TOW

torch.set_num_threads(2)

N, B, S = 6, 3, 2
(TRX, TRY), (TEX, TEY) = jsyn.make_image_dataset(2500, (8, 8, 1), seed=0)
P0 = {k: np.array(v) for k, v in jcls.init_classifier_params(
    jax.random.PRNGKey(0),
    JConfig(input_shape=(8, 8, 1), hidden=(16,))).items()}


def _consts(mod):
    return mod(L=5.0, theta_i=np.full(N + S, 2.0),
               sigma_i=np.full(N + S, 3.0))


def jax_run(strategy, scenario, *, robust="none", rounds, arrivals=150.0):
    net = jtopo.make_network(jtopo.NetworkConfig(num_ue=N, num_bs=B,
                                                 num_dc=S))
    ues = jsyn.make_online_ues(TRX, TRY, num_ue=N, mean_arrivals=arrivals,
                               std_arrivals=arrivals / 10, seed=0)
    eng = jengine.Engine(
        net, strategy, consts=_consts(JConsts), ow=JOW(), scenario=scenario,
        opts=japi.EngineOptions(rounds=rounds, eta=0.1, seed=0,
                                robust_agg=robust, trim_frac=0.2,
                                kernel_backend="cpu"))
    ex, ey = np.asarray(TEX[:400]), np.asarray(TEY[:400])
    return eng.run(ues, init_params=P0, loss_fn=jcls.classifier_loss,
                   eval_fn=lambda p: jcls.classifier_accuracy(p, ex, ey))


def torch_run(strategy, scenario, *, robust="none", rounds,
              arrivals=150.0):
    net = ttopo.make_network(ttopo.NetworkConfig(num_ue=N, num_bs=B,
                                                 num_dc=S))
    ues = tsyn.make_online_ues(TRX, TRY, num_ue=N, mean_arrivals=arrivals,
                               std_arrivals=arrivals / 10, seed=0)
    eng = tengine.Engine(
        net, strategy, consts=_consts(TConsts), ow=TOW(), scenario=scenario,
        opts=tapi.EngineOptions(rounds=rounds, eta=0.1, seed=0,
                                robust_agg=robust, trim_frac=0.2),
        device="cpu")
    ex, ey = torch.from_numpy(TEX[:400]), torch.from_numpy(TEY[:400])
    return eng.run(ues, init_params=tcls.params_from_numpy(P0, "cpu"),
                   loss_fn=tcls.classifier_loss,
                   eval_fn=lambda p: tcls.classifier_accuracy(p, ex, ey))


def assert_reports_match(jr, tr):
    assert len(tr) == len(jr)
    for j, t in zip(jr.reports, tr.reports):
        assert t.round == j.round
        assert t.aggregator == j.aggregator
        assert t.dc_points == j.dc_points
        assert t.active_ues == j.active_ues
        assert t.handovers == j.handovers
        for key in ("rho_nb", "rho_bs", "f_n", "gamma", "m", "I_s"):
            np.testing.assert_allclose(getattr(t.plan, key).numpy(),
                                       np.asarray(getattr(j.plan, key)),
                                       rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(t.energy, j.energy, rtol=1e-5)
        np.testing.assert_allclose(t.delay, j.delay, rtol=1e-5)
        np.testing.assert_allclose(t.cum_delay, j.cum_delay, rtol=1e-5)
        assert np.isfinite(t.loss)
        np.testing.assert_allclose(t.loss, j.loss, rtol=0.05)
        assert abs(t.acc - j.acc) <= 0.05


def test_byzantine_trimmed_mean_run_matches_jax_and_keeps_its_ordering(
        monkeypatch):
    rounds = 8
    calls = []
    real = ops.robust_aggregate_plane

    def counting(*a, **kw):
        calls.append((a[1].shape[0], kw["mode"]))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "robust_aggregate_plane", counting)
    jax_acc, torch_acc = {}, {}
    for name, scenario, robust in (("clean", "byzantine:0.0", "none"),
                                   ("naked", "byzantine", "none"),
                                   ("robust", "byzantine", "trimmed_mean")):
        jr = jax_run("greedy_data", scenario, robust=robust, rounds=rounds)
        calls.clear()
        tr = torch_run("greedy_data", scenario, robust=robust,
                       rounds=rounds)
        if robust == "none":
            assert not calls
        else:
            # one robust reduce per round over every live DPU
            assert len(calls) == rounds
            assert all(mode == "trimmed_mean" for _, mode in calls)
            assert_reports_match(jr, tr)
        jax_acc[name], torch_acc[name] = jr.final.acc, tr.final.acc

    # what the JAX runs show (the premise of the thresholds below)
    assert jax_acc["clean"] >= jax_acc["robust"] > jax_acc["naked"]
    # the port keeps the ordering: the counter retains at least the JAX
    # run's share of clean accuracy (less one eval standard error), and
    # the attack costs the unprotected run at least half the JAX gap
    keep = jax_acc["robust"] / jax_acc["clean"] - 0.05
    gap = (jax_acc["robust"] - jax_acc["naked"]) / 2
    assert torch_acc["robust"] >= keep * torch_acc["clean"], \
        (torch_acc, jax_acc)
    assert torch_acc["naked"] < torch_acc["robust"] - gap, \
        (torch_acc, jax_acc)
