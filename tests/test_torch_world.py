"""The PyTorch port's world model against the JAX package's: the numpy
streams (image pool, online arrivals, topology, rate jitter, offloading)
bit for bit, the heuristic plans of the five ported strategies, and the
float32 delay/energy model to ``rtol=1e-5`` (small f32 reductions summed
in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core import engine as jengine
from repro.core.convergence import MLConstants as JConsts
from repro.data import synthetic as jsyn
from repro.network import costs as jcosts
from repro.network import topology as jtopo
from repro.solver.objective import ObjectiveWeights as JOW
from repro_torch.core import api as tapi
from repro_torch.core import engine as tengine
from repro_torch.core.convergence import MLConstants as TConsts
from repro_torch.data import synthetic as tsyn
from repro_torch.network import costs as tcosts
from repro_torch.network import topology as ttopo
from repro_torch.solver.objective import ObjectiveWeights as TOW

torch.set_num_threads(2)

STRATEGIES = ["greedy_data", "greedy_rate", "fixed:1", "fednova", "fedavg"]
DIMS = [(6, 3, 2), (20, 10, 5)]


def _nets(dims, consensus=True):
    N, B, S = dims
    jn = jtopo.make_network(jtopo.NetworkConfig(num_ue=N, num_bs=B,
                                                num_dc=S, seed=3),
                            consensus=consensus)
    tn = ttopo.make_network(ttopo.NetworkConfig(num_ue=N, num_bs=B,
                                                num_dc=S, seed=3),
                            consensus=consensus)
    return jn, tn


def _d_bar(N, seed=0):
    return np.random.RandomState(seed).normal(300, 30, N).astype(int) \
        .astype(float)


def test_image_dataset_bitwise():
    j = jsyn.make_image_dataset(600, (14, 14, 1), seed=4)
    t = tsyn.make_image_dataset(600, (14, 14, 1), seed=4)
    for (jx, jy), (tx, ty) in zip(j, t):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


def test_online_streams_bitwise_over_three_rounds():
    (x, y), _ = tsyn.make_image_dataset(1500, (8, 8, 1), seed=2)
    jues = jsyn.make_online_ues(x, y, num_ue=4, mean_arrivals=120.0,
                                std_arrivals=12.0, seed=5)
    tues = tsyn.make_online_ues(x, y, num_ue=4, mean_arrivals=120.0,
                                std_arrivals=12.0, seed=5)
    for _ in range(3):
        for ju, tu in zip(jues, tues):
            jd, td = ju.step(), tu.step()
            np.testing.assert_array_equal(td["x"], np.asarray(jd["x"]))
            np.testing.assert_array_equal(td["y"], np.asarray(jd["y"]))


@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("consensus", [True, False])
def test_network_and_jitter_bitwise(dims, consensus):
    jn, tn = _nets(dims, consensus)
    for name in ("R_nb", "R_bn", "R_bs_max", "R_s_max", "R_ss", "R_sb",
                 "subnet_of_bs", "subnet_of_ue", "adjacency"):
        np.testing.assert_array_equal(getattr(tn, name), getattr(jn, name))
    jr = jn.resample_rates(np.random.RandomState(9), 0.15)
    tr = tn.resample_rates(np.random.RandomState(9), 0.15)
    for name in ("R_nb", "R_bn", "R_ss", "R_sb"):
        np.testing.assert_array_equal(getattr(tr, name), getattr(jr, name))


def _plans(strategy, dims):
    jn, tn = _nets(dims)
    N, _, S = dims
    D_bar = _d_bar(N)
    jopts = japi.EngineOptions(gamma_default=3, m_default=0.4)
    topts = tapi.EngineOptions(gamma_default=3, m_default=0.4)
    jconsts = JConsts(theta_i=np.ones(N + S), sigma_i=np.ones(N + S))
    tconsts = TConsts(theta_i=np.ones(N + S), sigma_i=np.ones(N + S))
    jplan = japi.get_strategy(strategy).decide(
        jn, jnp.asarray(D_bar, jnp.float32),
        japi.DecisionContext(round=0, consts=jconsts, ow=JOW(), opts=jopts))
    tplan = tapi.get_strategy(strategy).decide(
        tn, torch.as_tensor(D_bar, dtype=torch.float32),
        tapi.DecisionContext(round=0, consts=tconsts, ow=TOW(), opts=topts))
    return jn, tn, D_bar, jplan, tplan


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("dims", DIMS)
def test_heuristic_plans_match_jax(strategy, dims):
    jn, tn, _, jplan, tplan = _plans(strategy, dims)
    tplan.validate(tn)
    jw, tw = jplan.to_w(), tplan.to_w()
    for k in ("rho_nb", "rho_bs", "I_s", "I_nb", "I_bn", "gamma", "m"):
        assert tw[k].dtype == torch.float32
        np.testing.assert_array_equal(tw[k].numpy(), np.asarray(jw[k]),
                                      err_msg=k)
    for k in ("f_n", "z_s", "R_bs", "delta_A", "delta_R"):
        np.testing.assert_allclose(tw[k].numpy(), np.asarray(jw[k]),
                                   rtol=1e-5, err_msg=k)
    assert tplan.aggregator == jplan.aggregator


@pytest.mark.parametrize("strategy", ["greedy_data", "fednova"])
@pytest.mark.parametrize("dims", DIMS)
def test_offloading_splits_match_jax(strategy, dims):
    jn, tn, _, jplan, tplan = _plans(strategy, dims)
    N = dims[0]
    (x, y), _ = tsyn.make_image_dataset(40 * N + 200, (4, 4, 1), seed=1)
    rng = np.random.RandomState(2)
    data = []
    for n in range(N):
        idx = rng.choice(len(y), 20 + 3 * n, replace=False)
        data.append({"x": x[idx], "y": y[idx]})
    data[1] = {"x": x[:0], "y": y[:0]}          # a UE with no data
    ju, jd = jengine.realize_offloading(np.random.RandomState(7), data,
                                        jplan, jn)
    tu, td = tengine.realize_offloading(np.random.RandomState(7), data,
                                        tplan, tn)
    for j, t in zip(ju + jd, tu + td):
        if j is None:
            assert t is None
            continue
        np.testing.assert_array_equal(t["x"], np.asarray(j["x"]))
        np.testing.assert_array_equal(t["y"], np.asarray(j["y"]))
    total = sum(len(d["y"]) for d in tu + td if d is not None)
    assert total == sum(len(d["y"]) for d in data)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("dims", DIMS)
def test_costs_match_jax(strategy, dims):
    jn, tn, D_bar, jplan, tplan = _plans(strategy, dims)
    jn_t = jn.resample_rates(np.random.RandomState(1), 0.15)
    tn_t = tn.resample_rates(np.random.RandomState(1), 0.15)
    jc = jcosts.network_costs(jplan.to_w(), jn_t, D_bar)
    tc = tcosts.network_costs(tplan.to_w(), tn_t, D_bar)
    assert set(tc) == set(jc)
    for k in jc:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-5, err_msg=k)
    xi3 = (1.0, 0.5, 2.0, 1.0, 0.3, 1.5)
    np.testing.assert_allclose(float(tcosts.round_energy(tc, xi3)),
                               float(jcosts.round_energy(jc, xi3)),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tcosts.round_delay(tc)),
                               float(jcosts.round_delay(jc)), rtol=1e-5)


def test_cefl_is_not_ported_yet():
    """Once the test that ``cefl`` was missing; the SCA solver is ported
    now, so the registry holds every strategy of the JAX package."""
    from repro_torch.core.strategies import CEFLStrategy
    assert isinstance(tapi.get_strategy("cefl"), CEFLStrategy)
    assert tapi.available_strategies() == sorted(
        ["cefl", "fedavg", "fednova", "fixed", "greedy_data",
         "greedy_rate"]) == japi.available_strategies()
    with pytest.raises(KeyError, match="greedy_data"):
        tapi.get_strategy("nope")
    with pytest.raises(ValueError, match="fixed"):
        tapi.get_strategy("fixed")
