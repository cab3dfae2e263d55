"""The PyTorch port's resumable state of the world against the JAX
package's, on the CPU.

* Every ``state_dict`` of the world (``OnlineDataset``, each scenario
  preset with its mobility model, drift schedules and adversaries) after
  the same rounds on the same seed equals the reference's dict: both run
  the same numpy code on the same ``RandomState`` streams.  Loaded into a
  fresh object, it continues exactly as the uninterrupted one.
* ``LoopState.state_dict`` / ``load_state_dict``: a fresh engine loaded
  from a mid-run state finishes bit for bit like the uninterrupted run;
  a state resumes only on the device type that wrote it.
* ``training.checkpoint``: structure validation as the reference's
  ``tests/test_experiments.py::test_checkpoint_validates_structure``; a
  save killed before its manifest lands leaves the previous save whole;
  a tensors file of another save is refused; ``runstate._pack`` /
  ``_unpack``.
* A reference ``LoopState.state_dict()`` (less its ``jax.random`` key,
  which has no torch counterpart) with the reference's scenario and UE
  states loads into the port, whose next round's plan and offloading
  equal the reference's (the plan's delay budgets and rates to f32
  rounding).
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import experiments as jexp
from repro.core import api as japi
from repro.data import synthetic as jsyn
from repro.experiments import runstate as jrunstate
from repro.network import topology as jtopo
from repro.scenario import base as jbase
from repro_torch import experiments as texp
from repro_torch.core import api as tapi
from repro_torch.data import synthetic as tsyn
from repro_torch.experiments import runstate as trunstate
from repro_torch.models import classifier as tcls
from repro_torch.network import topology as ttopo
from repro_torch.scenario import base as tbase
from repro_torch.training import checkpoint as tck
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint

torch.set_num_threads(2)

N, B, S = 6, 3, 2
PRESETS = ["static", "static:0.3", "campus_walk", "vehicular",
           "flash_crowd", "label_shift", "churn", "byzantine", "poisoned",
           "stragglers", "fuzzmix:3", "fuzzmix:7"]
_POOL = jsyn.make_image_dataset(1500, (8, 8, 1), seed=0)


def _assert_tree_equal(a, b, where=""):
    if isinstance(b, dict):
        assert isinstance(a, dict) and sorted(a) == sorted(b), where
        for k in b:
            _assert_tree_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(b, (np.ndarray, np.generic)) or hasattr(b, "shape"):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        assert a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def _world(topo, syn, opts):
    (x, y), _ = _POOL
    net = topo.make_network(topo.NetworkConfig(num_ue=N, num_bs=B,
                                               num_dc=S, seed=0))
    ues = syn.make_online_ues(x, y, num_ue=N, mean_arrivals=60.0,
                              std_arrivals=6.0, seed=0)
    return net, ues, opts


def _step(scenario, net, ues, rng, rounds, t0=0):
    out = []
    for t in range(t0, t0 + rounds):
        net_t, data, events = scenario.step(t, ues, rng)
        out.append((net_t.R_nb.copy(), [d["y"].copy() for d in data],
                    events))
    return out


@pytest.mark.parametrize("name", PRESETS)
def test_scenario_state_dict_equals_the_reference_and_resumes(name):
    jnet, jues, jopts = _world(jtopo, jsyn, japi.EngineOptions())
    tnet, tues, topts = _world(ttopo, tsyn, tapi.EngineOptions())
    jsc, tsc = jbase.get_scenario(name), tbase.get_scenario(name)
    jsc.bind(jnet, jopts)
    tsc.bind(tnet, topts)
    jrng, trng = np.random.RandomState(5), np.random.RandomState(5)
    _step(jsc, jnet, jues, jrng, 3)
    _step(tsc, tnet, tues, trng, 3)
    _assert_tree_equal(tsc.state_dict(), jsc.state_dict(), name)
    for i, (tu, ju) in enumerate(zip(tues, jues)):
        _assert_tree_equal(tu.state_dict(), ju.state_dict(), f"ue{i}")
    # a fresh world loaded from the state continues as the original
    saved = (tsc.state_dict(), [u.state_dict() for u in tues],
             trng.get_state())
    want = _step(tsc, tnet, tues, trng, 2, t0=3)
    _, fresh_ues, _ = _world(ttopo, tsyn, topts)
    fresh = tbase.get_scenario(name)
    fresh.bind(tnet, topts)
    fresh.load_state_dict(saved[0])
    for u, d in zip(fresh_ues, saved[1]):
        u.load_state_dict(d)
    rng = np.random.RandomState()
    rng.set_state(saved[2])
    got = _step(fresh, tnet, fresh_ues, rng, 2, t0=3)
    for (gr, gy, ge), (wr, wy, we) in zip(got, want):
        np.testing.assert_array_equal(gr, wr)
        for a, b in zip(gy, wy):
            np.testing.assert_array_equal(a, b)
        assert ge == we


def test_online_dataset_state_before_the_first_step():
    (x, y), _ = _POOL
    t = tsyn.make_online_ues(x, y, num_ue=2, seed=4)[1]
    j = jsyn.make_online_ues(x, y, num_ue=2, seed=4)[1]
    _assert_tree_equal(t.state_dict(), j.state_dict())
    d = t.state_dict()
    first = t.step()
    fresh = tsyn.make_online_ues(x, y, num_ue=2, seed=4)[1]
    fresh.step()
    fresh.step()
    fresh.load_state_dict(d)
    again = fresh.step()
    np.testing.assert_array_equal(first["x"], again["x"])
    np.testing.assert_array_equal(first["y"], again["y"])


def _smoke(**over):
    base = {"engine.rounds": 4, "seeds": (0,)}
    base.update(over)
    return base


def _loop(ctx, seed):
    eng = ctx.make_engine(seed)
    ues = ctx.make_ues(seed)
    state = eng.init_loop(ues, init_params=ctx.p0, loss_fn=ctx.loss_fn,
                          eval_fn=ctx.eval_fn)
    return eng, ues, state


def _advance(eng, state, ues, rounds):
    for _ in range(rounds):
        staged = eng.begin_round(state, ues)
        loss, acc = eng.execute_round(state, staged)
        eng.finish_round(state, staged, loss, acc)


@pytest.mark.parametrize("strategy", ["greedy_data", "fedavg"])
def test_loop_state_round_trip_resumes_bit_for_bit(strategy):
    spec = texp.get_experiment("sweep_smoke").override(
        **_smoke(strategy=strategy, scenario="byzantine:0.34"))
    ctx = texp.build_context(spec, device="cpu")
    eng, ues, state = _loop(ctx, 0)
    _advance(eng, state, ues, 2)
    loop_d = state.state_dict()
    sc_d = eng.scenario.state_dict()
    ue_d = [u.state_dict() for u in ues]
    assert loop_d["device_type"] == "cpu" and loop_d["t"] == 2
    _advance(eng, state, ues, 2)
    eng2, ues2, state2 = _loop(ctx, 0)
    state2.load_state_dict(loop_d)
    eng2.scenario.load_state_dict(sc_d)
    for u, d in zip(ues2, ue_d):
        u.load_state_dict(d)
    state2.reports = list(state.reports[:2])
    _advance(eng2, state2, ues2, 2)
    for a, b in zip(state.reports, state2.reports):
        assert (a.loss, a.acc, a.energy, a.delay, a.dc_points,
                a.aggregator) == (b.loss, b.acc, b.energy, b.delay,
                                  b.dc_points, b.aggregator)
    assert torch.equal(state.params.data, state2.params.data)
    assert torch.equal(state.generator.get_state(),
                       state2.generator.get_state())
    # a state resumes only on the device type that wrote it
    with pytest.raises(ValueError, match="'cuda'.*'cpu'"):
        state2.load_state_dict(dict(loop_d, device_type="cuda"))


def test_checkpoint_validates_structure(tmp_path):
    tree = {"a": np.arange(6.0).reshape(2, 3), "b": {"c": np.ones(4)},
            "t": torch.arange(3, dtype=torch.int32)}
    save_checkpoint(tmp_path / "ck", tree, step=3, metadata={"k": "v"})
    back, step, meta = load_checkpoint(tmp_path / "ck", tree)
    assert step == 3 and meta == {"k": "v"}
    # 0-d leaves (a plan's delay budgets) stay 0-d
    zero_d = {"s": np.array(2.5, np.float32), "u": torch.tensor(1.5)}
    save_checkpoint(tmp_path / "z", zero_d)
    got, _, _ = load_checkpoint(tmp_path / "z", zero_d)
    assert got["s"].shape == () and got["s"] == np.float32(2.5)
    assert got["u"].shape == () and float(got["u"]) == 1.5
    assert isinstance(back["t"], torch.Tensor)
    assert torch.equal(back["t"], tree["t"])
    # extra leaf -> clear error, nothing misassigned
    with pytest.raises(ValueError, match="leaf count"):
        load_checkpoint(tmp_path / "ck",
                        {"a": tree["a"], "b": {"c": tree["b"]["c"],
                                               "d": np.ones(1)},
                         "t": tree["t"]})
    # same leaf count, different structure -> treedef error
    with pytest.raises(ValueError, match="treedef"):
        load_checkpoint(tmp_path / "ck",
                        {"x": tree["a"], "y": np.ones(4), "z": tree["t"]})
    # shape mismatch -> error unless strict_shapes=False
    bad = {"a": np.zeros((3, 2)), "b": {"c": np.ones(4)}, "t": tree["t"]}
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(tmp_path / "ck", bad)
    back, _, _ = load_checkpoint(tmp_path / "ck", bad, strict_shapes=False)
    assert np.asarray(back["a"]).shape == (2, 3)   # saved shapes win
    # float64 (and other numpy) leaves come back exactly, as numpy
    assert back["a"].dtype == np.float64
    np.testing.assert_array_equal(back["a"], tree["a"])


def test_checkpoint_killed_before_its_manifest_keeps_the_last_save(
        tmp_path, monkeypatch):
    """A save that dies after its tensors file is written but before the
    manifest is renamed into place leaves the previous save loadable,
    whole; the next save that completes leaves one tensors file."""
    ck = tmp_path / "ck"
    old = {"p": np.arange(4.0), "t": torch.arange(3)}
    new = {"p": np.arange(4.0) + 10, "t": torch.arange(3) + 10}
    save_checkpoint(ck, old, step=1, metadata={"round": 1})
    real = tck.os.replace

    def killed(src, dst):
        if Path(dst).name == tck.MANIFEST:
            raise KeyboardInterrupt("killed")
        return real(src, dst)

    monkeypatch.setattr(tck.os, "replace", killed)
    with pytest.raises(KeyboardInterrupt):
        save_checkpoint(ck, new, step=2, metadata={"round": 2})
    monkeypatch.setattr(tck.os, "replace", real)
    back, step, meta = load_checkpoint(ck, old)
    assert (step, meta) == (1, {"round": 1})
    np.testing.assert_array_equal(back["p"], old["p"])
    assert torch.equal(back["t"], old["t"])
    save_checkpoint(ck, new, step=2)
    back, step, _ = load_checkpoint(ck, old)
    assert step == 2 and torch.equal(back["t"], new["t"])
    assert [f.name for f in ck.glob("tensors-*")] == \
        [tck.read_manifest(ck)["tensors"]]


def test_checkpoint_refuses_the_tensors_of_another_save(tmp_path):
    """A manifest beside a tensors file of another save of the same
    structure and shapes (a torn pair) raises instead of mixing them."""
    tree = {"p": np.arange(4.0), "t": torch.arange(3)}
    save_checkpoint(tmp_path / "a", tree, step=1)
    save_checkpoint(tmp_path / "b", {"p": tree["p"] + 1, "t": tree["t"]},
                    step=2)
    name_a = tck.read_manifest(tmp_path / "a")["tensors"]
    name_b = tck.read_manifest(tmp_path / "b")["tensors"]
    (tmp_path / "a" / name_a).write_bytes(
        (tmp_path / "b" / name_b).read_bytes())
    with pytest.raises(ValueError, match="another save"):
        load_checkpoint(tmp_path / "a", tree)


def test_run_state_pack_unpack_roundtrip():
    state = {"a": np.arange(5), "nested": {"b": 1.5, "c": "s",
                                           "d": None, "e": True,
                                           "arr": np.eye(2)},
             "lst": [np.zeros(3), 7], "t": torch.ones(2)}
    leaves = []
    skel = trunstate._pack(state, leaves)
    assert len(leaves) == 4
    assert skel == jrunstate._pack(
        {k: v for k, v in state.items() if k != "t"}, []) | {
            "t": {"__leaf__": 3}}
    back = trunstate._unpack(skel, leaves)
    assert np.array_equal(back["a"], state["a"])
    assert back["nested"]["b"] == 1.5 and back["nested"]["d"] is None
    assert back["nested"]["e"] is True
    assert np.array_equal(back["lst"][0], state["lst"][0])
    assert torch.equal(back["t"], state["t"])
    with pytest.raises(ValueError, match="reserved"):
        trunstate._pack({"__leaf__": 1}, [])


def test_reference_loop_state_loads_into_the_port():
    over = _smoke(strategy="greedy_data")
    jspec = jexp.get_experiment("sweep_smoke").override(**over)
    tspec = texp.get_experiment("sweep_smoke").override(**over)
    jctx = jexp.build_context(jspec)
    jeng, jues, jstate = _loop(jctx, 0)
    _advance(jeng, jstate, jues, 2)
    loop_d = {k: v for k, v in jstate.state_dict().items() if k != "key"}
    sc_d = jeng.scenario.state_dict()
    ue_d = [u.state_dict() for u in jues]
    p0 = {k: np.array(v) for k, v in jctx.p0.items()}
    tctx = dataclasses.replace(texp.build_context(tspec, device="cpu"),
                               p0=tcls.params_from_numpy(p0, "cpu"))
    teng, tues, tstate = _loop(tctx, 0)
    tstate.load_state_dict(dict(loop_d,
                                generator=tstate.generator.get_state(),
                                device_type="cpu"))
    teng.scenario.load_state_dict(sc_d)
    for u, d in zip(tues, ue_d):
        u.load_state_dict(d)
    np.testing.assert_array_equal(tstate.params.data.numpy(),
                                  np.asarray(jstate.params.data))
    jst = jeng.begin_round(jstate, jues)
    tst = teng.begin_round(tstate, tues)
    assert tst.t == jst.t == 2
    np.testing.assert_array_equal(tst.D_bar, jst.D_bar)
    # the decisions that split the data are equal; the delay budgets and
    # rates come out of f32 cost math that rounds differently (rtol 1e-5,
    # as tests/test_torch_engine.py holds plans)
    for k, v in tst.plan.to_w().items():
        want = np.asarray(getattr(jst.plan, k))
        if k in ("rho_nb", "rho_bs", "gamma", "m", "I_s", "I_nb", "I_bn"):
            np.testing.assert_array_equal(v.numpy(), want, err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), want, rtol=1e-5,
                                       err_msg=k)
    assert len(tst.datasets) == len(jst.datasets)
    for a, b in zip(tst.datasets, jst.datasets):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a["x"], np.asarray(b["x"]))
            np.testing.assert_array_equal(a["y"], np.asarray(b["y"]))
    assert tstate.rng.randint(2 ** 31 - 1) == jstate.rng.randint(2 ** 31 - 1)
