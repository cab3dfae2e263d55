"""The byzantine cell (``paper_mlp.byzantine``): the driver's ``engine``
merge, a whole run at a CPU test's size judged correct, the controls
(no defence, no adversary, half batch) judged not correct, the
reference's adversary, rate draws and trimmed mean against the program's
own on the CPU, and the ``sim.robust_aggregate_roofline`` reader's byte
count."""
from __future__ import annotations

import copy
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import run
from bench.drivers import sim_round_robust as drv
from bench.reference import robust
from bench.roofline import PEAK_HBM_BYTES
from bench.trace import TraceData

ROOT = Path(__file__).resolve().parents[2]
CELL = "paper_mlp.byzantine"
SEED = 2 ** 31 + 4099


def tiny():
    """The cell cut to a CPU test's world (the limits as committed)."""
    spec, cell, config, workload = run.load_cell(CELL)
    config, workload = copy.deepcopy(config), copy.deepcopy(workload)
    config["network"].update(num_ue=10, num_bs=2, num_dc=2)
    config["model"].update(input_shape=[8, 8, 1], hidden=[16])
    config["data"].update(pool=3000, mean_arrivals=60.0, std_arrivals=6.0,
                          eval_examples=100)
    config["consts"].update(estimate_iters=2)
    config["engine"].update(solver_outer=2)
    return spec, cell, config, workload


def test_engine_block_is_merged_over_the_configs():
    _, _, config, workload = run.load_cell(CELL)
    before = copy.deepcopy(config)
    out = drv.merged(config, workload)
    assert config == before
    assert out["engine"] == dict(before["engine"], robust_agg="trimmed_mean",
                                 trim_frac=0.2)
    assert {k: v for k, v in out.items() if k != "engine"} == \
        {k: v for k, v in before.items() if k != "engine"}


@pytest.fixture(scope="module")
def sound():
    """One set-up of the tiny cell, its run judged and its readings."""
    spec, cell, config, workload = tiny()
    res = run.measure(CELL, SEED, 0.5, False, spec=spec, cell=cell,
                      config=config, workload=workload,
                      device=torch.device("cpu"))
    r = drv.make(config, workload, SEED, torch.device("cpu"),
                 __import__("bench.trace", fromlist=["Tracer"]).Tracer(False))
    r.setup()
    return res, r, workload["limits"]


def test_sound_run(sound):
    res, _, _ = sound
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert {"setup_s", "sim_round_s", "sim_round_p90_s"} <= \
        set(res["metrics"])


@pytest.mark.parametrize("mode", ["no_defence", "no_flip", "half_batch"])
def test_controls_are_not_correct(sound, mode):
    _, r, limits = sound
    got = r.readings(mode)
    assert any(got[k] > limits[k] for k in limits), got


def test_the_adversary_is_the_presets():
    from repro_torch.scenario.adversary import resolve_ues
    for n in (4, 10, 20, 77):
        assert robust.compromised(n, 0.2) == resolve_ues(n, 0.2, None)
    assert robust.compromised(20, 0.2) == (0, 6, 13, 19)


def test_rate_draws_are_the_scenarios():
    """The byzantine scenario's rates for a round, drawn from one
    RandomState, equal the reference's replay."""
    from repro_torch.network.topology import Network, NetworkConfig
    from repro_torch.scenario import get_scenario
    from bench import inputs
    _, _, config, _ = tiny()
    net = config["network"]
    rates = inputs.network_rates(net)
    world = Network(cfg=NetworkConfig(**{k: tuple(v) if isinstance(v, list)
                                         else v for k, v in net.items()}),
                    **rates)

    class Opts:
        rate_jitter = config["engine"]["rate_jitter"]
    sc = get_scenario("byzantine")
    sc.bind(world, Opts())
    net_t, _, events = sc.step(0, [], np.random.RandomState(7))
    want = robust.jitter_rates(rates, np.random.RandomState(7),
                               Opts.rate_jitter, drv.THREAT["byzantine"]
                               ["wired_jitter"])
    for k in ("R_nb", "R_bn", "R_ss", "R_sb"):
        np.testing.assert_array_equal(getattr(net_t, k), want[k])
    assert [u for u, _, _ in events.corrupted] == \
        list(robust.compromised(net["num_ue"], 0.2))
    assert {(m, s) for _, m, s in events.corrupted} == {("sign_flip", 4.0)}


@pytest.mark.parametrize("n,trim_frac", [(25, 0.2), (7, 0.1), (6, 0.45)])
def test_trimmed_mean_is_the_programs(n, trim_frac):
    """The reference's sign flip and float64 trimmed mean against the
    program's plain ``robust_aggregate`` (``core.aggregation``) on the
    CPU, ties included."""
    from repro_torch.core.aggregation import robust_aggregate
    from repro_torch.kernels.plane import ParamPlane
    g = torch.Generator().manual_seed(n)
    x = torch.randn((4, 1024), generator=g)
    d = [torch.randn((4, 1024), generator=g) for _ in range(n)]
    d[1][0, :8] = d[2][0, :8]                       # ties
    flipped = [-4.0 * t if i in (0, 3) else t for i, t in enumerate(d)]

    def plane(t):
        return ParamPlane.from_tree({"w": t.reshape(-1)})
    got = robust_aggregate(plane(x), [plane(t) for t in flipped], theta=2.0,
                           eta=0.1, mode="trimmed_mean",
                           trim_frac=trim_frac).to_tree()["w"]
    k = robust.trim_count(n, trim_frac)
    want = x.double().reshape(-1) - 0.2 * robust.trimmed_mean(
        torch.stack([t.reshape(-1) for t in flipped]), k)
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)


def _reader(name):
    path = ROOT / "bench" / "layer_metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_robust_roofline_reader(monkeypatch):
    from repro_torch import tracing
    from repro_torch.tracing import Span as PSpan
    held = [PSpan("robust.aggregate", t0, t0 + 0.01, -1, 0,
                  {"n": 25, "R": 176, "k": 5}) for t0 in (0.1, 0.5)]
    monkeypatch.setattr(tracing, "spans", lambda: list(held))
    bound = 4 * 176 * 1024 * 27 / PEAK_HBM_BYTES
    assert abs(bound - 5.81e-6) < 0.01e-6
    recs = [("void robust_aggregate_kernel<float>", 0.1, 0.1 + 4 * bound),
            ("void robust_aggregate_kernel<float>", 0.5, 0.5 + 2 * bound),
            ("fedprox_accum_kernel", 0.2, 0.3)]
    data = TraceData([], {}, [], recs, [0], (0.0, 1.0), {}, {}, {})
    read = _reader("sim.robust_aggregate_roofline")
    assert abs(read(data) - 100 * 2 / 6) < 1e-9
    data.records = recs[1:]                 # one record dropped
    assert abs(read(data) - 100 * 1 / 2) < 1e-9
    data.records = recs[2:]
    assert read(data) is None
    held.clear()
    data.records = recs
    assert read(data) is None
