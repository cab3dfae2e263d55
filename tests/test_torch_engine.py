"""The PyTorch port's engine against the JAX package's, end to end at the
quickstart size (6 UEs / 3 BSs / 2 DCs, 14x14x1 -> 64 -> 10), from the
JAX package's initial params, on the CPU.

Plans, the aggregator, the offloading split and the delay/energy model
run on the same numpy streams in both packages, so per round they agree
to f32 rounding (``rtol=1e-5``).  The mini-batch draws do not (torch
cannot reproduce ``jax.random``), so loss and accuracy are held to a
statistical tolerance instead: the mean loss over some 2,000 drawn
examples per round has a standard error near 1% of its value, and the
two runs drift apart over the rounds, so they must agree within 5%; the
accuracy on 500 eval examples has a standard error near 0.02, and two
runs must agree within 0.05.

Also here: the import boundary of the port (no JAX, no ``repro``).  The
``fednova`` run lives in ``test_torch_engine_fednova.py``, so that the two
JAX runs (mostly XLA compiles) go to two test workers.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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
from repro_torch.core import fedprox as tfp
from repro_torch.core.convergence import MLConstants as TConsts
from repro_torch.data import synthetic as tsyn
from repro_torch.models import classifier as tcls
from repro_torch.network import topology as ttopo
from repro_torch.solver.objective import ObjectiveWeights as TOW

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
N, B, S = 6, 3, 2
ROUNDS = 3


def _pool():
    return jsyn.make_image_dataset(6000, (14, 14, 1), seed=0)


def _jax_run(strategy, p0, pool):
    (trx, try_), (tex, tey) = pool
    net = jtopo.make_network(jtopo.NetworkConfig(num_ue=N, num_bs=B,
                                                 num_dc=S, seed=0))
    ues = jsyn.make_online_ues(trx, try_, num_ue=N, mean_arrivals=300.0,
                               std_arrivals=30.0, seed=0)
    ex, ey = jnp.asarray(tex[:500]), jnp.asarray(tey[:500])
    consts = JConsts(L=5.0, theta_i=np.full(N + S, 2.0),
                     sigma_i=np.full(N + S, 3.0))
    eng = jengine.Engine(net, strategy, consts=consts, ow=JOW(),
                         opts=japi.EngineOptions(rounds=ROUNDS, eta=0.1,
                                                 seed=0,
                                                 kernel_backend="cpu"))
    return eng.run(ues, init_params={k: jnp.asarray(v)
                                     for k, v in p0.items()},
                   loss_fn=jcls.classifier_loss,
                   eval_fn=lambda p: jcls.classifier_accuracy(p, ex, ey))


def _torch_run(strategy, p0, pool):
    (trx, try_), (tex, tey) = pool
    net = ttopo.make_network(ttopo.NetworkConfig(num_ue=N, num_bs=B,
                                                 num_dc=S, seed=0))
    ues = tsyn.make_online_ues(trx, try_, num_ue=N, mean_arrivals=300.0,
                               std_arrivals=30.0, seed=0)
    ex = torch.from_numpy(tex[:500])
    ey = torch.from_numpy(tey[:500])
    consts = TConsts(L=5.0, theta_i=np.full(N + S, 2.0),
                     sigma_i=np.full(N + S, 3.0))
    eng = tengine.Engine(net, strategy, consts=consts, ow=TOW(),
                         opts=tapi.EngineOptions(rounds=ROUNDS, eta=0.1,
                                                 seed=0),
                         device="cpu")
    return eng.run(ues, init_params=tcls.params_from_numpy(p0, "cpu"),
                   loss_fn=tcls.classifier_loss,
                   eval_fn=lambda p: tcls.classifier_accuracy(p, ex, ey))


def check_run_matches_jax(strategy, fused, monkeypatch):
    """Run ``strategy`` in both packages and hold the port to the JAX run;
    ``fused``: whether the port must take the fused one-group round."""
    calls = []
    groups = []
    real_round = tfp.local_round_plane
    real_train = tfp.local_train_batched

    def counting_round(*a, **kw):
        calls.append("fused")
        return real_round(*a, **kw)

    def counting_train(*a, **kw):
        groups.append(len(a[2]))
        return real_train(*a, **kw)

    monkeypatch.setattr(tfp, "local_round_plane", counting_round)
    monkeypatch.setattr(tfp, "local_train_batched", counting_train)

    cfg = JConfig(input_shape=(14, 14, 1), hidden=(64,))
    p0 = {k: np.array(v) for k, v in
          jcls.init_classifier_params(jax.random.PRNGKey(0), cfg).items()}
    pool = _pool()
    jr = _jax_run(strategy, p0, pool)
    tr = _torch_run(strategy, p0, pool)

    assert len(tr) == len(jr) == ROUNDS
    for j, t in zip(jr.reports, tr.reports):
        assert t.round == j.round
        assert t.aggregator == j.aggregator
        assert t.dc_points == j.dc_points
        np.testing.assert_allclose(t.energy, j.energy, rtol=1e-5)
        np.testing.assert_allclose(t.delay, j.delay, rtol=1e-5)
        np.testing.assert_allclose(t.cum_energy, j.cum_energy, rtol=1e-5)
        assert (t.gamma_mean, t.m_mean) == pytest.approx(
            (j.gamma_mean, j.m_mean))
        assert np.isfinite(t.loss)
        np.testing.assert_allclose(t.loss, j.loss, rtol=0.05)
        assert abs(t.acc - j.acc) <= 0.05
    # learning happened in both
    assert tr.final.loss < tr.reports[0].loss
    assert tr.final.acc > 0.2
    assert set(tr.params) == set(p0)
    if fused:
        assert calls, "the single-group round never took the fused path"
    else:
        assert not calls
        assert len(groups) >= 2 * ROUNDS   # UEs and DCs train apart


def test_greedy_data_run_matches_jax(monkeypatch):
    check_run_matches_jax("greedy_data", False, monkeypatch)


def test_engine_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the request is valid here")
    net = ttopo.make_network(ttopo.NetworkConfig(num_ue=N, num_bs=B,
                                                 num_dc=S))
    with pytest.raises(RuntimeError, match="cuda"):
        tengine.Engine(net, "greedy_data", consts=TConsts(), ow=TOW())


def test_port_imports_no_jax_and_no_reference_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 20 else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_engine_keeps_the_host_heap():
    """``keep_host_heap`` (each Engine calls it): a block larger than
    glibc's largest ``mmap`` threshold comes from the heap, and the heap
    keeps it mapped once freed, so the next round's rows reuse its pages.
    In a process of its own: the policy is process-wide."""
    code = (
        "import ctypes, json\n"
        "import numpy as np\n"
        "from repro_torch.core.engine import keep_host_heap\n"
        "class Info(ctypes.Structure):\n"
        "    _fields_ = [(n, ctypes.c_size_t) for n in (\n"
        "        'arena', 'ordblks', 'smblks', 'hblks', 'hblkhd', 'usmblks',\n"
        "        'fsmblks', 'uordblks', 'fordblks', 'keepcost')]\n"
        "libc = ctypes.CDLL(None)\n"
        "libc.mallinfo2.restype = Info\n"
        "def block():\n"
        "    a = np.ones(1 << 26, np.uint8)\n"
        "    held = libc.mallinfo2()\n"
        "    del a\n"
        "    return [held.hblkhd, libc.mallinfo2().arena]\n"
        "before = block()\n"
        "kept = keep_host_heap()\n"
        "print(json.dumps([before, kept, block()]))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    (mapped, _), kept, (mapped_after, arena_after) = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert kept
    assert mapped >= 1 << 26 > mapped_after
    assert arena_after >= 1 << 26
