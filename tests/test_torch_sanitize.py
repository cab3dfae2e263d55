"""The port's runtime sanitizer (``repro_torch.analysis.sanitize``,
``EngineOptions.sanitize``) against the JAX package's, on the CPU:
mirrors ``tests/test_analysis.py``'s ``test_check_finite``, the clean
and the divergent ``sanitize=True`` engine runs and the spec threading.

* ``check_finite`` raises on the same trees as the reference, naming the
  same leaf indices (both flatten dict keys sorted; a ParamPlane is one
  leaf), and skips integer leaves.
* A clean run under ``sanitize`` gives the same reports and params, bit
  for bit, as one without it; ``eta=1e12`` raises ``SanitizerError``
  ("non-finite") after the first round.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.sanitize import SanitizerError as JSanitizerError
from repro.analysis.sanitize import check_finite as jcheck_finite
from repro_torch import experiments as texp
from repro_torch.analysis import SanitizerError, check_finite
from repro_torch.configs.cefl_paper import ClassifierConfig
from repro_torch.core import Engine, EngineOptions, MLConstants
from repro_torch.data import make_image_dataset, make_online_ues
from repro_torch.kernels import ParamPlane
from repro_torch.models.classifier import (classifier_accuracy,
                                           classifier_loss,
                                           init_classifier_params)
from repro_torch.network import NetworkConfig, make_network
from repro_torch.solver import ObjectiveWeights

torch.set_num_threads(2)

NAN, INF = float("nan"), float("inf")
TREES = [
    {"a": np.ones(2, np.float32), "n": np.arange(3)},
    {"a": np.array([1.0, NAN], np.float32)},
    [np.array([INF], np.float32)],
    {"b": np.ones(3, np.float32), "a": {"z": np.array([NAN], np.float32),
                                         "k": np.arange(2)}},
    {"w": np.zeros((2, 2), np.float32), "x": np.array([-INF], np.float32),
     "y": [np.ones(1), np.array([NAN, 1.0])]},
]


def _torch_tree(t):
    if isinstance(t, dict):
        return {k: _torch_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_torch_tree(v) for v in t]
    return torch.from_numpy(t)


def _jax_tree(t):
    if isinstance(t, dict):
        return {k: _jax_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_jax_tree(v) for v in t]
    return jnp.asarray(t)


def _verdict(fn, err, tree):
    try:
        fn(tree, "tree")
    except err as e:
        assert "non-finite" in str(e)
        return re.search(r"leaf indices (\[[^\]]*\])", str(e)).group(1)
    return None


def test_check_finite():
    check_finite({"a": torch.ones(2), "n": torch.arange(3)}, "ok tree")
    with pytest.raises(SanitizerError, match="non-finite"):
        check_finite({"a": torch.tensor([1.0, NAN])}, "bad tree")
    with pytest.raises(SanitizerError, match="non-finite"):
        check_finite([torch.tensor([INF])], "inf tree")
    for tree in TREES:
        want = _verdict(jcheck_finite, JSanitizerError, _jax_tree(tree))
        assert _verdict(check_finite, SanitizerError, _torch_tree(tree)) \
            == want, tree
    assert issubclass(SanitizerError, AssertionError)
    plane = ParamPlane.from_tree({"w": torch.ones(5), "b": torch.zeros(2)})
    check_finite(plane, "plane")
    plane.data[0, 1] = NAN
    with pytest.raises(SanitizerError, match=r"leaf indices \[0\]"):
        check_finite(plane, "plane")


def _tiny_engine(sanitize, *, eta=0.1, rounds=2):
    net = make_network(NetworkConfig(num_ue=4, num_bs=2, num_dc=2))
    (trx, tr_y), (tex, te_y) = make_image_dataset(1200, (8, 8, 1))
    p0 = init_classifier_params(
        torch.Generator().manual_seed(0),
        ClassifierConfig(input_shape=(8, 8, 1), hidden=(16,)), device="cpu")
    consts = MLConstants(L=5.0, theta_i=np.ones(6) * 2,
                         sigma_i=np.ones(6) * 3, zeta1=2.0, zeta2=1.0)
    eng = Engine(net, "greedy_data", consts=consts, ow=ObjectiveWeights(),
                 opts=EngineOptions(rounds=rounds, eta=eta, solver_outer=2,
                                    sanitize=sanitize), device="cpu")
    ues = make_online_ues(trx, tr_y, num_ue=4, mean_arrivals=100,
                          std_arrivals=10)
    x, y = torch.from_numpy(tex[:100]), torch.from_numpy(te_y[:100])
    return eng, ues, p0, classifier_loss, \
        lambda p: classifier_accuracy(p, x, y)


def _run(eng, ues, p0, loss_fn, eval_fn):
    return eng.run(ues, init_params=p0, loss_fn=loss_fn, eval_fn=eval_fn)


def test_engine_sanitize_mode_clean_run():
    res = _run(*_tiny_engine(True))
    assert len(res) == 2 and np.isfinite(res.final.acc)
    # the check reads the params and changes nothing
    plain = _run(*_tiny_engine(False))
    for a, b in zip(res.reports, plain.reports):
        assert (a.acc, a.loss, a.energy, a.delay, a.aggregator,
                a.dc_points) == (b.acc, b.loss, b.energy, b.delay,
                                 b.aggregator, b.dc_points)
    for k in plain.params:
        assert torch.equal(res.params[k], plain.params[k]), k


def test_engine_sanitize_mode_catches_divergence():
    """An exploding step size drives params to Inf/NaN; sanitize mode
    turns the silent garbage run into a SanitizerError."""
    eng, ues, p0, loss_fn, eval_fn = _tiny_engine(True, eta=1e12)
    with pytest.raises(SanitizerError,
                       match=r"params after round \d+: non-finite"):
        eng.run(ues, init_params=p0, loss_fn=loss_fn, eval_fn=eval_fn)
    # without it the run finishes on garbage
    res = _run(*_tiny_engine(False, eta=1e12))
    assert len(res) == 2
    assert not all(torch.isfinite(v).all() for v in res.params.values())


def test_spec_threads_sanitize():
    spec = texp.get_experiment("sweep_smoke").override(
        **{"engine.sanitize": True})
    opts = spec.engine_options(0)
    assert opts.sanitize is True
    assert texp.get_experiment("sweep_smoke").engine_options(0).sanitize \
        is False
