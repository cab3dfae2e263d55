"""The PyTorch port's kernel layer against the JAX package's Pallas kernels.

The port's plain versions (``repro_torch.kernels.ref``, which the CPU
dispatch of ``repro_torch.kernels.ops`` runs) are held against
``fedprox_accum_2d`` / ``nova_aggregate_2d`` / ``fedprox_update_2d`` /
``nova_aggregate_stacked_2d`` run through ``pallas_call`` in interpret
mode, and the tree-level ops against ``repro.kernels.ops`` with
``backend="cpu"``, on the same numpy inputs.  Tolerances: f32
``rtol=1e-6`` plus an absolute two ulps of the largest operand (XLA
contracts the multiply-adds into FMAs and may order the sum differently,
where torch on the CPU rounds every op; a result that cancels towards
zero then differs by an ulp of its operands, not of itself), and for
bf16 outputs one bf16 ulp of the result or that same operand-scale
bound, whichever is larger (a last-bit difference in the f32 math can
round to the neighbouring bf16 value).

The hand-written CUDA kernels cannot run here; ``chip_smoke.py`` holds
them against these plain versions on the card.  Here the tests check the
dispatch rule: a CPU tensor takes the plain version without touching the
launch counters, the CUDA wrappers refuse CPU tensors, and a
``device="cuda"`` request without a card raises.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.fedprox_update import fedprox_accum_2d, fedprox_update_2d
from repro.kernels.nova_aggregate import (nova_aggregate_2d,
                                          nova_aggregate_stacked_2d)
from repro_torch.kernels import fedprox_update as tfp
from repro_torch.kernels import nova_aggregate as tna
from repro_torch.kernels import ops, ref
from repro_torch.kernels.plane import LANE

torch.set_num_threads(2)

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (None, jnp.bfloat16, torch.bfloat16)}


def _pair(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    _, jd, td = DTYPES[dtype]
    a = rng.normal(size=shape).astype(np.float32)
    j = jnp.asarray(a).astype(jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _bf16_ulp(a):
    """One bf16 ulp at |a| (8 significant bits)."""
    _, e = np.frexp(np.abs(a))
    return np.ldexp(1.0, e - 8)


def _assert_close(got, want, dtype, *operands):
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    scale = max(float(torch.max(torch.abs(t.float()))) for t in operands)
    atol = 2 * np.spacing(np.float32(scale))
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol)
    else:
        ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        assert np.all(np.abs(got - want) <= np.maximum(ulp, atol))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("R", [8, 24, 40, 176])
@pytest.mark.parametrize("G", [1, 3, 5])
@pytest.mark.parametrize("anchor", ["shared", "per_dpu"])
def test_fedprox_accum_plain_matches_pallas(dtype, R, G, anchor):
    rng = np.random.RandomState(R * 31 + G)
    jx, tx = _pair(rng, (G, R, LANE), dtype)
    jg, tg = _pair(rng, (G, R, LANE), dtype)
    ja, ta = _pair(rng, (R, LANE) if anchor == "shared" else (G, R, LANE),
                   dtype)
    jc, tc = _pair(rng, (G, R, LANE), dtype)
    coef = rng.uniform(0.5, 1.0, G).astype(np.float32)
    active = (rng.uniform(size=G) > 0.3).astype(np.float32)
    eta, mu = 0.05, 0.01
    jxo, jco = fedprox_accum_2d(jx, jg, ja, jc, jnp.asarray(coef),
                                jnp.asarray(active), eta, mu,
                                interpret=True)
    before = dict(ops.LAUNCHES)
    txo, tco = ops.fedprox_accum_plane(tx, tg, ta, tc, coef, active, eta,
                                       mu)
    assert ops.LAUNCHES == before          # a CPU tensor counts nothing
    assert txo.dtype == tx.dtype and tco.dtype == tc.dtype
    _assert_close(txo, jxo, dtype, tx, tg, ta)
    _assert_close(tco, jco, dtype, tc, tg)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("R", [8, 24, 40, 176])
@pytest.mark.parametrize("n", [1, 3, 5])
def test_nova_aggregate_plain_matches_pallas(dtype, R, n):
    rng = np.random.RandomState(R * 17 + n)
    jx, tx = _pair(rng, (R, LANE), dtype)
    jd, td = _pair(rng, (n, R, LANE), dtype)
    w = rng.uniform(0.1, 1.0, n).astype(np.float32)
    w = w / w.sum()
    theta_eta = 0.07
    jo = nova_aggregate_2d(jx, jd, jnp.asarray(w), theta_eta,
                           interpret=True)
    before = dict(ops.LAUNCHES)
    to = ops.nova_aggregate_plane(tx, td, torch.from_numpy(w), theta_eta)
    assert ops.LAUNCHES == before
    assert to.dtype == tx.dtype
    _assert_close(to, jo, dtype, tx, td)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("R", [8, 24, 40, 176])
def test_fedprox_update_plain_matches_pallas(dtype, R):
    rng = np.random.RandomState(R * 7 + 1)
    jx, tx = _pair(rng, (R, LANE), dtype)
    jg, tg = _pair(rng, (R, LANE), dtype)
    ja, ta = _pair(rng, (R, LANE), dtype)
    eta, mu = 0.05, 0.01
    jo = fedprox_update_2d(jx, jg, ja, eta, mu, interpret=True)
    before = dict(ops.LAUNCHES)
    to = ops.fedprox_plane(tx, tg, ta, eta, mu)
    assert ops.LAUNCHES == before
    assert to.dtype == tx.dtype
    _assert_close(to, jo, dtype, tx, tg, ta)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("R", [8, 24, 40])
@pytest.mark.parametrize("n", [1, 3, 5])
def test_nova_aggregate_stacked_plain_matches_pallas(dtype, R, n):
    """The plain version on a 3-D x (rows that differ) against the
    stacked Pallas kernel: every row gets the same update."""
    rng = np.random.RandomState(R * 13 + n)
    jx, tx = _pair(rng, (n, R, LANE), dtype)
    jd, td = _pair(rng, (n, R, LANE), dtype)
    w = rng.uniform(0.1, 1.0, n).astype(np.float32)
    w = w / w.sum()
    theta_eta = 0.07
    jo = nova_aggregate_stacked_2d(jx, jd, jnp.asarray(w), theta_eta,
                                   interpret=True)
    before = dict(ops.LAUNCHES)
    to = ops.nova_aggregate_plane(tx, td, torch.from_numpy(w), theta_eta)
    assert ops.LAUNCHES == before
    assert to.shape == tx.shape and to.dtype == tx.dtype
    _assert_close(to, jo, dtype, tx, td)
    one = ops.nova_aggregate_plane(tx[n - 1], td, torch.from_numpy(w),
                                   theta_eta)
    assert torch.equal(to[n - 1], one)


def _classifier_tree(rng, dtype):
    """A tree shaped like the 8x8x1 -> 16 -> 10 classifier's params."""
    shapes = {"w0": (64, 16), "b0": (16,), "w1": (16, 10), "b1": (10,)}
    pairs = {k: _pair(rng, s, dtype) for k, s in shapes.items()}
    return ({k: j for k, (j, _) in pairs.items()},
            {k: t for k, (_, t) in pairs.items()})


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tree_ops_match_jax_cpu_ops(dtype):
    """Tree-level ``fedprox_update`` and ``nova_aggregate`` (absolute
    weights, normalized once inside) against ``repro.kernels.ops`` with
    ``backend="cpu"``, leaf by leaf, leaf dtypes kept."""
    rng = np.random.RandomState(5)
    (jp, tp), (jg, tg), (ja, ta) = (_classifier_tree(rng, dtype)
                                    for _ in range(3))
    before = dict(ops.LAUNCHES)
    jo = jops.fedprox_update(jp, jg, ja, 0.05, 0.01, backend="cpu")
    to = ops.fedprox_update(tp, tg, ta, 0.05, 0.01)
    assert set(to) == set(jo)
    for k in jo:
        assert to[k].dtype == tp[k].dtype
        _assert_close(to[k], jo[k], dtype, tp[k], tg[k], ta[k])
    ds = [_classifier_tree(rng, dtype) for _ in range(3)]
    sizes = [120.0, 300.0, 45.0]
    jn = jops.nova_aggregate(jp, [j for j, _ in ds], sizes, 0.2,
                             backend="cpu")
    tn = ops.nova_aggregate(tp, [t for _, t in ds], sizes, 0.2)
    for k in jn:
        assert tn[k].dtype == tp[k].dtype
        _assert_close(tn[k], jn[k], dtype, tp[k], *(t[k] for _, t in ds))
    assert ops.LAUNCHES == before


def test_new_wrappers_refuse_what_their_kernels_do_not_take():
    """fedprox_update and nova_aggregate_stacked check dtype, shape,
    contiguity and the weights before the device, and launch nothing."""
    x = torch.zeros((8, LANE))
    s = torch.zeros((3, 8, LANE))
    w = torch.ones(3) / 3
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tfp.fedprox_update(x.half(), x.half(), x.half(), 0.1, 0.01)
    with pytest.raises(TypeError, match="dtype"):
        tfp.fedprox_update(x, x.to(torch.bfloat16), x, 0.1, 0.01)
    with pytest.raises(ValueError, match="x must be"):
        tfp.fedprox_update(torch.zeros((12, LANE)), x, x, 0.1, 0.01)
    with pytest.raises(ValueError, match="anchor must have"):
        tfp.fedprox_update(x, x, torch.zeros((16, LANE)), 0.1, 0.01)
    with pytest.raises(ValueError, match="contiguous"):
        tfp.fedprox_update(x, torch.zeros((LANE, 8)).t(), x, 0.1, 0.01)
    with pytest.raises(ValueError, match="CUDA"):
        tfp.fedprox_update(x, x, x, 0.1, 0.01)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tna.nova_aggregate_stacked(s.half(), s.half(), w, 0.1)
    with pytest.raises(ValueError, match="x must be"):
        tna.nova_aggregate_stacked(x, s, w, 0.1)
    with pytest.raises(ValueError, match="d_stack must have"):
        tna.nova_aggregate_stacked(s, s[:2], w, 0.1)
    with pytest.raises(ValueError, match="weights must be"):
        tna.nova_aggregate_stacked(s, s, w[:2], 0.1)
    with pytest.raises(TypeError, match="dtype"):
        tna.nova_aggregate_stacked(s, s, w.double(), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        tna.nova_aggregate_stacked(
            s, torch.zeros((8, 3, LANE)).transpose(0, 1), w, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        tna.nova_aggregate_stacked(s, s, w, 0.1)
    assert ops.LAUNCHES["fedprox_update"] == 0
    assert ops.LAUNCHES["nova_aggregate_stacked"] == 0


def test_plain_versions_are_what_cpu_dispatch_runs():
    rng = np.random.RandomState(0)
    x, g, a, c = (torch.from_numpy(rng.normal(size=(2, 8, LANE))
                                   .astype(np.float32)) for _ in range(4))
    coef = torch.tensor([0.9, 1.0])
    act = torch.tensor([1.0, 0.0])
    out = ops.fedprox_accum_plane(x, g, a, c, coef, act, 0.1, 0.01)
    want = ref.fedprox_accum_ref(x, g, a, c, coef, act, 0.1, 0.01)
    assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
    # an inactive DPU is left as it was
    assert torch.equal(out[0][1], x[1]) and torch.equal(out[1][1], c[1])


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros((2, 8, LANE))
    w = torch.ones(2) / 2
    with pytest.raises(ValueError, match="CUDA"):
        tfp.fedprox_accum(x, x, x[0], x, w, w, 0.1, 0.01)
    with pytest.raises(ValueError, match="CUDA"):
        tna.nova_aggregate(x[0], x, w, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        tfp.fedprox_update(x[0], x[0], x[0], 0.1, 0.01)
    with pytest.raises(ValueError, match="CUDA"):
        tna.nova_aggregate_stacked(x, x, w, 0.1)
    assert ops.LAUNCHES == {"fedprox_accum": 0, "nova_aggregate": 0,
                            "robust_aggregate": 0,
                            "nova_aggregate_stacked": 0,
                            "fedprox_update": 0,
                            "swa_decode_attention": 0}


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the request is valid here")
    from repro_torch.device import require_device
    from repro_torch.kernels.plane import ParamPlane
    from repro_torch.models.classifier import params_from_numpy
    with pytest.raises(RuntimeError, match="cuda"):
        require_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        ParamPlane.from_numpy({"w": np.zeros(3, np.float32)})
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_numpy({"w": np.zeros(3, np.float32)})
    assert require_device("cpu") == torch.device("cpu")


def test_normalize_weights_once():
    w = ops.normalize_weights([100, 300])
    assert w.dtype == torch.float32
    np.testing.assert_allclose(w.numpy(), [0.25, 0.75])
