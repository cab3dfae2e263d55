"""The PyTorch port's byzantine-robust aggregation and update corruption
against the JAX package's, on the CPU.

The port's plain versions (``repro_torch.kernels.ref.robust_*_ref``, which
the CPU dispatch of ``ops.robust_aggregate_plane`` runs) are held against
``robust_aggregate_2d`` run through ``pallas_call`` in interpret mode and
against the JAX ``ops.robust_aggregate_plane(backend="cpu")``, on the same
numpy inputs.  Tolerances, f32: the sorted values are the same in both
packages, so the median's reduce is exact; the trimmed mean sums m = n-2k
sorted values, which XLA and torch may add in another order, and the
update ``x - theta_eta * red`` may be contracted into an FMA by XLA.  So
the bound is two ulps of the largest |x| plus |theta_eta| * 2m ulps of
the largest |d|.  bf16: one bf16 ulp of the result or that bound,
whichever is larger (a last-bit difference in the f32 math can round to
the neighbouring bf16 value).  NaN and +-inf must sit at the same places
in both.

The CUDA kernel cannot run here; ``chip_smoke.py`` holds it against the
plain version on the card.  Here the tests check its wrapper's rules:
what it refuses before any launch, and that a CPU tensor never counts a
launch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import engine as jengine
from repro.core.fedprox import LocalResult as JResult
from repro.kernels import ops as jops
from repro.kernels.plane import as_plane as j_as_plane
from repro.kernels.robust_aggregate import robust_aggregate_2d
from repro_torch.core import aggregation as tagg
from repro_torch.core import engine as tengine
from repro_torch.core.fedprox import LocalResult as TResult
from repro_torch.kernels import ops, ref
from repro_torch.kernels import robust_aggregate as tra
from repro_torch.kernels.plane import LANE
from repro_torch.kernels.plane import as_plane as t_as_plane

torch.set_num_threads(2)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(a).astype(jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _bf16_ulp(a):
    _, e = np.frexp(np.abs(a))
    return np.ldexp(1.0, e - 8)


def _assert_close(got, want, dtype, x, d, theta_eta, m):
    """``m``: how many sorted values the reduce averages."""
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[np.isinf(want)], want[np.isinf(want)])
    xf = x.float().abs()
    df = d.float().abs()
    xmax = float(xf[torch.isfinite(xf)].max()) if xf.numel() else 0.0
    dfin = df[torch.isfinite(df)]
    dmax = float(dfin.max()) if dfin.numel() else 0.0
    atol = 2 * np.spacing(np.float32(xmax)) \
        + abs(theta_eta) * 2 * m * np.spacing(np.float32(dmax))
    err = np.abs(got[finite] - want[finite])
    if dtype == "f32":
        assert np.all(err <= atol), (float(err.max()), atol)
    else:
        ulp = _bf16_ulp(np.maximum(np.abs(got[finite]),
                                   np.abs(want[finite])))
        assert np.all(err <= np.maximum(ulp, atol))


def _modes(n):
    """(mode, k, how many sorted values the reduce averages): the median,
    and the trimmed mean at k = 0, trim_count(n, 0.2) and (n-1)//2."""
    out = [("median", 0, 1 if n % 2 else 2)]
    for k in sorted({0, ops.trim_count(n, 0.2), (n - 1) // 2}):
        out.append(("trimmed_mean", k, n - 2 * k))
    return out


CASES = [(n, R, mode, k, m) for n, R in [(1, 8), (2, 24), (3, 40), (5, 8),
                                         (6, 24), (25, 40), (65, 8),
                                         (100, 8), (257, 8)]
         for mode, k, m in _modes(n)]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,R,mode,k,m", CASES)
def test_robust_plain_matches_pallas_and_jax_cpu(n, R, mode, k, m, dtype):
    rng = np.random.RandomState(n * 101 + R + k)
    jx, tx = _pair(rng.normal(size=(R, LANE)).astype(np.float32), dtype)
    jd, td = _pair(rng.normal(size=(n, R, LANE)).astype(np.float32), dtype)
    theta_eta = 0.07
    median = mode == "median"
    jk = robust_aggregate_2d(jx, jd, theta_eta, k=k, median=median,
                             interpret=True)
    before = dict(ops.LAUNCHES)
    got = ref.robust_aggregate_ref(tx, td, theta_eta, k=k, median=median)
    assert got.dtype == tx.dtype
    _assert_close(got, jk, dtype, tx, td, theta_eta, m)
    if k == ops.trim_count(n, 0.2) or median:
        # the dispatch resolves k from trim_frac as the JAX ops does
        jc = jops.robust_aggregate_plane(jx, jd, theta_eta, mode=mode,
                                         trim_frac=0.2, backend="cpu")
        tc = ops.robust_aggregate_plane(tx, td, theta_eta, mode=mode,
                                        trim_frac=0.2)
        assert torch.equal(tc, got)
        _assert_close(tc, jc, dtype, tx, td, theta_eta, m)
    assert ops.LAUNCHES == before          # a CPU tensor counts nothing


@pytest.mark.parametrize("mode,k", [("median", 0), ("trimmed_mean", 1),
                                    ("trimmed_mean", 0)])
@pytest.mark.parametrize("n", [4, 5])
def test_nan_sorts_last_and_infs_order_as_in_jax(n, mode, k):
    """One DPU diverged to NaN, others sent +-inf: NaN sorts above +inf
    in both packages, so a median over mostly finite values stays finite
    and a trimmed mean that keeps the NaN row becomes NaN."""
    rng = np.random.RandomState(n)
    d = rng.normal(size=(n, 8, LANE)).astype(np.float32)
    d[0, :, :256] = np.nan
    d[1, :, 128:384] = np.inf
    d[2, :, 300:500] = -np.inf
    x = rng.normal(size=(8, LANE)).astype(np.float32)
    median = mode == "median"
    want = np.asarray(jops.robust_aggregate_plane(
        jnp.asarray(x), jnp.asarray(d), 0.1, mode=mode, trim_frac=0.25,
        backend="cpu"))
    td = torch.from_numpy(d)
    got = ops.robust_aggregate_plane(torch.from_numpy(x), td, 0.1,
                                     mode=mode, trim_frac=0.25)
    _assert_close(got, want, "f32", torch.from_numpy(x), td, 0.1,
                  n - 2 * ops.trim_count(n, 0.25))
    # NaN is the largest value, in the order torch.sort gives
    col = torch.sort(td[:, 0, 200], dim=0).values
    assert torch.isnan(col[-1]) and torch.isinf(col[-2])
    srt = ref.robust_reduce_ref(td, k=k, median=median)
    if median or k >= 1:
        # one NaN per coordinate is out-voted (median) or trimmed off
        assert torch.isfinite(srt[0, :128]).all()
    else:
        assert torch.isnan(srt[0, :128]).all()


def test_tie_heavy_stacks_and_zero_planes():
    """Sign-flipped copies, exact duplicates and all-zero planes."""
    rng = np.random.RandomState(7)
    base = rng.normal(size=(8, LANE)).astype(np.float32)
    d = np.stack([base, base, -4 * base, base, np.zeros_like(base),
                  np.zeros_like(base), -4 * base])
    x = np.zeros((8, LANE), np.float32)
    for mode in ("median", "trimmed_mean"):
        want = np.asarray(jops.robust_aggregate_plane(
            jnp.asarray(x), jnp.asarray(d), -1.0, mode=mode, trim_frac=0.3,
            backend="cpu"))
        got = ops.robust_aggregate_plane(torch.from_numpy(x),
                                         torch.from_numpy(d), -1.0,
                                         mode=mode, trim_frac=0.3)
        _assert_close(got, want, "f32", torch.from_numpy(x),
                      torch.from_numpy(d), 1.0, 7)
    med = ops.robust_aggregate_plane(torch.from_numpy(x),
                                     torch.from_numpy(d), -1.0,
                                     mode="median")
    # the sorted middle of {b, b, b, 0, 0, -4b, -4b} per coordinate is 0
    assert torch.equal(med, torch.zeros_like(med))


@pytest.mark.parametrize("n", list(range(1, 34)) + [64, 65])
@pytest.mark.parametrize("frac", [0.0, 0.1, 0.2, 0.25, 0.49])
def test_trim_count_equals_jax(n, frac):
    assert ops.trim_count(n, frac) == jops.trim_count(n, frac)
    k = ops.trim_count(n, frac)
    lo, hi = tra.sorted_range(n, k, False)
    assert (lo, hi) == (k, n - k) and hi > lo


def test_trim_count_rejects_what_jax_rejects():
    for frac in (-0.1, 0.5, 0.7):
        with pytest.raises(ValueError):
            jops.trim_count(5, frac)
        with pytest.raises(ValueError, match="trim_frac"):
            ops.trim_count(5, frac)
    with pytest.raises(ValueError, match="unknown robust mode"):
        ops.robust_aggregate_plane(torch.zeros(8, LANE),
                                   torch.zeros(3, 8, LANE), 0.1,
                                   mode="mean")


def _planes(rng, n, R=24):
    """n (R*LANE,) trees as planes of both packages, plus the anchor."""
    trees = [{"w": rng.normal(size=(R * LANE,)).astype(np.float32)}
             for _ in range(n + 1)]
    jp = [j_as_plane({"w": jnp.asarray(t["w"])}) for t in trees]
    tp = [t_as_plane({"w": torch.from_numpy(t["w"])}) for t in trees]
    return jp[0], jp[1:], tp[0], tp[1:]


@pytest.mark.parametrize("mode,frac", [("median", 0.1),
                                       ("trimmed_mean", 0.2),
                                       ("trimmed_mean", 0.0)])
@pytest.mark.parametrize("n", [3, 6])
def test_robust_aggregation_entry_points_equal_jax(n, mode, frac):
    rng = np.random.RandomState(n)
    jx, jd, tx, td = _planes(rng, n)
    k = ops.robust_kwargs(n, mode, frac)["k"]
    m = (1 if n % 2 else 2) if mode == "median" else n - 2 * k
    want = jagg.robust_aggregate(jx, jd, theta=2.0, eta=0.05, mode=mode,
                                 trim_frac=frac)
    got = tagg.robust_aggregate(tx, td, theta=2.0, eta=0.05, mode=mode,
                                trim_frac=frac)
    assert got.data.shape == tx.data.shape
    _assert_close(got.data, want.data, "f32", tx.data,
                  torch.stack([p.data for p in td]), 0.1, m)
    # robust FedAvg: x = 0, theta_eta = -1 gives the reduce itself
    want = jagg.robust_fedavg_aggregate(jd, mode=mode, trim_frac=frac)
    got = tagg.robust_fedavg_aggregate(td, mode=mode, trim_frac=frac)
    stack = torch.stack([p.data for p in td])
    _assert_close(got.data, want.data, "f32", torch.zeros(1), stack, 1.0,
                  m)
    red = ref.robust_reduce_ref(stack, **ops.robust_kwargs(n, mode, frac))
    assert torch.equal(got.data, red)


def test_corrupt_local_results_equals_jax_with_injected_noise():
    """sign_flip and gauss targets, a target that is not live, and the
    Gaussian draws of the JAX key chain handed to the port in the order
    the port asks for them (d_i then params, per target, sorted)."""
    rng = np.random.RandomState(11)
    n = 5
    jx, jd, tx, td = _planes(rng, n)
    _, jp, _, tp = _planes(rng, n)
    live = [(0, None), (1, None), (2, None), (4, None), (6, None)]
    corrupt = ((4, "gauss", 0.5), (0, "sign_flip", 4.0),
               (3, "sign_flip", 2.0), (1, "gauss", 1.5))
    jres = [JResult(params=jp[j], d_i=jd[j], num_examples=10, gamma=2,
                    sgd_flops=0.0) for j in range(n)]
    tres = [TResult(params=tp[j], d_i=td[j], num_examples=10, gamma=2,
                    sgd_flops=0.0) for j in range(n)]
    key = jax.random.PRNGKey(5)
    jengine.corrupt_local_results(jres, live, corrupt, jx, key)
    # the same draws: JAX splits 2 keys per live gauss target (UEs 1, 4)
    keys = jax.random.split(key, 4)
    draws = iter([np.array(jax.random.normal(kk, (24, LANE), jnp.float32))
                  for kk in keys])
    calls = []

    def noise(like):
        calls.append(tuple(like.shape))
        return torch.from_numpy(next(draws))

    tengine.corrupt_local_results(tres, live, corrupt, tx, noise)
    assert calls == [(24, LANE)] * 4
    for j, (a, b) in enumerate(zip(tres, jres)):
        for field in ("d_i", "params"):
            got = getattr(a, field).data.numpy()
            want = np.asarray(getattr(b, field).data)
            # one multiply and one add per element in both packages
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=f"result {j} {field}")
    # untouched results are the very same planes
    assert tres[2].d_i is td[2] and tres[2].params is tp[2]
    assert not np.array_equal(tres[0].d_i.data.numpy(),
                              td[0].data.numpy())


def test_clean_round_draws_no_noise():
    rng = np.random.RandomState(0)
    _, _, tx, td = _planes(rng, 2)
    res = [TResult(params=td[j], d_i=td[j], num_examples=1, gamma=1,
                   sgd_flops=0.0) for j in range(2)]

    def noise(like):
        raise AssertionError("no gauss target is live")

    # a gauss target that is not live draws nothing
    tengine.corrupt_local_results(res, [(0, None), (1, None)],
                                  ((3, "gauss", 1.0),), tx, noise)
    tengine.corrupt_local_results(res, [(0, None), (1, None)], (), tx,
                                  noise)


# ------------------------------------------------------- device rules --

def test_robust_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((8, LANE))
    d = torch.zeros((3, 8, LANE))
    with pytest.raises(ValueError, match="CUDA"):
        tra.robust_aggregate(x, d, 0.1, k=1)
    with pytest.raises(ValueError, match="contiguous"):
        tra.robust_aggregate(x, torch.zeros((8, 3, LANE)).transpose(0, 1),
                             0.1)
    with pytest.raises(ValueError, match="d_stack must be"):
        tra.robust_aggregate(x, torch.zeros((3, 16, LANE)), 0.1)
    with pytest.raises(ValueError, match="x must be"):
        tra.robust_aggregate(torch.zeros((12, LANE)), d, 0.1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tra.robust_aggregate(x.half(), d.half(), 0.1)
    with pytest.raises(TypeError, match="dtype"):
        tra.robust_aggregate(x, d.to(torch.bfloat16), 0.1)
    # above the register network's 64 DPUs the kernel selects instead: a
    # stack of 65 passes every check and reaches the device rule
    with pytest.raises(ValueError, match="CUDA"):
        tra.robust_aggregate(x, torch.zeros((65, 8, LANE)), 0.1,
                             median=True)
    with pytest.raises(ValueError, match="no DPU"):
        tra.robust_aggregate(x, torch.zeros((0, 8, LANE)), 0.1)
    with pytest.raises(ValueError, match="needs 0 <= 2k < n"):
        tra.robust_aggregate(x, d, 0.1, k=2)
    assert ops.LAUNCHES["robust_aggregate"] == 0
    assert max(tra.NMAX) == 64


def test_threat_engine_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the request is valid here")
    from repro_torch.core.convergence import MLConstants
    from repro_torch.network import topology
    from repro_torch.solver.objective import ObjectiveWeights
    net = topology.make_network(topology.NetworkConfig(num_ue=6, num_bs=3,
                                                       num_dc=2))
    with pytest.raises(RuntimeError, match="cuda"):
        tengine.Engine(net, "greedy_data", consts=MLConstants(),
                       ow=ObjectiveWeights(), scenario="byzantine")
    eng = tengine.Engine(net, "greedy_data", consts=MLConstants(),
                         ow=ObjectiveWeights(), scenario="byzantine",
                         device="cpu")
    assert dataclasses.is_dataclass(eng.scenario)


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("nmax,n", [(8, 8), (8, 5), (16, 16), (16, 11)])
def test_sorting_network_sorts_by_the_zero_one_principle(nmax, n):
    """``chip_smoke.network_pairs`` lists the compare-exchanges of the
    kernel's network (``csrc/robust_sort.cuh``) and counts the operations
    of its bound.  A network sorts every input iff it sorts every 0/1
    input; with the slots n..nmax-1 padded by the largest value, the
    exchanges that touch a padding slot never move anything."""
    cs = _chip_smoke()
    pairs = [(i, j) for i, j in cs.network_pairs(nmax) if j < n]
    bits = (np.arange(2 ** n)[:, None] >> np.arange(n)) & 1
    v = bits.copy()
    for i, j in pairs:
        lo, hi = np.minimum(v[:, i], v[:, j]), np.maximum(v[:, i], v[:, j])
        v[:, i], v[:, j] = lo, hi
    np.testing.assert_array_equal(v, np.sort(bits, axis=1))
    assert [len(cs.network_pairs(m)) for m in (8, 16, 32, 64)] == \
        [19, 63, 191, 543]
    assert cs.robust_operations(25, 15, 176) == 176 * 1024 * (2 * 140 + 17)


# ------------------------------------------- the network's zero signs --

def _signed_zero_stack(n, C, seed):
    """Four DPUs in five send -0 or +0 (a coin per element), the fifth a
    value of either sign, as ``chip_smoke.py``'s signed_zeros stacks."""
    rng = np.random.RandomState(seed)
    v = rng.choice(np.array([-0.0, 0.0], np.float32), size=(n, C))
    vals = rng.choice(np.array([-1.5, 2.0], np.float32), size=(n, C))
    keep = (np.arange(n) % 5 == 0)[:, None]
    return np.where(keep, vals, v).astype(np.float32)


def _network_model(v, lo, hi, from_zero, repaired):
    """The register network of ``csrc/robust_sort.cuh`` on an (n, C) f32
    stack: NaN and the pad slots n..NMAX-1 as +inf, then the
    compare-exchanges of ``chip_smoke.network_pairs`` with fminf / fmaxf
    ordering -0 below +0 (as IEEE minimum does), then the sum of sorted
    positions [lo, hi) (from +0 when ``from_zero``, else from the first
    value) over hi - lo.  ``repaired``: where the reduce reads values
    rather than summing from +0, the zeros at sorted positions
    [c, c + zeros) (c negatives) take the signs of the stack's zeros in
    DPU order, as the kernel's reduce now reads them."""
    n, C = v.shape
    nmax = max(8, 1 << (n - 1).bit_length())
    w = np.full((nmax, C), np.inf, np.float32)
    w[:n] = np.where(np.isnan(v), np.inf, v)
    nan_count = np.isnan(v).sum(axis=0)
    for i, j in _chip_smoke().network_pairs(nmax):
        a, b = w[i].copy(), w[j].copy()
        a_first = (a < b) | ((a == b) & np.signbit(a))
        w[i], w[j] = np.where(a_first, a, b), np.where(a_first, b, a)
    w[np.arange(nmax)[:, None] >= n - nan_count] = np.nan
    if repaired and not from_zero:
        neg = (v < 0).sum(axis=0)
        for col in range(C):
            zeros = v[:, col][v[:, col] == 0]
            w[neg[col]:neg[col] + len(zeros), col] = zeros
    s = np.zeros(C, np.float32) if from_zero else w[lo].copy()
    with np.errstate(invalid="ignore"):       # inf - inf, as on the card
        for i in range(lo if from_zero else lo + 1, hi):
            s = s + w[i]
        return (s / np.float32(hi - lo)).astype(np.float32)


def _stable_reduce(v, k, median):
    return ref.robust_reduce_ref(torch.from_numpy(v), k=k,
                                 median=median).numpy()


@pytest.mark.parametrize("n", [5, 25, 64])
def test_fmin_fmax_network_loses_the_stable_orders_zero_sign(n):
    """The fault the kernel had: Batcher's network is not stable, and
    with fminf / fmaxf the zero that lands at the median's position is
    not the one the stable sort (the reference's ``jnp.sort``, the plain
    version's ``torch.sort(stable=True)``) puts there.  On a signed_zeros
    stack the values agree and some zero medians differ in sign."""
    v = _signed_zero_stack(n, 4096, seed=n)
    lo, hi = tra.sorted_range(n, 0, True)
    got = _network_model(v, lo, hi, from_zero=False, repaired=False)
    want = _stable_reduce(v, 0, True)
    np.testing.assert_array_equal(got, want)        # equal as numbers
    zero = want == 0
    assert zero.sum() > 1000
    assert np.any(np.signbit(got[zero]) != np.signbit(want[zero]))


@pytest.mark.parametrize("kind", ["signed_zeros", "random", "nonfinite"])
@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 20, 25, 33, 64])
def test_repaired_network_reduce_keeps_the_stable_orders_zeros(n, kind):
    """The repaired reduce (the zeros at the target positions take their
    signs in DPU order; a trimmed mean of two or more values sums from
    +0, a median or a trimmed mean of one value is read) equals the plain
    version bit for bit, zero signs included, for the median and the
    trimmed means at k = 0, trim_count(n, 0.2) and (n-1)//2 (sorted in
    the same order, summed in the same order here)."""
    v = (_signed_zero_stack(n, 2048, seed=3 * n) if kind == "signed_zeros"
         else _select_stack(kind, n, 2048, seed=5 * n))
    for mode, k, m in _modes(n):
        median = mode == "median"
        lo, hi = tra.sorted_range(n, k, median)
        from_zero = not median and hi - lo >= 2
        got = _network_model(v, lo, hi, from_zero, repaired=True)
        want = _stable_reduce(v, k, median)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        fin = ~np.isnan(want)
        if median or m <= 2:
            np.testing.assert_array_equal(got[fin].view(np.uint32),
                                          want[fin].view(np.uint32))
        else:    # torch.mean may add in another order: signs of zeros
            zero = want == 0
            np.testing.assert_array_equal(np.signbit(got[zero]),
                                          np.signbit(want[zero]))
            np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("n", [1, 3, 5, 25, 64, 65])
def test_plain_reduce_zero_signs_equal_jax(n):
    """The plain version's zero signs are the reference's on signed_zeros
    stacks: the stable sort's zero for a median, +0 for a mean of two or
    more values, the value itself for a trimmed mean of one."""
    from repro.kernels.ref import robust_reduce_ref as jreduce
    v = _signed_zero_stack(n, 1024, seed=11 * n)
    for mode, k, m in _modes(n):
        median = mode == "median"
        want = np.asarray(jreduce(jnp.asarray(v), k=k, median=median))
        got = _stable_reduce(v, k, median)
        zero = want == 0
        np.testing.assert_array_equal(np.signbit(got[zero]),
                                      np.signbit(want[zero]))
        if median or m == 1:
            np.testing.assert_array_equal(got.view(np.uint32),
                                          want.view(np.uint32))
        else:    # XLA and torch add the m values in their own orders
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------- the radix select's logic --

def _order_keys(v):
    """``order_key`` of ``csrc/robust_aggregate.cu`` on an f32 array: NaN
    above +inf, -0 as 0x7fffffff (a key no value takes)."""
    b = v.astype(np.float32).view(np.uint32)
    k = np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)
    return np.where(np.isnan(v), np.uint32(0xFFFFFFFF), k).astype(np.uint32)


def _tie_zero(k):
    """The key as the kernel's comparisons read it: -0 ties +0."""
    return np.where(k == 0x7FFFFFFF, np.uint32(0x80000000), k) \
        .astype(np.uint32)


def _key_value(k):
    """``key_value``: the f32 value a key decodes to."""
    return np.where(k & 0x80000000, k & 0x7FFFFFFF, ~k).astype(np.uint32) \
        .view(np.float32)


def _select_model(v, lo, hi, low=0, tile=16, runs=32, gather=64,
                  from_zero=False):
    """The kernel's radix select (``robust_select_kernel``) on an (n, C)
    f32 stack, block by block of ``tile`` coordinates, as the kernel runs
    it: digit passes from the top with one histogram while the two
    targets (ranks lo and hi - 1) share a prefix, the early stop once both
    targets of every coordinate of the block sit in bins of at most
    ``gather`` keys (or at the last digit; no pass at all when n <=
    ``gather``); then each boundary is the key
    of its rank, in the stable order (key, DPU), among the keys whose
    decided bits equal its prefix, and the sum runs over ``runs`` runs of
    DPUs added in order, over the (key, DPU) from one boundary to the
    other, starting from +0 when ``from_zero`` (a trimmed mean of two or
    more values) and from the first value otherwise.  ``low``: the key
    bits left undecided (16 for bf16).  Returns
    the keys, the boundaries (key, DPU), their ranks within their bins
    (the boundary ties before each boundary, once the bin is one key
    value), the passes per block and the f32 reduce."""
    n, C = v.shape
    raw = _order_keys(v)
    keys = _tie_zero(raw)
    kmask = np.uint32((0xFFFFFFFF << low) & 0xFFFFFFFF)
    bkey = np.zeros((2, C), np.uint32)
    bidx = np.zeros((2, C), np.int64)
    rest = np.zeros((2, C), np.int64)
    pref = np.zeros((2, C), np.uint32)
    dmasks = np.zeros(C, np.uint32)
    passes = []
    cols_all = np.arange(C)
    for c0 in range(0, C, tile):
        cols = cols_all[c0:c0 + tile]
        kb = keys[:, cols]
        prefix = np.zeros((2, len(cols)), np.uint32)
        rank = np.array([[lo] * len(cols), [hi - 1] * len(cols)], np.int64)
        shift = 24 if n > gather else 32     # n <= gather: no digit pass
        while shift < 32:
            hmask = np.uint32(0 if shift == 24 else
                              (0xFFFFFFFF << (shift + 8)) & 0xFFFFFFFF)
            dig = ((kb >> np.uint32(shift)) & np.uint32(0xFF)).astype(int)
            parted = prefix[0] != prefix[1]
            m0 = (kb & hmask) == prefix[0]
            m1 = ~m0 & ((kb & hmask) == prefix[1])
            hist = np.zeros((2, len(cols), 256), np.int64)
            cc = np.broadcast_to(np.arange(len(cols)), kb.shape)
            np.add.at(hist[0], (cc[m0], dig[m0]), 1)
            np.add.at(hist[1], (cc[m1], dig[m1]), 1)
            size = np.zeros((2, len(cols)), np.int64)
            for t in range(2):
                h = hist[0] if t == 0 else np.where(parted[:, None],
                                                     hist[1], hist[0])
                cum = np.cumsum(h, axis=1)
                d = np.argmax(cum > rank[t][:, None], axis=1)
                at = h[np.arange(len(cols)), d]
                rank[t] -= cum[np.arange(len(cols)), d] - at
                size[t] = at
                prefix[t] |= (d.astype(np.uint32) << np.uint32(shift))
            passes.append((32 - shift) // 8)
            if (size <= gather).all() or shift == low:
                break
            shift -= 8
        if shift == 32:
            passes.append(0)
        dmask = np.uint32((0xFFFFFFFF << shift) & 0xFFFFFFFF)
        rest[:, cols] = rank
        pref[:, cols] = prefix
        dmasks[cols] = dmask
        for t in range(2):
            for i, col in enumerate(cols):
                members = np.nonzero((kb[:, i] & dmask) == prefix[t, i])[0]
                ordered = members[np.lexsort((members, kb[members, i]))]
                bidx[t, col] = ordered[rank[t, i]]
                bkey[t, col] = kb[bidx[t, col], i] & kmask
    # the sum: run r adds, in DPU order, DPUs [n r / 32, n (r + 1) / 32)
    k = keys & kmask
    j = np.arange(n)[:, None]

    def before(ka, a, kb_, b):
        return (ka < kb_) | ((ka == kb_) & (a < b))

    take = ~before(k, j, bkey[0], bidx[0]) & \
        ~before(bkey[1], bidx[1], k, j)
    total = np.zeros(C, np.float32)
    anyv = np.zeros(C, bool)
    with np.errstate(invalid="ignore", over="ignore"):
        for r in range(runs):
            s = np.zeros(C, np.float32)
            a = np.zeros(C, bool)
            for i in range(n * r // runs, n * (r + 1) // runs):
                vi = _key_value(raw[i])
                s = np.where(take[i], np.where(a | from_zero, s + vi, vi), s)
                a |= take[i]
            total = np.where(a, np.where(anyv | from_zero, total + s, s),
                             total)
            anyv |= a
        red = total / np.float32(hi - lo)
    return {"raw": raw, "keys": keys, "bkey": bkey, "bidx": bidx,
            "rest": rest, "prefix": pref, "dmask": dmasks, "passes": passes,
            "taken": take.sum(axis=0),
            "reduce": red.astype(np.float32)}


def _select_stack(kind, n, C, seed):
    rng = np.random.RandomState(seed)
    v = rng.normal(size=(n, C)).astype(np.float32)
    if kind == "every_third_equal":
        v[::3] = v[0]
    elif kind == "all_equal":
        v[:] = v[0]
    elif kind == "signed_zeros":
        v = rng.choice(np.array([-0.0, 0.0, 0.0, -1.5, 2.0], np.float32),
                       size=(n, C))
    elif kind == "nonfinite":
        v[rng.rand(n, C) < 0.05] = np.nan
        v[rng.rand(n, C) < 0.05] = np.inf
        v[rng.rand(n, C) < 0.05] = -np.inf
    return v


def _select_cases():
    out = []
    for n in (65, 100, 257, 1000, 2000):
        ks = sorted({0, ops.trim_count(n, 0.2), (n - 1) // 2})
        for mode, k in [("median", 0)] + [("trimmed_mean", k) for k in ks]:
            out.append((n, mode, k))
    return out


@pytest.mark.parametrize("kind", ["random", "every_third_equal", "all_equal",
                                  "signed_zeros", "nonfinite"])
@pytest.mark.parametrize("n,mode,k", _select_cases())
def test_radix_select_model_matches_a_stable_sort(n, mode, k, kind):
    """A numpy model of the kernel's radix select, pass by pass, against a
    stable ``np.argsort`` (NaN last; -0 and +0 equal, so they keep DPU
    order): the order keys sort as the values do and decode to them
    (-0 included), the boundaries (key,
    DPU) of ranks lo and hi - 1 and their tie counts are the sort's, and
    the model's reduce equals ``robust_reduce_ref`` bitwise for the
    median and within 2m f32 ulps of the largest |d| for the trimmed mean
    (m values summed in DPU order here, in sorted order there)."""
    median = mode == "median"
    lo, hi = tra.sorted_range(n, k, median)
    C = 48                                   # three blocks of 16
    v = _select_stack(kind, n, C, seed=n + 7 * k)
    got = _select_model(v, lo, hi, from_zero=not median and hi - lo >= 2)
    order = np.argsort(v, axis=0, kind="stable")
    cols = np.arange(C)
    keys = got["keys"]
    ks = keys[order, cols]
    assert np.all(ks[1:] >= ks[:-1])          # keys follow the values
    vs = v[order, cols]
    same = (vs[1:] == vs[:-1]) | (np.isnan(vs[1:]) & np.isnan(vs[:-1]))
    np.testing.assert_array_equal(ks[1:] == ks[:-1], same)
    for t, r in enumerate((lo, hi - 1)):
        idx = order[r]
        np.testing.assert_array_equal(got["bidx"][t], idx)
        np.testing.assert_array_equal(got["bkey"][t], keys[idx, cols])
        # the boundary ties before it in DPU order: the stable order's
        below = np.sum(keys < keys[idx, cols], axis=0)
        ties = np.sum((keys == keys[idx, cols]) &
                      (np.arange(n)[:, None] < got["bidx"][t]), axis=0)
        np.testing.assert_array_equal(ties, r - below)
        # its rank within its bin: r less the keys of the lower bins
        lower = np.sum((keys & got["dmask"]) < got["prefix"][t], axis=0)
        np.testing.assert_array_equal(got["rest"][t], r - lower)
    back = _key_value(got["raw"])             # the keys decode to the values
    fin = ~np.isnan(v)
    np.testing.assert_array_equal(back[fin].view(np.uint32),
                                  v[fin].view(np.uint32))
    assert np.all(np.isnan(back[~fin]))
    assert all(0 <= p <= 4 for p in got["passes"])
    assert all(p > 0 for p in got["passes"]) == (n > 64)
    np.testing.assert_array_equal(got["taken"], hi - lo)
    want = ref.robust_reduce_ref(torch.from_numpy(v), k=k,
                                 median=median).numpy()
    red = got["reduce"]
    np.testing.assert_array_equal(np.isnan(red), np.isnan(want))
    inf = np.isinf(want)
    np.testing.assert_array_equal(red[inf], want[inf])
    fin = np.isfinite(want)
    zero = want == 0                          # a zero keeps the plain sign
    np.testing.assert_array_equal(np.signbit(red[zero]),
                                  np.signbit(want[zero]))
    if median:
        np.testing.assert_array_equal(red[fin].view(np.uint32),
                                      want[fin].view(np.uint32))
    else:
        df = np.abs(v[np.isfinite(v)])
        dmax = np.float32(df.max()) if df.size else np.float32(0)
        atol = 2 * (hi - lo) * np.spacing(dmax)
        assert np.all(np.abs(red[fin] - want[fin]) <= atol)


def test_radix_select_model_bf16_keys_take_two_passes():
    """bf16 keys differ only in their top 16 bits: the model stops after
    two digits and finds the same boundaries as on the full keys."""
    v = torch.from_numpy(_select_stack("every_third_equal", 257, 64, 3)) \
        .to(torch.bfloat16).float().numpy()
    lo, hi = tra.sorted_range(257, 51, False)
    got = _select_model(v, lo, hi, low=16)
    full = _select_model(v, lo, hi)
    assert max(got["passes"]) <= 2
    np.testing.assert_array_equal(got["bidx"], full["bidx"])
    np.testing.assert_array_equal(got["bkey"], full["bkey"] & 0xFFFF0000)
    np.testing.assert_array_equal(got["reduce"], full["reduce"])
