"""The port's ``swa_decode_attention`` against the JAX package's.

The port's plain version (``repro_torch.kernels.ref.
swa_decode_attention_ref``, which the CPU dispatch of
``repro_torch.kernels.ops`` runs) is held against ``repro``'s Pallas
kernel run in interpret mode (chunk 64, as ``tests/test_kernels.py`` runs
it) and against ``repro.kernels.ref.swa_decode_attention_ref``, on the
same numpy inputs.  Tolerances: float32 within 1e-5 absolute (the outputs
are convex combinations of N(0, 1) values, |out| < 4, where 1e-5 is about
20 f32 ulps; the three versions sum the softmax and the p.v products in
different orders); bfloat16 within one bf16 ulp of the result (the f32
results agree to that order, and a last-bit difference can round to the
neighbouring bf16 value).

The CUDA kernel cannot run here; ``chip_smoke.py`` holds it against the
plain version on the card.  Here the tests check the dispatch rule and the
wrapper's refusals.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.swa_decode_attention import swa_decode_attention as jswa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import swa_decode_attention as tswa

torch.set_num_threads(2)

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _inputs(seed, B, Hq, Hkv, D, S, dtype):
    """q, k, v as JAX arrays and as torch tensors of the same values."""
    rng = np.random.RandomState(seed)
    out = []
    for shape in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)):
        j = jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(
            JDT[dtype])
        out.append((j, torch.from_numpy(np.array(j.astype(jnp.float32)))
                    .to(TDT[dtype])))
    return out


def _bf16_ulp(a):
    _, e = np.frexp(np.abs(a))
    return np.ldexp(1.0, e - 8)


def _assert_close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        bound = _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        assert np.all(np.abs(got - want) <= bound), \
            float(np.max(np.abs(got - want) / bound))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("G", [1, 3, 12])
@pytest.mark.parametrize("D", [32, 128])
@pytest.mark.parametrize("frac", [0.4, 1.0])
def test_plain_matches_pallas_and_ref(dtype, G, D, frac):
    B, Hkv, S = 2, 2, 128
    cache_len = max(1, int(S * frac))
    (jq, tq), (jk, tk), (jv, tv) = _inputs(G * D, B, G * Hkv, Hkv, D, S,
                                           dtype)
    got = ref.swa_decode_attention_ref(tq, tk, tv, cache_len)
    assert got.dtype == TDT[dtype] and got.shape == (B, G * Hkv, D)
    pallas = jswa(jq, jk, jv, cache_len, chunk=64, interpret=True)
    _assert_close(got, pallas, dtype)
    _assert_close(got, jref.swa_decode_attention_ref(jq, jk, jv, cache_len),
                  dtype)


@pytest.mark.parametrize("S,cache_len", [(100, 37), (100, 100), (1, 1)])
def test_plain_any_cache_length(S, cache_len):
    """The port's plain version (like its kernel) takes any S, where the
    Pallas kernel needs S % chunk == 0."""
    (jq, tq), (jk, tk), (jv, tv) = _inputs(S, 3, 8, 2, 64, S, "f32")
    got = ref.swa_decode_attention_ref(tq, tk, tv, cache_len)
    _assert_close(got, jref.swa_decode_attention_ref(jq, jk, jv, cache_len),
                  "f32")


def test_ops_cpu_runs_plain_version_without_counting():
    (_, tq), (_, tk), (_, tv) = _inputs(0, 2, 6, 2, 32, 64, "f32")
    ops.reset_launches()
    got = ops.swa_decode_attention(tq, tk, tv, 40)
    torch.testing.assert_close(
        got, ref.swa_decode_attention_ref(tq, tk, tv, 40), rtol=0, atol=0)
    assert ops.LAUNCHES["swa_decode_attention"] == 0
    assert all(n == 0 for n in ops.LAUNCHES.values())


def _case(what):
    """CPU inputs that the CUDA wrapper must refuse, with the message."""
    (_, q), (_, k), (_, v) = _inputs(1, 2, 4, 2, 32, 64, "f32")
    cache_len = 10
    if what == "cpu":
        return (q, k, v, cache_len), "CUDA tensors"
    if what == "dtype":
        return (q.half(), k.half(), v.half(), cache_len), "float32 or bfloat16"
    if what == "mixed_dtype":
        return (q, k.bfloat16(), v, cache_len), "k_cache is torch.bfloat16"
    if what == "non_contiguous":
        kt = k.transpose(1, 2).contiguous().transpose(1, 2)
        return (q, kt, v, cache_len), "contiguous"
    if what == "cache_len_0":
        return (q, k, v, 0), r"cache_len must be in \[1, 64\]"
    if what == "cache_len_past_S":
        return (q, k, v, 65), r"cache_len must be in \[1, 64\]"
    if what == "head_dim":
        return (q[..., :16].contiguous(), k[..., :16].contiguous(),
                v[..., :16].contiguous(), cache_len), "head_dim"
    raise KeyError(what)


@pytest.mark.parametrize("what", ["cpu", "dtype", "mixed_dtype",
                                  "non_contiguous", "cache_len_0",
                                  "cache_len_past_S", "head_dim"])
def test_wrapper_refuses(what):
    args, msg = _case(what)
    ops.reset_launches()
    with pytest.raises((TypeError, ValueError), match=msg):
        tswa.swa_decode_attention(*args)
    assert ops.LAUNCHES["swa_decode_attention"] == 0


@pytest.mark.parametrize("cells,cache_len", [(32, 4096), (32, 513), (8, 4096),
                                             (4, 32768), (32, 1), (1, 100)])
def test_split_rows_cover_the_valid_rows(cells, cache_len):
    """Every split holds at least one valid row and the splits cover
    [0, cache_len) exactly, in whole tiles but the last."""
    rows, n = tswa.split_rows(cells, cache_len, 132)
    assert rows % tswa.TILE == 0 and rows >= tswa.MIN_SPLIT_ROWS
    assert (n - 1) * rows < cache_len <= n * rows
