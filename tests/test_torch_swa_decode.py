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
plain version on the card.  Here the tests check the dispatch rule, the
wrapper's refusals and split rule, and the bf16 kernel's arithmetic,
emulated in torch (f32 sums of exact bf16 products, P in three bf16
terms, 64-row tiles of four 16-row warps, the split merge) against the
plain version and the Pallas kernel; a single bf16 cast of P fails the
same check.
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
                                             (4, 32768), (32, 1), (1, 100),
                                             (16, 777), (4, 10 ** 6)])
def test_split_rows_cover_the_valid_rows(cells, cache_len):
    """Every split holds at least one valid row and the splits cover
    [0, cache_len) exactly, in whole tiles but the last; at most
    MAX_SPLITS of them, and no more blocks than one wave of BLOCKS_PER_SM
    per SM unless every cell needs one."""
    rows, n = tswa.split_rows(cells, cache_len, 132)
    assert rows % tswa.TILE == 0 and 1 <= n <= tswa.MAX_SPLITS
    assert (n - 1) * rows < cache_len <= n * rows
    assert cells * n <= max(tswa.BLOCKS_PER_SM * 132, cells)


# ------------------------------------- the bf16 kernel's arithmetic --

TILE_ROWS, WARP_ROWS = 64, 16        # a tile of the mma kernel; a warp's


def _bf16_terms(p, terms):
    """p as a sum of ``terms`` bf16 values, each the rest of the last
    rounded to nearest (the kernel's split of P before its mma)."""
    out, rest = [], p
    for _ in range(terms):
        h = rest.to(torch.bfloat16).float()
        out.append(h)
        rest = rest - h
    return out


def _merge(parts):
    """(m, l, acc) partials merged: M = max m, w = exp(m - M)."""
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L = sum(l * torch.exp(m - M) for m, l, _ in parts)
    A = sum(a * torch.exp(m - M)[..., None] for m, _, a in parts)
    return M, L, A


def _emulate(q, k, v, cache_len, sms, terms=3):
    """The bf16 kernel's numerics in torch, f32 throughout: the wrapper's
    splits; per split 64-row tiles, per warp 16 rows with its own online
    (m, l, acc); scores from exact bf16 products summed in f32, times
    1/sqrt(D); P V with P in ``terms`` bf16 terms; the four warps merged,
    then the splits in groups of GROUP (two levels above GROUP); out =
    acc / max(L, 1e-30), rounded to bf16."""
    B, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = np.float32(1.0) / np.sqrt(np.float32(D))
    rows, n_split = tswa.split_rows(B * Hkv, cache_len, sms)
    qf = q.float().reshape(B, Hkv, G, D)
    kf, vf = k.float(), v.float()
    out = torch.empty(B, Hkv, G, D)
    for b in range(B):
        for h in range(Hkv):
            splits = []
            for sp in range(n_split):
                r0, r1 = sp * rows, min((sp + 1) * rows, cache_len)
                warps = []
                for w in range(4):
                    m = torch.full((G,), -1e30)
                    l = torch.zeros(G)
                    acc = torch.zeros(G, D)
                    for t0 in range(r0, r1, TILE_ROWS):
                        lo = t0 + w * WARP_ROWS
                        idx = torch.arange(lo, lo + WARP_ROWS)
                        valid = idx < r1
                        kt = kf[b, idx.clamp(max=kf.shape[1] - 1), h]
                        vt = torch.where(valid[:, None],
                                         vf[b, idx.clamp(max=vf.shape[1] - 1),
                                            h], 0.0)
                        s = (qf[b, h] @ kt.T) * scale
                        s = torch.where(valid[None], s, -1e30)
                        m_new = torch.maximum(m, s.amax(1))
                        corr = torch.exp(m - m_new)
                        p = torch.where(valid[None],
                                        torch.exp(s - m_new[:, None]), 0.0)
                        l = l * corr + p.sum(1)
                        acc = acc * corr[:, None]
                        for term in _bf16_terms(p, terms):
                            acc = acc + term @ vt
                        m = m_new
                    warps.append((m, l, acc))
                splits.append(_merge(warps))
            groups = [_merge(splits[i:i + tswa.GROUP])
                      for i in range(0, n_split, tswa.GROUP)]
            M, L, A = groups[0] if len(groups) == 1 else _merge(groups)
            out[b, h] = A / torch.clamp(L, min=1e-30)[:, None]
    return out.reshape(B, Hq, D).to(torch.bfloat16)


def _bf16_check(got, want_f32, v):
    """chip_smoke.py's bf16 rule: within one bf16 ulp of the f32 result
    (the larger ulp of |got| and |want|), or 8 f32 ulps of max |v|.
    Returns the largest error / bound."""
    g = got.float().numpy()
    w = np.asarray(want_f32, dtype=np.float32)
    atol = 8 * np.spacing(np.float32(float(v.float().abs().max())))
    bound = np.maximum(_bf16_ulp(np.maximum(np.abs(g), np.abs(w))), atol)
    return float(np.max(np.abs(g - w) / bound))


@pytest.mark.parametrize("cache_len,sms", [(1, 8), (77, 8), (320, 8),
                                           (1024, 40)])
def test_bf16_kernel_arithmetic_within_tolerance(cache_len, sms):
    """The emulated bf16 kernel (three-term P) against the plain f32
    version and the Pallas kernel (interpret mode) on the same inputs,
    within the bf16 tolerance chip_smoke.py holds the card to.  (1024,
    40) takes 16 splits: the two-level merge."""
    S = max(320, cache_len)
    (jq, tq), (jk, tk), (jv, tv) = _inputs(cache_len, 2, 24, 2, 64, S,
                                           "bf16")
    got = _emulate(tq, tk, tv, cache_len, sms)
    want = ref.swa_decode_attention_ref(tq.float(), tk.float(), tv.float(),
                                        cache_len)
    assert _bf16_check(got, want.numpy(), tv) <= 1.0
    pallas = jswa(jq, jk, jv, cache_len, chunk=64, interpret=True)
    _assert_close(got, pallas, "bf16")


def test_single_bf16_cast_of_p_falls_outside_the_tolerance():
    """Why P goes through the mma in three bf16 terms: one cast of P
    errs by up to 2^-9 p, which the same inputs and tolerance reject."""
    (_, tq), (_, tk), (_, tv) = _inputs(7, 2, 24, 2, 64, 320, "bf16")
    want = ref.swa_decode_attention_ref(tq.float(), tk.float(), tv.float(),
                                        300).numpy()
    assert _bf16_check(_emulate(tq, tk, tv, 300, 8, terms=3), want,
                       tv) <= 1.0
    assert _bf16_check(_emulate(tq, tk, tv, 300, 8, terms=1), want,
                       tv) > 1.0
