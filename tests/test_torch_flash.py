"""The port's flash backward (``repro_torch.models.attention``) against
``jax.grad`` through the JAX package's ``blocked_attention(flash_vjp=
True)``, on the same numpy-seeded inputs.

Tolerances, with their reasons:
- gradients: 1e-5 of each gradient's largest entry (f32; the tiles'
  products are summed in XLA's and torch's CPU orders; measured about
  5e-7);
- forward outputs: 1e-5 absolute (outputs are convex combinations of v
  rows of order 1).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.models import attention as tattn

torch.set_num_threads(2)

REL = 1e-5


def _inputs(B, S, S_kv, Hq, Hkv, D, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    q = rng.normal(size=(B, S, Hq, D)).astype(dtype)
    k = rng.normal(size=(B, S_kv, Hkv, D)).astype(dtype)
    v = rng.normal(size=(B, S_kv, Hkv, D)).astype(dtype)
    w = rng.normal(size=(B, S, Hq, D)).astype(dtype)    # d loss / d out
    return q, k, v, w


def _grads(q, k, v, w, **kw):
    """(out, dq, dk, dv) of sum(out * w), JAX's and the port's."""
    def f(q, k, v):
        return jnp.sum(jattn.blocked_attention(q, k, v, flash_vjp=True,
                                               **kw) * w)

    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = (jattn.blocked_attention(jq, jk, jv, flash_vjp=True, **kw),) + \
        jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = tattn.blocked_attention(tq, tk, tv, **kw)
    (out * torch.from_numpy(w)).sum().backward()
    got = (out.detach(), tq.grad, tk.grad, tv.grad)
    return got, [np.asarray(a) for a in want]


# (B, S, S_kv, Hq, Hkv, D, causal, window, q_block, kv_block)
CASES = {
    "causal": (2, 32, 32, 4, 4, 16, True, None, 8, 8),
    "causal-one-tile": (2, 32, 32, 4, 4, 16, True, None, 512, 512),
    "causal-gqa": (2, 40, 40, 6, 2, 16, True, None, 8, 16),
    "windowed": (1, 48, 48, 4, 2, 8, True, 12, 8, 8),
    "windowed-uneven-blocks": (2, 40, 40, 6, 2, 16, True, 16, 16, 8),
    "windowed-g4": (1, 64, 64, 8, 2, 32, True, 24, 16, 16),
    "bidirectional": (2, 30, 30, 4, 2, 16, False, None, 10, 6),
    "cross-longer-kv": (2, 12, 36, 4, 4, 16, False, None, 512, 512),
    "cross-gqa-blocks": (2, 16, 40, 6, 3, 8, False, None, 8, 10),
    "cross-shorter-kv": (1, 24, 8, 4, 1, 16, False, None, 6, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_backward_matches_jax_grad(case):
    B, S, S_kv, Hq, Hkv, D, causal, window, qb, kb = CASES[case]
    q, k, v, w = _inputs(B, S, S_kv, Hq, Hkv, D, seed=len(case))
    got, want = _grads(q, k, v, w, causal=causal, window=window,
                       q_block=qb, kv_block=kb)
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-5)
    for name, g, wv in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        assert g.shape == wv.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), wv, rtol=0,
                                   atol=REL * float(np.abs(wv).max()),
                                   err_msg=name)


def test_flash_backward_bf16_matches_jax_grad():
    """bf16 inputs: each gradient comes back in its input's dtype, within
    one bf16 ulp of the reference's bf16 gradient plus 1e-2 of its
    largest entry (both compute in f32 from the same bf16 values and
    round once; the forward's bf16 out, which delta = rowsum(dout * out)
    reads, may round to the other side in one package)."""
    q, k, v, w = _inputs(1, 32, 32, 4, 2, 16, seed=3)
    kw = dict(causal=True, window=8, q_block=8, kv_block=8)

    def f(q, k, v):
        out = jattn.blocked_attention(q, k, v, flash_vjp=True, **kw)
        return jnp.sum(out.astype(jnp.float32) * w)

    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_(True) for a in (jq, jk, jv))
    out = tattn.blocked_attention(tq, tk, tv, **kw)
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(w)).sum().backward()
    for g, r in zip((tq.grad, tk.grad, tv.grad), want):
        assert g.dtype == torch.bfloat16
        g, r = g.float().numpy(), np.asarray(r.astype(jnp.float32))
        _, e = np.frexp(np.maximum(np.abs(g), np.abs(r)))
        err = np.abs(g - r) - np.ldexp(1.0, e - 8)
        assert np.all(err <= 1e-2 * np.abs(r).max()), err.max()


def test_flash_saves_only_q_k_v_out_lse():
    """Autograd keeps exactly q, k, v, out and the f32 log-sum-exp (B,
    Hkv, G, S), no O(S^2) tile (the counterpart of
    ``tests/test_attention.py::test_flash_memory_no_s2_residual``)."""
    B, S, Hq, Hkv, D = 1, 256, 2, 1, 8
    q, k, v, _ = _inputs(B, S, S, Hq, Hkv, D, seed=4)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = tattn.blocked_attention(tq, tk, tv, q_block=32, kv_block=32)
    shapes = [tuple(t.shape) for t in saved]
    assert shapes == [(B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D),
                      (B, S, Hq, D), (B, Hkv, Hq // Hkv, S)], shapes
    assert saved[0] is tq and saved[1] is tk and saved[2] is tv
    assert saved[4].dtype == torch.float32
    torch.testing.assert_close(saved[3], out)
    assert max(t.numel() for t in saved) < S * S


def test_forward_lse_matches_repro():
    """The forward's (out, lse), which the backward reads."""
    q, k, v, _ = _inputs(2, 24, 24, 6, 2, 16, seed=5)
    for causal, window in ((True, None), (True, 8), (False, None)):
        jo, jl = jattn._blocked_attention_fwd_only(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            window=window, q_block=8, kv_block=8)
        to, tl = tattn._blocked_attention_fwd_only(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            causal=causal, window=window, q_block=8, kv_block=8)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)


def test_no_graph_without_autograd():
    """Without autograd (serving) no graph is recorded and the result is
    the flash forward's."""
    q, k, v, _ = _inputs(1, 16, 16, 2, 2, 8, seed=6)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    with torch.no_grad():
        plain = tattn.blocked_attention(tq, tk, tv, q_block=8, kv_block=8)
    assert plain.grad_fn is None
    flash = tattn.blocked_attention(tq, tk, tv, q_block=8, kv_block=8)
    assert flash.grad_fn is not None
    assert torch.equal(plain, flash.detach())
