"""The port's encoder-decoder (whisper-medium's Whisper-style model:
encoder, learned decoder positions, cross-attention, the cross cache)
against the JAX package's, on the reduced config (2 + 2 layers, 16
encoder frames) with the JAX parameters carried across.

Tolerances, with their reasons:
- float32 activations, K/V and logits: 1e-5 absolute (values of order
  1; products summed in XLA's and torch's CPU orders; measured about
  1e-6);
- the port against itself (prefill + decode against the teacher-forced
  forward): 3e-4, the bound ``tests/test_system.py`` holds JAX to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import blocks as jblocks
from repro.models import lm as JL
from repro_torch import configs as tconfigs
from repro_torch.kernels.plane import tree_map, tree_paths
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as TL
from repro_torch.serve import serve

torch.set_num_threads(2)

F32 = 1e-5
ARCH = "whisper-medium"


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.reduced(jconfigs.get_config(ARCH))
    tcfg = tconfigs.reduced(tconfigs.get_config(ARCH))
    p = JL.init_lm_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = TL.params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                              device="cpu")
    return jcfg, tcfg, p, tp


def _frames(cfg, B, seed=1):
    return np.random.RandomState(seed).normal(
        size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32) * 0.1


def test_sinusoid_matches_repro():
    for S, d in ((16, 32), (1500, 1024), (7, 6)):
        np.testing.assert_array_equal(
            TL._sinusoid(S, d, "cpu").numpy(), np.asarray(JL._sinusoid(S, d)))


def test_init_lm_params_tree_matches_repro(model):
    jcfg, tcfg, p, _ = model
    for dtype in (torch.float32, torch.bfloat16):
        tp = TL.init_lm_params(torch.Generator().manual_seed(0), tcfg, dtype)
        want = jax.tree_util.tree_map(lambda a: tuple(a.shape), p)
        assert tree_map(lambda a: tuple(a.shape), tp) == want
        assert {t.dtype for _, t in tree_paths(tp)} == {dtype}
    assert tp["pos_embed"].shape == (32768, tcfg.d_model)
    assert "q_norm" not in tp["cross"]["layer_0"]["xattn"]
    assert tcfg.param_count() == jcfg.param_count()


def test_encoder_forward_matches_repro(model):
    jcfg, tcfg, p, tp = model
    enc = _frames(jcfg, 2)
    want = JL.encoder_forward(p, jcfg, jnp.asarray(enc), q_block=8,
                              kv_block=8)
    for blk in (8, 512, 6):
        got = TL.encoder_forward(tp, tcfg, torch.from_numpy(enc),
                                 q_block=blk, kv_block=blk)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=F32)


def test_embed_tokens_adds_learned_positions(model):
    jcfg, tcfg, p, tp = model
    toks = np.random.RandomState(2).randint(0, jcfg.vocab_size, (2, 5))
    for off in (0, 3, 100):
        want = JL.embed_tokens(p, jcfg, jnp.asarray(toks), off)
        got = TL.embed_tokens(tp, tcfg, torch.from_numpy(toks), off)
        np.testing.assert_array_equal(got.numpy(), _np(want))


def test_cross_attention_forward_and_cache(model):
    """``make_cross_cache`` and the cross-attention forward (non-causal,
    keys from the encoder, no RoPE) against the reference's."""
    jcfg, tcfg, p, tp = model
    rng = np.random.RandomState(3)
    enc = rng.normal(size=(2, jcfg.encoder_seq, jcfg.d_model)).astype(
        np.float32)
    want = JL.make_cross_cache(p, jcfg, jnp.asarray(enc))
    got = TL.make_cross_cache(tp, tcfg, torch.from_numpy(enc))
    assert sorted(got) == sorted(want)
    for name in want:
        for key in ("xk", "xv"):
            np.testing.assert_allclose(got[name][key].numpy(),
                                       _np(want[name][key]), atol=F32)
    x = rng.normal(size=(2, 6, jcfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                p["cross"]["layer_0"]["xattn"])
    tpp = {k: v[0] for k, v in tp["cross"]["layer_0"]["xattn"].items()}
    jy, (jk, jv) = jblocks.attn_forward(
        jp, jnp.asarray(x), jcfg, angles=None, causal=False,
        kv_override=jnp.asarray(enc))
    ty, (tk, tv) = tblocks.attn_forward(
        tpp, torch.from_numpy(x), tcfg, angles=None, causal=False,
        kv_override=torch.from_numpy(enc))
    np.testing.assert_allclose(ty.numpy(), _np(jy), atol=F32)
    np.testing.assert_allclose(tk.numpy(), _np(jk), atol=F32)
    # the decode form over the full cache
    q1 = rng.normal(size=(2, jcfg.d_model)).astype(np.float32)
    jd = jblocks.cross_attn_decode(jp, jnp.asarray(q1), jcfg,
                                   {"k": jk, "v": jv})
    td = tblocks.cross_attn_decode(tpp, torch.from_numpy(q1), tcfg,
                                   {"k": tk, "v": tv})
    np.testing.assert_allclose(td.numpy(), _np(jd), atol=F32)


def test_init_cache_matches_repro(model):
    jcfg, tcfg, _, _ = model
    want = JL.init_cache(jcfg, 3, 24, jnp.float32)
    got = TL.init_cache(tcfg, 3, 24, torch.float32, device="cpu")
    assert got["pos"] == int(want["pos"]) == 0
    assert tree_map(lambda a: tuple(a.shape), got["blocks"]) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), want["blocks"])
    assert got["blocks"]["layer_0"]["xk"].shape == (
        2, 3, tcfg.encoder_seq, tcfg.num_kv_heads, tcfg.head_dim)


def test_decode_matches_teacher_forced_forward(model):
    """Prefill (encoder + decoder) and decode steps reproduce the port's
    own teacher-forced logits."""
    _, tcfg, _, tp = model
    B, S, S0 = 2, 20, 12
    toks = np.random.RandomState(4).randint(0, tcfg.vocab_size, (B, S))
    enc = torch.from_numpy(_frames(tcfg, B, seed=5))
    enc_out = TL.encoder_forward(tp, tcfg, enc, q_block=8, kv_block=8)
    x, _ = TL.lm_backbone(tp, tcfg, TL.embed_tokens(
        tp, tcfg, torch.from_numpy(toks)), enc_out=enc_out, q_block=8,
        kv_block=8)
    full = TL.unembed(tp, tcfg, x)
    lg, cache = TL.prefill(tp, tcfg, torch.from_numpy(toks[:, :S0]), S,
                           enc_embed=enc, q_block=8, kv_block=8)
    np.testing.assert_allclose(lg.numpy(), full[:, S0 - 1].numpy(),
                               atol=3e-4)
    for t in range(S0, S):
        lg, cache = TL.lm_decode_step(tp, tcfg, torch.from_numpy(toks[:, t]),
                                      cache)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), atol=3e-4)


def test_serve_encdec_follows_its_decode_loop(model):
    """``serve`` draws the encoder frames from the seed (or takes them),
    prefills with the encoder and decodes with the cross cache."""
    _, tcfg, _, tp = model
    prompts = np.random.RandomState(6).randint(0, tcfg.vocab_size, (2, 8))
    tokens, stats = serve(tcfg, prompts, gen=4, cache_len=16, params=tp,
                          seed=3, device="cpu")
    assert tokens.shape == (2, 4) and stats["logits_finite"]
    enc = torch.randn((2, tcfg.encoder_seq, tcfg.d_model),
                      generator=torch.Generator().manual_seed(4)) * 0.1
    lg, cache = TL.prefill(tp, tcfg, torch.from_numpy(prompts), 16,
                           enc_embed=enc)
    want = [torch.argmax(lg, -1)]
    for _ in range(3):
        lg, cache = TL.lm_decode_step(tp, tcfg, want[-1], cache)
        want.append(torch.argmax(lg, -1))
    torch.testing.assert_close(tokens, torch.stack(want, 1))
    again, _ = serve(tcfg, prompts, gen=4, cache_len=16, params=tp,
                     enc_embed=enc, device="cpu")
    torch.testing.assert_close(again, tokens)
