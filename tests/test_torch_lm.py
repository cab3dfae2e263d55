"""The port's LM serving path (``repro_torch.models``, ``configs``,
``serve``) against the JAX package's.

Inputs are made with numpy from a seed; JAX parameters from
``repro.models.lm.init_lm_params`` are carried across with
``params_from_numpy``, so both packages run the same weights.

Tolerances, with their reasons:
- float32, modules and the whole slice: 1e-5 absolute on outputs and
  logits of order 1 (measured agreement is about 1e-6; the matrix
  products sum in XLA's and torch's CPU orders).
- bfloat16 slice: 5e-2 on the logits and on the cache (activations round
  to bf16 after every product, norm and residual add, at places where
  XLA's CPU dot and torch's differ by one ulp; measured about 1e-2 on
  logits of order 1, and one bf16 ulp, 3.1e-2, on cache values in
  [4, 8)).
- The port against itself (prefill + decode against the teacher-forced
  forward): 3e-4, the bound ``tests/test_system.py`` holds JAX to.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import common as jcommon
from repro.models import lm as JL
from repro_torch import configs as tconfigs
from repro_torch.kernels.plane import tree_map
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import common as tcommon
from repro_torch.models import lm as TL
from repro_torch.serve import main as serve_main
from repro_torch.serve import serve

torch.set_num_threads(2)

F32 = 1e-5


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(_np(a))).to(dtype)


def _cfgs(arch_ov, **extra):
    """repro's and the port's reduced config of (arch, overrides)."""
    arch, ov = arch_ov
    ov = {**ov, **extra}
    return (jconfigs.reduced(jconfigs.get_config(arch), **ov),
            tconfigs.reduced(tconfigs.get_config(arch), **ov))


SC2 = ("starcoder2-15b", {"num_heads": 6, "num_kv_heads": 2})   # GQA, W 64
QWEN = ("qwen3-32b", {"num_heads": 4, "num_kv_heads": 2})       # qk_norm
MAMBA = ("mamba2-130m", {})                     # SSD, chunk 8, no attention
JAMBA = ("jamba-v0.1-52b", {})      # Mamba + attention + MoE top-2 of 4
ARCTIC = ("arctic-480b", {})        # MoE top-2 + dense residual, 2 layers
LLAMA4 = ("llama4-maverick-400b-a17b", {})   # dense + MoE top-1 + shared
WHISPER = ("whisper-medium", {})    # encoder-decoder, cross-attention


def _params(jcfg, dtype=jnp.float32, seed=0):
    p = JL.init_lm_params(jax.random.PRNGKey(seed), jcfg, dtype)
    return p, TL.params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                   device="cpu")


# ------------------------------------------------------------ configs ---

def _as_reference(t):
    """The port's config as a dict of the reference's fields, after
    checking that each field only the port has (Nemotron-H's drop-free
    MoE, B/C groups, explicit SSM heads, NoPE, relu²) is at the default
    that gives the reference's layers."""
    out = dataclasses.asdict(t)
    only_port = {"rope": True, "mlp_act": "gelu"}
    only_moe = {"expert_act": "swiglu", "dropless": False,
                "routed_scale": 1.0, "held_experts": None, "expert_offset": 0}
    only_ssm = {"num_heads": None, "n_groups": 1}
    for d, extra in ((out, only_port), (out["moe"], only_moe),
                     (out["ssm"], only_ssm)):
        if d is not None:
            assert {k: d.pop(k) for k in extra} == extra
    return out


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS + ["cefl-paper"])
def test_get_config_matches_repro(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert _as_reference(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert _as_reference(tconfigs.reduced(t)) == \
        dataclasses.asdict(jconfigs.reduced(j))
    assert tconfigs.get_config(arch.replace("-", "_")) == t
    assert tconfigs.INPUT_SHAPES == {
        k: tconfigs.ShapeConfig(**dataclasses.asdict(v))
        for k, v in jconfigs.INPUT_SHAPES.items()}


@pytest.mark.parametrize("arch,missing", [
    ("jamba-v0.1-52b", "MoE"),
    ("arctic-480b", "MoE"), ("llama4-maverick-400b-a17b", "MoE"),
    ("whisper-medium", "encoder-decoder")])
def test_unported_layer_kinds_raise(arch, missing):
    """These configs were refused while their MoE layers / encoder-decoder
    were not ported; now each builds, its parameter tree and cache are
    the reference's leaf for leaf, and it holds the ``missing`` module."""
    jcfg, tcfg = (jconfigs.reduced(jconfigs.get_config(arch)),
                  tconfigs.reduced(tconfigs.get_config(arch)))
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        tp = TL.init_lm_params(torch.Generator().manual_seed(0), tcfg, dtype)
        p = jax.eval_shape(lambda: JL.init_lm_params(
            jax.random.PRNGKey(0), jcfg, jdtype))
        assert tree_map(lambda a: (tuple(a.shape), str(a.dtype).split(".")
                                   [-1]), tp) == jax.tree_util.tree_map(
            lambda a: (tuple(a.shape), str(a.dtype)), p)
        cache = TL.init_cache(tcfg, 2, 8, dtype, device="cpu")
        want = jax.eval_shape(lambda: JL.init_cache(jcfg, 2, 8, jdtype))
        assert tree_map(lambda a: tuple(a.shape), cache["blocks"]) == \
            jax.tree_util.tree_map(lambda a: tuple(a.shape), want["blocks"])
    has = any("moe" in lp for lp in tp["blocks"].values()) \
        if missing == "MoE" \
        else {"enc", "cross", "pos_embed"} <= set(tp)
    assert has


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown architecture"):
        tconfigs.get_config("nope-1b")


# ------------------------------------------------------------- params ---

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_from_numpy_round_trips(dtype):
    jcfg, _ = _cfgs(SC2)
    p, tp = _params(jcfg, dtype)
    jleaves = jax.tree_util.tree_leaves_with_path(p)
    for path, leaf in jleaves:
        t = tp
        for k in path:
            t = t[k.key]
        want = np.asarray(leaf)
        assert tuple(t.shape) == want.shape
        if dtype == jnp.bfloat16:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy().view(np.uint16),
                want.view(np.uint16))
        else:
            np.testing.assert_array_equal(t.numpy(), want)
    back = TL.params_to_numpy(tp)
    for path, leaf in jleaves:
        b = back
        for k in path:
            b = b[k.key]
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, _np(leaf))


def test_init_lm_params_tree_matches_repro():
    jcfg, tcfg = _cfgs(QWEN)
    p, _ = _params(jcfg)
    tp = TL.init_lm_params(torch.Generator().manual_seed(0), tcfg,
                           torch.float32)
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), p)
    tshapes = tree_map(lambda a: tuple(a.shape), tp)
    assert tshapes == jshapes
    for name in ("wq", "wo"):
        w = tp["blocks"]["layer_0"]["attn"][name]
        assert abs(float(w.float().std()) * np.sqrt(
            tcfg.d_model if name == "wq" else tcfg.num_heads
            * tcfg.head_dim) - 1.0) < 0.1


# ------------------------------------------------------------ modules ---

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_rms_norm(dtype):
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.normal(size=(3, 5, 64)).astype(np.float32)) * 3
    s = jnp.asarray(rng.normal(size=(64,)).astype(np.float32)) * 0.1
    x, s = x.astype(dtype), s.astype(dtype)
    want = jcommon.rms_norm(x, s, 1e-5)
    td = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    got = tcommon.rms_norm(_t(x, td), _t(s, td), 1e-5)
    assert got.dtype == td
    if dtype == jnp.float32:
        np.testing.assert_allclose(got.numpy(), _np(want), atol=F32)
    else:   # one bf16 ulp of the result
        g, w = got.float().numpy(), _np(want)
        _, e = np.frexp(np.maximum(np.abs(g), np.abs(w)))
        assert np.all(np.abs(g - w) <= np.ldexp(1.0, e - 8))


def test_apply_rope():
    rng = np.random.RandomState(1)
    x = rng.normal(size=(2, 12, 3, 32)).astype(np.float32)
    for theta in (10000.0, 1_000_000.0):
        ja = jcommon.rope_frequencies(32, theta, jnp.arange(12))
        ta = tcommon.rope_frequencies(32, theta, torch.arange(12))
        np.testing.assert_allclose(ta.numpy(), _np(ja), rtol=1e-6)
        np.testing.assert_allclose(
            tcommon.apply_rope(torch.from_numpy(x), ta).numpy(),
            _np(jcommon.apply_rope(jnp.asarray(x), ja)), atol=F32)


@pytest.mark.parametrize("gated", [False, True])
def test_mlp_forward(gated):
    jcfg, tcfg = _cfgs(SC2, gated_mlp=gated)
    p, tp = _params(jcfg)
    x = np.random.RandomState(2).normal(size=(2, 7, jcfg.d_model)).astype(
        np.float32)
    want = jblocks.mlp_forward(
        jax.tree_util.tree_map(lambda a: a[0], p["blocks"]["layer_0"]["mlp"]),
        jnp.asarray(x), jcfg)
    got = tblocks.mlp_forward(
        {k: v[0] for k, v in tp["blocks"]["layer_0"]["mlp"].items()},
        torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=F32)


@pytest.mark.parametrize("window", [None, 16])
def test_blocked_attention_forward(window):
    """Causal, with and without a window shorter than the sequence, with
    tiles that the masks cover entirely (the port skips those)."""
    rng = np.random.RandomState(3)
    B, S, Hq, Hkv, D = 2, 40, 6, 2, 32
    q, k, v = (rng.normal(size=(B, S, h, D)).astype(np.float32)
               for h in (Hq, Hkv, Hkv))
    want = jattn.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True, window=window,
                                   q_block=8, kv_block=8, flash_vjp=False)
    for qb, kb in ((8, 8), (512, 512), (16, 8)):
        got = tattn.blocked_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            window=window, q_block=qb, kv_block=kb)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=F32)


@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("per_row", [False, True])
def test_decode_attention_plain(window, per_row):
    rng = np.random.RandomState(4)
    B, S, Hq, Hkv, D = 3, 48, 8, 2, 32
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
            for _ in range(2))
    clen = np.array([5, 30, 48], np.int32) if per_row else 40
    want = jattn.decode_attention_plain(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jnp.asarray(clen),
                                        window=window)
    got = tattn.decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(clen) if per_row else clen, window=window)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=F32)
    if window is None and not per_row:   # the kernel's plain version too
        from repro_torch.kernels import ref
        np.testing.assert_allclose(
            ref.swa_decode_attention_ref(torch.from_numpy(q),
                                         torch.from_numpy(k),
                                         torch.from_numpy(v), clen).numpy(),
            got.numpy(), atol=F32)


# -------------------------------------------------------------- slice ---

def _slice(arch_ov, dtype, S0=16, steps=8):
    """repro's and the port's prefill, cache and decode logits (an
    encoder-decoder on the same numpy-seeded encoder frames)."""
    jcfg, tcfg = _cfgs(arch_ov)
    p, tp = _params(jcfg, dtype)
    toks = np.random.RandomState(5).randint(0, jcfg.vocab_size,
                                            (2, S0 + steps))
    enc = None
    if jcfg.is_encdec:
        enc = np.random.RandomState(6).normal(
            size=(2, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32) * .1
    jl, jc = JL.prefill(p, jcfg, jnp.asarray(toks[:, :S0]),
                        cache_len=S0 + steps, q_block=8, kv_block=8,
                        enc_embed=None if enc is None else jnp.asarray(enc))
    tl, tc = TL.prefill(tp, tcfg, torch.from_numpy(toks[:, :S0]),
                        S0 + steps, q_block=8, kv_block=8,
                        enc_embed=None if enc is None
                        else torch.from_numpy(enc))
    # the port's decode writes its cache in place: keep the prefill's
    out = {"prefill": (tl, jl), "steps": [],
           "caches": [(tree_map(torch.clone, tc["blocks"]),
                       jc["blocks"])]}
    step = jax.jit(lambda tok, c: JL.lm_decode_step(p, jcfg, tok, c))
    for t in range(S0, S0 + steps):
        jl, jc = step(jnp.asarray(toks[:, t]), jc)
        tl, tc = TL.lm_decode_step(tp, tcfg, torch.from_numpy(toks[:, t]), tc)
        out["steps"].append((tl, jl))
    assert tc["pos"] == int(jc["pos"]) == S0 + steps
    out["caches"].append((tc["blocks"], jc["blocks"]))
    return out, tp, tcfg, toks


@pytest.mark.parametrize("arch_ov,dtype", [(SC2, jnp.float32),
                                           (QWEN, jnp.float32),
                                           (SC2, jnp.bfloat16),
                                           (MAMBA, jnp.float32),
                                           (MAMBA, jnp.bfloat16),
                                           (JAMBA, jnp.float32),
                                           (ARCTIC, jnp.float32),
                                           (LLAMA4, jnp.float32),
                                           (WHISPER, jnp.float32)],
                         ids=["starcoder2-gqa-f32", "qwen3-qknorm-f32",
                              "starcoder2-gqa-bf16", "mamba2-f32",
                              "mamba2-bf16", "jamba-hybrid-moe-f32",
                              "arctic-moe-f32", "llama4-moe-shared-f32",
                              "whisper-encdec-f32"])
def test_prefill_and_decode_match_repro(arch_ov, dtype):
    out, _, _, _ = _slice(arch_ov, dtype)
    bf16 = dtype == jnp.bfloat16
    tol = 5e-2 if bf16 else F32
    tl, jl = out["prefill"]
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=tol)
    for tc, jc in out["caches"]:          # after prefill, after decode
        for name, kv in ((n, kv) for n in tc for kv in tc[n]):
            assert sorted(tc[name]) == sorted(jc[name])
            g, w = tc[name][kv].float().numpy(), _np(jc[name][kv])
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, atol=tol)
    for tl, jl in out["steps"]:
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=tol)


def _teacher_forced(tp, tcfg, toks):
    x, _ = TL.lm_backbone(tp, tcfg, TL.embed_tokens(tp, tcfg,
                                                    torch.from_numpy(toks)),
                          q_block=8, kv_block=8)
    return TL.unembed(tp, tcfg, x)


@pytest.mark.parametrize("arch_ov", [SC2, QWEN, MAMBA],
                         ids=["starcoder2", "qwen3", "mamba2"])
def test_decode_matches_teacher_forced_forward(arch_ov):
    """The port's prefill + decode steps reproduce its own teacher-forced
    logits, as tests/test_system.py holds the JAX package to."""
    jcfg, tcfg = _cfgs(arch_ov)
    _, tp = _params(jcfg)
    B, S, S0 = 2, 24, 16
    toks = np.random.RandomState(6).randint(0, tcfg.vocab_size, (B, S))
    full = _teacher_forced(tp, tcfg, toks)
    lg, cache = TL.prefill(tp, tcfg, torch.from_numpy(toks[:, :S0]), S,
                           q_block=8, kv_block=8)
    np.testing.assert_allclose(lg.numpy(), full[:, S0 - 1].numpy(),
                               atol=3e-4)
    for t in range(S0, S):
        lg, cache = TL.lm_decode_step(tp, tcfg, torch.from_numpy(toks[:, t]),
                                      cache)
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(), atol=3e-4)


def test_backbone_matches_repro_past_the_window():
    """The teacher-forced forward at 80 tokens > window 64 (the window
    mask cuts) against repro's."""
    jcfg, tcfg = _cfgs(SC2)
    p, tp = _params(jcfg)
    toks = np.random.RandomState(7).randint(0, jcfg.vocab_size, (2, 80))
    jx, _ = JL.lm_backbone(p, jcfg, JL.embed_tokens(p, jcfg,
                                                    jnp.asarray(toks)),
                           remat=False, q_block=16, kv_block=16)
    want = JL.unembed(p, jcfg, jx)
    got = _teacher_forced(tp, tcfg, toks)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=F32)


def test_rolling_slot_after_a_prompt_longer_than_the_window():
    """A fault of the reference, copied by the port: after a prompt of
    80 > window 64 tokens, prefill keeps positions 16..79 at slots 0..63,
    but decode writes position 80 at slot 80 % 64 = 16, over position 32,
    which is still in the window.  The port's decode logits equal
    repro's, and both differ from the teacher-forced recompute."""
    out, tp, tcfg, toks = _slice(SC2, jnp.float32, S0=80, steps=1)
    tl, jl = out["steps"][0]
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=F32)
    full = _teacher_forced(tp, tcfg, toks)[:, -1].numpy()
    np.testing.assert_allclose(out["prefill"][0].numpy(),
                               _teacher_forced(tp, tcfg, toks[:, :80])
                               [:, -1].numpy(), atol=3e-4)
    assert float(np.max(np.abs(tl.numpy() - full))) > 100 * 3e-4


# -------------------------------------------------------------- serve ---

def test_serve_greedy_tokens_follow_the_decode_loop():
    """``serve`` is prefill + argmax + lm_decode_step + argmax, with the
    cache written in place."""
    _, tcfg = _cfgs(SC2)
    gen = torch.Generator().manual_seed(3)
    params = TL.init_lm_params(gen, tcfg, torch.float32)
    prompts = np.random.RandomState(8).randint(0, tcfg.vocab_size, (3, 12))
    tokens, stats = serve(tcfg, prompts, gen=5, cache_len=32, params=params,
                          device="cpu")
    assert tokens.shape == (3, 5) and stats["logits_finite"]
    assert len(stats["decode_step_s"]) == 4
    lg, cache = TL.prefill(params, tcfg, torch.from_numpy(prompts), 32)
    want = [torch.argmax(lg, -1)]
    for _ in range(4):
        lg, cache = TL.lm_decode_step(params, tcfg, want[-1], cache)
        want.append(torch.argmax(lg, -1))
    torch.testing.assert_close(tokens, torch.stack(want, 1))


def test_serve_cli_on_the_cpu_and_its_refusals():
    tokens, stats = serve_main(["--reduced", "--layers", "2", "--batch", "2",
                                "--prompt-len", "8", "--gen", "3",
                                "--cache-len", "16", "--device", "cpu"])
    assert tokens.shape == (2, 3) and stats["logits_finite"]
    assert int(tokens.max()) < 512
    _, tcfg = _cfgs(QWEN)
    with pytest.raises(ValueError, match="do not fit"):
        serve(tcfg, np.zeros((1, 10), np.int64), gen=8, cache_len=16,
              device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            serve(tcfg, np.zeros((1, 4), np.int64), gen=2, cache_len=16)


def test_serve_mamba_follows_its_decode_loop_and_refuses_ragged_prompts():
    """A Mamba config serves with no attention cache (``cache_len`` is not
    a bound) and a prompt a multiple of the SSD chunk, as the reference's
    ``ssd_forward`` asserts."""
    _, tcfg = _cfgs(MAMBA)
    params = TL.init_lm_params(torch.Generator().manual_seed(4), tcfg,
                               torch.float32)
    prompts = np.random.RandomState(9).randint(0, tcfg.vocab_size, (2, 16))
    tokens, stats = serve(tcfg, prompts, gen=4, cache_len=8, params=params,
                          device="cpu")
    assert tokens.shape == (2, 4) and stats["logits_finite"]
    lg, cache = TL.prefill(params, tcfg, torch.from_numpy(prompts), 8)
    assert sorted(cache["blocks"]["layer_0"]) == ["conv", "h"]
    want = [torch.argmax(lg, -1)]
    for _ in range(3):
        lg, cache = TL.lm_decode_step(params, tcfg, want[-1], cache)
        want.append(torch.argmax(lg, -1))
    torch.testing.assert_close(tokens, torch.stack(want, 1))
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        serve(tcfg, np.zeros((1, 12), np.int64), gen=2, cache_len=16,
              params=params, device="cpu")
