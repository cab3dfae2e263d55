"""Language models assembled from blocks (counterpart of
``repro.models.lm``): decoder-only LMs (dense / MoE / SSM / hybrid /
early-fusion VLM) and the Whisper-style encoder-decoder: init, the
forward pass, the training loss, prefill and the single-token decode
step.

Parameters keep the JAX package's tree: ``{"embed", "final_norm",
"blocks", "unembed"}`` (+ ``"enc"``, ``"cross"``, ``"pos_embed"`` for an
encoder-decoder) with every block leaf stacked over periods, and its
einsum layouts (``wq`` (d, Hq, Dh), ``wo`` (Hq, Dh, d), ``unembed`` (d,
V), experts (E, d, f)), so :func:`params_from_numpy` carries the JAX
parameters across as a copy.  The decode cache is ``{"blocks":
{"layer_j": {...}}, "pos": int}``: ``{"k", "v"}`` (n_periods, B, S, Hkv,
Dh) for an attention layer, ``{"h", "conv"}`` (n_periods, B, H, P, N) /
(n_periods, B, W-1, d_conv) for a Mamba one, and ``{"xk", "xv"}``
(n_periods, B, S_enc, Hkv, Dh), the encoder's keys and values, beside
them in an encoder-decoder; ``pos`` is a Python int, so no step reads
the device to find its slot.

The loss is a sequence-chunked cross-entropy, so the (B, S, V) logits are
never held; the backbone, the encoder layers and every loss chunk are
recomputed in the backward pass (``torch.utils.checkpoint``,
non-reentrant, per period as in the JAX package; the recompute is
deterministic, so values do not change), and attention's backward is the
flash backward (``models/attention.py``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import require_device
from repro_torch.kernels.plane import tree_map, tree_unbind
from repro_torch.models import blocks as B
from repro_torch.models import mamba as mamba_lib
from repro_torch.models.common import (NO_SHARD, ShardCtx, embed_init,
                                       matmul_f32, rms_norm,
                                       rope_frequencies)


def _dtype(cfg: ModelConfig, dtype):
    return dtype if dtype is not None else getattr(torch, cfg.dtype)


# ------------------------------------------------------------------ init ---

def init_lm_params(gen: torch.Generator, cfg: ModelConfig, dtype=None):
    """Random parameters drawn from ``gen``, on its device, in ``dtype``
    (default: the config's; MoE routers are float32 whatever it is).  The
    draws differ from ``jax.random``'s; use :func:`params_from_numpy` to
    start from the JAX package's."""
    dtype = _dtype(cfg, dtype)
    dev = gen.device
    params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }
    if cfg.first_dense:
        params["lead"] = B.init_lead_params(gen, cfg, dtype)
    params["blocks"] = B.init_stacked_params(gen, cfg, dtype)
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, cfg.vocab_size, cfg.d_model,
                                       dtype).T.contiguous()
    if cfg.is_encdec:
        spec = B.LayerSpec("A", False, True)
        params["enc"] = {
            "blocks": B.stack_trees([
                B.init_layer_params(gen, cfg, spec, dtype)
                for _ in range(cfg.encoder_layers)]),
            "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                      device=dev),
        }
        params["cross"] = B.stack_trees([
            {f"layer_{j}": {
                "xattn": B.init_attn_params(gen, cfg, dtype, cross=True),
                "ln_x": torch.zeros((cfg.d_model,), dtype=dtype, device=dev)}
             for j in range(len(B.period_spec(cfg)))}
            for _ in range(B.num_periods(cfg))])
        # sized for the largest decode shape Whisper runs (decode_32k)
        rows = max(32768, cfg.encoder_seq)
        params["pos_embed"] = (torch.randn((rows, cfg.d_model), generator=gen,
                                           device=dev) * 0.01).to(dtype)
    return params


def params_from_numpy(tree, device="cuda"):
    """A nested dict of numpy arrays (e.g. the JAX package's parameters
    through ``np.asarray``) as the same dict of tensors on ``device``.
    bfloat16 arrays (``ml_dtypes``) are read through their ``uint16``
    bits, so they arrive bit for bit.  The arrays are copied."""
    dev = require_device(device)

    def one(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            bits = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                    .copy())
            return bits.view(torch.bfloat16).to(dev)
        return torch.from_numpy(np.array(a)).to(dev)

    return tree_map(one, tree)


def params_to_numpy(tree):
    """A nested dict of tensors as numpy arrays on the host.  numpy has no
    bfloat16 of its own, so bfloat16 leaves come back as float32 (exact)."""
    def one(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return tree_map(one, tree)


# -------------------------------------------------------------- forward ---

def _angles(cfg: ModelConfig, S: int, device):
    """RoPE angles of positions 0..S-1; None for configs without RoPE
    (attention-free, the encoder-decoder's learned positions, or
    attention without positions, ``cfg.rope`` False)."""
    if cfg.attn_free or cfg.is_encdec or not cfg.rope:
        return None
    dim = cfg.mla.qk_rope_head_dim if cfg.mla is not None else cfg.head_dim
    return rope_frequencies(dim, cfg.rope_theta,
                            torch.arange(S, device=device))


def _sinusoid(S: int, d: int, device) -> torch.Tensor:
    """The encoder's sinusoidal positions (S, d), computed in float64 as
    numpy does, then float32."""
    pos = np.arange(S)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d)
    table = np.concatenate([np.sin(ang), np.cos(ang)], -1)
    return torch.from_numpy(table.astype(np.float32)).to(device)


def embed_tokens(params, cfg: ModelConfig, tokens, pos_offset: int = 0):
    """Token embeddings, plus the learned positions pos_offset.. of an
    encoder-decoder."""
    x = params["embed"][tokens]
    if cfg.is_encdec:
        S = tokens.shape[-1]
        x = x + params["pos_embed"][pos_offset:pos_offset + S]
    return x


def unembed(params, cfg: ModelConfig, x):
    """Logits in float32 (bf16 products summed in f32), x: (..., d)."""
    table = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    lead = x.shape[:-1]
    return matmul_f32(x.reshape(-1, x.shape[-1]), table).reshape(
        lead + (table.shape[1],))


def _periods(params, cfg: ModelConfig, key: str = "blocks"):
    """The per-period parameter trees of ``params[key]`` ("blocks" or
    "cross"): views along the stacked period axis, one ``unbind`` per
    leaf (so autograd stacks their gradients in one step)."""
    periods = tree_unbind(params[key])
    if len(periods) != B.num_periods(cfg):
        raise ValueError(f"{cfg.name}: {len(periods)} stacked periods, "
                         f"the config has {B.num_periods(cfg)}")
    return periods


def _period_pairs(params, cfg: ModelConfig):
    """(period params, its cross-attention params or None) per period."""
    blocks = _periods(params, cfg)
    cross = _periods(params, cfg, "cross") if cfg.is_encdec \
        else [None] * len(blocks)
    return list(zip(blocks, cross))


def _walk(params, cfg: ModelConfig):
    """(period index, layer name, spec, layer params, cross-attention
    params or None) in layer order."""
    specs = B.period_spec(cfg)
    for i, (pp, cp) in enumerate(_period_pairs(params, cfg)):
        for j, spec in enumerate(specs):
            name = f"layer_{j}"
            yield i, name, spec, pp[name], None if cp is None else cp[name]


def _cross_forward(cp, x, cfg: ModelConfig, enc_out, q_block, kv_block):
    """x + the decoder's cross-attention to enc_out; returns (x, (k, v))."""
    h = rms_norm(x, cp["ln_x"], cfg.norm_eps)
    y, kv = B.attn_forward(cp["xattn"], h, cfg, angles=None, causal=False,
                           kv_override=enc_out, q_block=q_block,
                           kv_block=kv_block)
    return x + y, kv


def lm_backbone(params, cfg: ModelConfig, x, *, remat: bool = True,
                enc_out=None, q_block=512, kv_block=512):
    """The decoder stack on embeddings x (B, S, d), cross-attending to
    ``enc_out`` (B, S_enc, d) in an encoder-decoder.  Returns (the
    final-normed hidden states (B, S, d), aux) with aux the MoE terms
    {"load_balance", "router_z"} summed over layers and divided by
    ``cfg.num_layers`` (zeros without an MoE).  The leading dense layers
    (``params["lead"]``) run first, then the stacked periods.  With
    ``remat`` and autograd on, each leading layer and each period runs
    under ``torch.utils.checkpoint``: the backward keeps its input and
    recomputes the rest."""
    angles = _angles(cfg, x.shape[1], x.device)
    specs = B.period_spec(cfg)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    def period_fn(x, pp, cp, enc_out):
        lb = rz = zero
        for j, spec in enumerate(specs):
            x, aux, _, _ = B.layer_forward(
                pp[f"layer_{j}"], x, cfg, spec, angles=angles,
                q_block=q_block, kv_block=kv_block)
            if cp is not None:
                x, _ = _cross_forward(cp[f"layer_{j}"], x, cfg, enc_out,
                                      q_block, kv_block)
            lb = lb + aux["load_balance"]
            rz = rz + aux["router_z"]
        return x, lb, rz

    def lead_fn(x, lp):        # a dense layer: no MoE terms
        return B.layer_forward(lp, x, cfg, B.DENSE, angles=angles,
                               q_block=q_block, kv_block=kv_block)[0]

    for i in range(cfg.first_dense):
        lp = params["lead"][f"layer_{i}"]
        x = checkpoint(lead_fn, x, lp, use_reentrant=False) \
            if remat and torch.is_grad_enabled() else lead_fn(x, lp)
    lb = rz = zero
    for pp, cp in _period_pairs(params, cfg):
        if remat and torch.is_grad_enabled():
            x, dlb, drz = checkpoint(period_fn, x, pp, cp, enc_out,
                                     use_reentrant=False)
        else:
            x, dlb, drz = period_fn(x, pp, cp, enc_out)
        lb, rz = lb + dlb, rz + drz
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    n = cfg.num_layers
    return x, {"load_balance": lb / n, "router_z": rz / n}


def encoder_forward(params, cfg: ModelConfig, enc_embed, *,
                    remat: bool = True, q_block=512, kv_block=512):
    """The Whisper encoder on stubbed frame embeddings (B, T_enc, d), cast
    to the model's dtype: sinusoidal positions, bidirectional
    self-attention + MLP layers, a final norm.  With ``remat`` and
    autograd on, each layer runs under ``torch.utils.checkpoint``."""
    x = enc_embed.to(params["embed"].dtype)
    x = x + _sinusoid(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]

    def enc_layer(x, lp):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, _ = B.attn_forward(lp["attn"], h, cfg, angles=None, causal=False,
                              q_block=q_block, kv_block=kv_block)
        x = x + y
        h = rms_norm(x, lp["ln2"], cfg.norm_eps)
        return x + B.mlp_forward(lp["mlp"], h, cfg)

    for lp in tree_unbind(params["enc"]["blocks"]):
        if remat and torch.is_grad_enabled():
            x = checkpoint(enc_layer, x, lp, use_reentrant=False)
        else:
            x = enc_layer(x, lp)
    return rms_norm(x, params["enc"]["final_norm"], cfg.norm_eps)


# ------------------------------------------------------------------ loss ---

def chunked_loss(params, cfg: ModelConfig, x, labels, mask=None,
                 chunk: int = 512):
    """Mean cross-entropy over the masked positions without holding the
    (B, S, V) logits: the sequence in chunks of ``chunk``, each chunk's
    f32 logits recomputed in the backward pass.  x: (B, S, d); labels:
    (B, S) integer; mask: (B, S) 0/1 (all ones when None)."""
    Bb, S, _ = x.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"loss chunk {chunk}")
    labels = labels.long()
    if mask is None:
        mask = torch.ones((Bb, S), dtype=torch.float32, device=x.device)

    def chunk_nll(xx, ll, mm):
        logits = unembed(params, cfg, xx)                      # f32
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, ll[..., None])[..., 0]
        return torch.sum((logz - gold) * mm)

    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        args = (x[:, sl], labels[:, sl], mask[:, sl])
        if torch.is_grad_enabled():
            tot = tot + checkpoint(chunk_nll, *args, use_reentrant=False)
        else:
            tot = tot + chunk_nll(*args)
        cnt = cnt + torch.sum(mask[:, sl])
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(params, cfg: ModelConfig, batch, *, remat: bool = True,
            q_block=512, kv_block=512, example_mask=None):
    """batch: {"tokens", "labels"} (B, S) (+ "enc_embed" (B, S_enc, d) for
    an encoder-decoder).  Returns (loss, aux), aux the MoE terms; with an
    MoE the loss adds ``aux_loss * load_balance + router_z_loss *
    router_z``.  ``example_mask``: (B,) 0/1, the CE-FL mini-batch ratio
    m_i."""
    tokens = batch["tokens"]
    x = embed_tokens(params, cfg, tokens)
    enc_out = None
    if cfg.is_encdec:
        enc_out = encoder_forward(params, cfg, batch["enc_embed"],
                                  remat=remat, q_block=q_block,
                                  kv_block=kv_block)
    x, aux = lm_backbone(params, cfg, x, remat=remat, enc_out=enc_out,
                         q_block=q_block, kv_block=kv_block)
    mask = None
    if example_mask is not None:
        mask = example_mask[:, None].expand(tokens.shape).to(torch.float32)
    loss = chunked_loss(params, cfg, x, batch["labels"], mask)
    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_loss * aux["load_balance"] \
            + cfg.moe.router_z_loss * aux["router_z"]
    return loss, aux


# ---------------------------------------------------------------- decode ---

def _check_servable(cfg: ModelConfig) -> None:
    """Serving keeps a K/V cache per stacked layer: latent attention (whose
    cache would hold the latent) and leading dense layers have none."""
    if cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: latent attention (MLA) trains but does not serve "
            "here: prefill and decode need a latent cache, not ported")
    if cfg.first_dense:
        raise NotImplementedError(
            f"{cfg.name}: the leading dense layers have no decode cache")


def _cache_rows(cfg: ModelConfig, cache_len: int) -> int:
    """Rows of the attention cache: a rolling buffer of min(window,
    cache_len) for sliding-window configs, else cache_len."""
    return cache_len if cfg.sliding_window is None \
        else min(cfg.sliding_window, cache_len)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
               device="cuda"):
    """An empty cache (zeros, pos 0): K/V rows for attention layers, a
    zero state for Mamba layers (h float32, conv in ``dtype``), and the
    encoder's K/V rows ``xk``, ``xv`` of an encoder-decoder."""
    _check_servable(cfg)
    dev = require_device(device)
    n = B.num_periods(cfg)
    shape = (n, batch, _cache_rows(cfg, cache_len), cfg.num_kv_heads,
             cfg.head_dim)
    dtype = _dtype(cfg, dtype)
    blocks = {}
    for j, spec in enumerate(B.period_spec(cfg)):
        if spec.kind == "A":
            layer = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                     "v": torch.zeros(shape, dtype=dtype, device=dev)}
        elif spec.kind == "E":
            layer = {}
        else:
            st = mamba_lib.init_mamba_state(batch, cfg.d_model, cfg.ssm,
                                            dtype, device=dev)
            layer = {k: t.new_zeros((n,) + tuple(t.shape))
                     for k, t in st.items()}
        if cfg.is_encdec:
            xshape = (n, batch, cfg.encoder_seq, cfg.num_kv_heads,
                      cfg.head_dim)
            layer["xk"] = torch.zeros(xshape, dtype=dtype, device=dev)
            layer["xv"] = torch.zeros(xshape, dtype=dtype, device=dev)
        blocks[f"layer_{j}"] = layer
    return {"blocks": blocks, "pos": 0}


def lm_decode_step(params, cfg: ModelConfig, tokens, cache, *,
                   ctx: ShardCtx = NO_SHARD):
    """tokens: (B,) integer, one new token per sequence, on the params'
    device.  Returns (logits (B, V) f32, cache) where the returned cache
    holds the SAME tensors as ``cache``, written in place, and ``pos`` + 1:
    the cache passed in is consumed.  With ``ctx.seq_shard_decode`` on a
    mesh, ``cache`` is this rank's :func:`shard_cache` and every rank of
    ``ctx.mesh`` takes the step together."""
    _check_servable(cfg)
    pos = cache["pos"]
    x = embed_tokens(params, cfg, tokens[:, None], pos_offset=pos)[:, 0]
    for i, name, spec, lp, cp in _walk(params, cfg):
        layer_cache = {k: t[i] for k, t in cache["blocks"][name].items()}
        x = B.layer_decode(lp, x, cfg, spec, layer_cache, pos,
                           window=cfg.sliding_window, ctx=ctx)
        if cp is not None:
            h = rms_norm(x, cp["ln_x"], cfg.norm_eps)
            x = x + B.cross_attn_decode(cp["xattn"], h, cfg, {
                "k": layer_cache["xk"], "v": layer_cache["xv"]})
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, cfg, x), {"blocks": cache["blocks"],
                                     "pos": pos + 1}


def shard_cache(cache, ctx: ShardCtx):
    """This rank's part of a whole cache for the sequence-sharded decode,
    as new tensors (a decode step writes its cache in place): slice
    ``ctx.shard`` of ``ctx.shards`` along the sequence axis of every
    attention layer's (n, B, S, Hkv, Dh) ``k`` / ``v``; Mamba states and
    the encoder's ``xk`` / ``xv`` whole."""
    n = ctx.shards

    def part(t):
        S = t.shape[2]
        if S % n:
            raise ValueError(f"a {S}-row cache does not split over {n} "
                             "ranks")
        s = S // n
        return t[:, :, ctx.shard * s:(ctx.shard + 1) * s].clone()

    return {"blocks": {name: {k: part(t) if k in ("k", "v") else t.clone()
                              for k, t in d.items()}
                       for name, d in cache["blocks"].items()},
            "pos": cache["pos"]}


def make_cross_cache(params, cfg: ModelConfig, enc_out):
    """Each decoder layer's cross-attention K/V of the encoder output
    enc_out (B, S_enc, d): {"layer_j": {"xk", "xv"}} stacked over periods,
    (n_periods, B, S_enc, Hkv, Dh), to merge into a cache's blocks."""
    out = {}
    for _, name, _, _, cp in _walk(params, cfg):
        p = cp["xattn"]
        layer = out.setdefault(name, {"xk": [], "xv": []})
        layer["xk"].append(B._proj(enc_out, p["wk"]))
        layer["xv"].append(B._proj(enc_out, p["wv"]))
    return {name: {k: torch.stack(ts) for k, ts in d.items()}
            for name, d in out.items()}


def prefill(params, cfg: ModelConfig, tokens, cache_len: int, *,
            enc_embed=None, q_block=512, kv_block=512):
    """Process a prompt batch (B, S) and return (last-position logits (B,
    V) f32, cache with room for ``cache_len`` positions, pos = S).  For a
    sliding-window prompt longer than the window the cache keeps the last
    `window` keys at rows 0..W-1, as the JAX package does; a Mamba layer
    keeps its final state (S must be a multiple of the chunk size).  An
    encoder-decoder runs the encoder on ``enc_embed`` (B, S_enc, d) and
    keeps each layer's cross-attention K/V as ``xk``, ``xv``."""
    _check_servable(cfg)
    S = tokens.shape[1]
    x = embed_tokens(params, cfg, tokens)
    enc_out = None
    if cfg.is_encdec:
        enc_out = encoder_forward(params, cfg, enc_embed, q_block=q_block,
                                  kv_block=kv_block)
    angles = _angles(cfg, S, x.device)
    states = {}
    for _, name, spec, lp, cp in _walk(params, cfg):
        x, _, kv, st = B.layer_forward(lp, x, cfg, spec, angles=angles,
                                       return_ssm_state=spec.kind == "M",
                                       q_block=q_block, kv_block=kv_block)
        st = st or {}
        if spec.kind == "A":
            k, v = kv
            W = cfg.sliding_window
            if W is not None and S > W:
                k, v = k[:, -W:], v[:, -W:]
            st = {"k": k, "v": v}
        if cp is not None:
            x, (xk, xv) = _cross_forward(cp, x, cfg, enc_out, q_block,
                                         kv_block)
            st = {**st, "xk": xk, "xv": xv}
        layer = states.setdefault(name, {})
        for key, t in st.items():
            layer.setdefault(key, []).append(t)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params, cfg, x[:, -1])
    blocks = {name: {key: torch.stack(ts) for key, ts in d.items()}
              for name, d in states.items()}
    return logits, {"blocks": _pad_cache_to(blocks, cfg, cache_len),
                    "pos": S}


def _pad_cache_to(blocks, cfg: ModelConfig, cache_len: int):
    """Grow (or cut) the (n, B, s, Hkv, Dh) K/V caches to the cache's row
    count, zeros after the prompt's rows; Mamba states and the encoder's
    K/V pass through."""
    target = _cache_rows(cfg, cache_len)

    def pad(x):
        n, b, s, h, d = x.shape
        if s < target:
            out = x.new_zeros((n, b, target, h, d))
            out[:, :, :s] = x
            return out
        return x[:, :, :target].contiguous()

    return {name: {key: pad(t) if key in ("k", "v") else t
                   for key, t in d.items()}
            for name, d in blocks.items()}
