"""Decoder-only language models assembled from blocks (counterpart of
``repro.models.lm``): init, the forward pass, the training loss, prefill
and the single-token decode step, for configs of attention layers with
dense MLPs and of Mamba-2 layers (``blocks.check_ported`` names what else
is missing).

Parameters keep the JAX package's tree: ``{"embed", "final_norm",
"blocks", "unembed"}`` with every block leaf stacked over periods, and
its einsum layouts (``wq`` (d, Hq, Dh), ``wo`` (Hq, Dh, d), ``unembed``
(d, V)), so :func:`params_from_numpy` carries the JAX parameters across
as a copy.  The decode cache is ``{"blocks": {"layer_j": {...}}, "pos":
int}``: ``{"k", "v"}`` (n_periods, B, S, Hkv, Dh) for an attention layer,
``{"h", "conv"}`` (n_periods, B, H, P, N) / (n_periods, B, W-1, d_conv)
for a Mamba one; ``pos`` is a Python int, so no step reads the device to
find its slot.

The loss is a sequence-chunked cross-entropy, so the (B, S, V) logits are
never held; the backbone and every loss chunk are recomputed in the
backward pass (``torch.utils.checkpoint``, non-reentrant, per period as
in the JAX package; the recompute is deterministic, so values do not
change).  Training a config with attention layers needs the flash
backward (``repro.models.attention._flash_bwd``), which is not ported.
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
from repro_torch.models.common import (embed_init, matmul_f32, rms_norm,
                                       rope_frequencies)


def _dtype(cfg: ModelConfig, dtype):
    return dtype if dtype is not None else getattr(torch, cfg.dtype)


# ------------------------------------------------------------------ init ---

def init_lm_params(gen: torch.Generator, cfg: ModelConfig, dtype=None):
    """Random parameters drawn from ``gen``, on its device, in ``dtype``
    (default: the config's).  The draws differ from ``jax.random``'s; use
    :func:`params_from_numpy` to start from the JAX package's."""
    B.check_ported(cfg)
    dtype = _dtype(cfg, dtype)
    params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype,
                                  device=gen.device),
        "blocks": B.init_stacked_params(gen, cfg, dtype),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = embed_init(gen, cfg.vocab_size, cfg.d_model,
                                       dtype).T.contiguous()
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
    return rope_frequencies(cfg.head_dim, cfg.rope_theta,
                            torch.arange(S, device=device))


def embed_tokens(params, cfg: ModelConfig, tokens):
    return params["embed"][tokens]


def unembed(params, cfg: ModelConfig, x):
    """Logits in float32 (bf16 products summed in f32), x: (..., d)."""
    table = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    lead = x.shape[:-1]
    return matmul_f32(x.reshape(-1, x.shape[-1]), table).reshape(
        lead + (table.shape[1],))


def _periods(params, cfg: ModelConfig):
    """The per-period parameter trees: views along the stacked period
    axis, one ``unbind`` per leaf (so autograd stacks their gradients in
    one step)."""
    periods = tree_unbind(params["blocks"])
    if len(periods) != B.num_periods(cfg):
        raise ValueError(f"{cfg.name}: {len(periods)} stacked periods, "
                         f"the config has {B.num_periods(cfg)}")
    return periods


def _walk(params, cfg: ModelConfig):
    """(period index, layer name, spec, layer params) in layer order."""
    specs = B.period_spec(cfg)
    for i, pp in enumerate(_periods(params, cfg)):
        for j, spec in enumerate(specs):
            yield i, f"layer_{j}", spec, pp[f"layer_{j}"]


def lm_backbone(params, cfg: ModelConfig, x, *, remat: bool = True,
                q_block=512, kv_block=512):
    """The decoder stack on embeddings x (B, S, d); returns the
    final-normed hidden states (B, S, d).  With ``remat`` and autograd on,
    each period runs under ``torch.utils.checkpoint``: the backward keeps
    each period's input and recomputes the rest."""
    B.check_ported(cfg)
    angles = None if cfg.attn_free else _angles(cfg, x.shape[1], x.device)
    specs = B.period_spec(cfg)

    def period_fn(x, pp):
        for j, spec in enumerate(specs):
            x, _, _ = B.layer_forward(pp[f"layer_{j}"], x, cfg, spec,
                                      angles=angles, q_block=q_block,
                                      kv_block=kv_block)
        return x

    for pp in _periods(params, cfg):
        if remat and torch.is_grad_enabled():
            x = checkpoint(period_fn, x, pp, use_reentrant=False)
        else:
            x = period_fn(x, pp)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


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
    """batch: {"tokens", "labels"} (B, S).  Returns (loss, aux), aux the
    JAX package's MoE terms (zero: no MoE layer is ported).
    ``example_mask``: (B,) 0/1, the CE-FL mini-batch ratio m_i."""
    if not cfg.attn_free:
        raise NotImplementedError(
            f"{cfg.name}: training attention layers needs the flash "
            "backward (repro.models.attention._flash_bwd), which is not "
            "ported yet")
    tokens = batch["tokens"]
    x = embed_tokens(params, cfg, tokens)
    x = lm_backbone(params, cfg, x, remat=remat, q_block=q_block,
                    kv_block=kv_block)
    mask = None
    if example_mask is not None:
        mask = example_mask[:, None].expand(tokens.shape).to(torch.float32)
    loss = chunked_loss(params, cfg, x, batch["labels"], mask)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return loss, {"load_balance": zero, "router_z": zero}


# ---------------------------------------------------------------- decode ---

def _cache_rows(cfg: ModelConfig, cache_len: int) -> int:
    """Rows of the attention cache: a rolling buffer of min(window,
    cache_len) for sliding-window configs, else cache_len."""
    return cache_len if cfg.sliding_window is None \
        else min(cfg.sliding_window, cache_len)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
               device="cuda"):
    """An empty cache (zeros, pos 0): K/V rows for attention layers, a
    zero state for Mamba layers (h float32, conv in ``dtype``)."""
    B.check_ported(cfg)
    dev = require_device(device)
    n = B.num_periods(cfg)
    shape = (n, batch, _cache_rows(cfg, cache_len), cfg.num_kv_heads,
             cfg.head_dim)
    dtype = _dtype(cfg, dtype)
    blocks = {}
    for j, spec in enumerate(B.period_spec(cfg)):
        if spec.kind == "A":
            blocks[f"layer_{j}"] = {
                "k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}
        else:
            st = mamba_lib.init_mamba_state(batch, cfg.d_model, cfg.ssm,
                                            dtype, device=dev)
            blocks[f"layer_{j}"] = {
                k: t.new_zeros((n,) + tuple(t.shape)) for k, t in st.items()}
    return {"blocks": blocks, "pos": 0}


def lm_decode_step(params, cfg: ModelConfig, tokens, cache):
    """tokens: (B,) integer, one new token per sequence, on the params'
    device.  Returns (logits (B, V) f32, cache) where the returned cache
    holds the SAME tensors as ``cache``, written in place, and ``pos`` + 1:
    the cache passed in is consumed."""
    pos = cache["pos"]
    x = embed_tokens(params, cfg, tokens)
    for i, name, spec, lp in _walk(params, cfg):
        layer_cache = {k: t[i] for k, t in cache["blocks"][name].items()}
        x = B.layer_decode(lp, x, cfg, spec, layer_cache, pos,
                           window=cfg.sliding_window)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(params, cfg, x), {"blocks": cache["blocks"],
                                     "pos": pos + 1}


def prefill(params, cfg: ModelConfig, tokens, cache_len: int, *,
            q_block=512, kv_block=512):
    """Process a prompt batch (B, S) and return (last-position logits (B,
    V) f32, cache with room for ``cache_len`` positions, pos = S).  For a
    sliding-window prompt longer than the window the cache keeps the last
    `window` keys at rows 0..W-1, as the JAX package does; a Mamba layer
    keeps its final state (S must be a multiple of the chunk size)."""
    B.check_ported(cfg)
    S = tokens.shape[1]
    x = embed_tokens(params, cfg, tokens)
    angles = None if cfg.attn_free else _angles(cfg, S, x.device)
    states = {}
    for _, name, spec, lp in _walk(params, cfg):
        x, kv, st = B.layer_forward(lp, x, cfg, spec, angles=angles,
                                    return_ssm_state=spec.kind != "A",
                                    q_block=q_block, kv_block=kv_block)
        if spec.kind == "A":
            k, v = kv
            W = cfg.sliding_window
            if W is not None and S > W:
                k, v = k[:, -W:], v[:, -W:]
            st = {"k": k, "v": v}
        for key, t in st.items():
            states.setdefault(name, {}).setdefault(key, []).append(t)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params, cfg, x[:, -1])
    blocks = {name: {key: torch.stack(ts) for key, ts in d.items()}
              for name, d in states.items()}
    return logits, {"blocks": _pad_cache_to(blocks, cfg, cache_len),
                    "pos": S}


def _pad_cache_to(blocks, cfg: ModelConfig, cache_len: int):
    """Grow (or cut) the (n, B, s, Hkv, Dh) K/V caches to the cache's row
    count, zeros after the prompt's rows; Mamba states pass through."""
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
