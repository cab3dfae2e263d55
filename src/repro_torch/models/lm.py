"""Decoder-only language models assembled from blocks (counterpart of
``repro.models.lm``): init, the forward pass, prefill and the single-token
decode step of the serving path, for configs of attention layers with
dense MLPs (``blocks.check_ported`` names what else is missing).

Parameters keep the JAX package's tree: ``{"embed", "final_norm",
"blocks", "unembed"}`` with every block leaf stacked over periods, and
its einsum layouts (``wq`` (d, Hq, Dh), ``wo`` (Hq, Dh, d), ``unembed``
(d, V)), so :func:`params_from_numpy` carries the JAX parameters across
as a copy.  The decode cache is ``{"blocks": {"layer_j": {"k", "v"}},
"pos": int}`` with (n_periods, B, S, Hkv, Dh) leaves; ``pos`` is a Python
int, so no step reads the device to find its slot.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import require_device
from repro_torch.kernels.plane import tree_map
from repro_torch.models import blocks as B
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


def _walk(params, cfg: ModelConfig):
    """(period index, layer name, spec, layer params) in layer order."""
    specs = B.period_spec(cfg)
    for i in range(B.num_periods(cfg)):
        for j, spec in enumerate(specs):
            lp = tree_map(lambda a: a[i], params["blocks"][f"layer_{j}"])
            yield i, f"layer_{j}", spec, lp


def lm_backbone(params, cfg: ModelConfig, x, *, q_block=512, kv_block=512):
    """The decoder stack on embeddings x (B, S, d), forward only; returns
    the final-normed hidden states (B, S, d)."""
    B.check_ported(cfg)
    angles = _angles(cfg, x.shape[1], x.device)
    for _, _, spec, lp in _walk(params, cfg):
        x, _ = B.layer_forward(lp, x, cfg, spec, angles=angles,
                               q_block=q_block, kv_block=kv_block)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


# ---------------------------------------------------------------- decode ---

def _cache_rows(cfg: ModelConfig, cache_len: int) -> int:
    """Rows of the attention cache: a rolling buffer of min(window,
    cache_len) for sliding-window configs, else cache_len."""
    return cache_len if cfg.sliding_window is None \
        else min(cfg.sliding_window, cache_len)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
               device="cuda"):
    """An empty cache (zeros, pos 0)."""
    B.check_ported(cfg)
    dev = require_device(device)
    shape = (B.num_periods(cfg), batch, _cache_rows(cfg, cache_len),
             cfg.num_kv_heads, cfg.head_dim)
    dtype = _dtype(cfg, dtype)
    blocks = {f"layer_{j}": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                             "v": torch.zeros(shape, dtype=dtype, device=dev)}
              for j in range(len(B.period_spec(cfg)))}
    return {"blocks": blocks, "pos": 0}


def lm_decode_step(params, cfg: ModelConfig, tokens, cache):
    """tokens: (B,) integer, one new token per sequence, on the params'
    device.  Returns (logits (B, V) f32, cache) where the returned cache
    holds the SAME tensors as ``cache``, written in place, and ``pos`` + 1:
    the cache passed in is consumed."""
    pos = cache["pos"]
    x = embed_tokens(params, cfg, tokens)
    for i, name, spec, lp in _walk(params, cfg):
        layer_cache = {kv: t[i] for kv, t in cache["blocks"][name].items()}
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
    `window` keys at rows 0..W-1, as the JAX package does."""
    B.check_ported(cfg)
    S = tokens.shape[1]
    x = embed_tokens(params, cfg, tokens)
    angles = _angles(cfg, S, x.device)
    kvs = {}
    for _, name, spec, lp in _walk(params, cfg):
        x, (k, v) = B.layer_forward(lp, x, cfg, spec, angles=angles,
                                    q_block=q_block, kv_block=kv_block)
        W = cfg.sliding_window
        if W is not None and S > W:
            k, v = k[:, -W:], v[:, -W:]
        kvs.setdefault(name, {"k": [], "v": []})
        kvs[name]["k"].append(k)
        kvs[name]["v"].append(v)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = unembed(params, cfg, x[:, -1])
    blocks = {name: {kv: torch.stack(ts) for kv, ts in d.items()}
              for name, d in kvs.items()}
    return logits, {"blocks": _pad_cache_to(blocks, cfg, cache_len),
                    "pos": S}


def _pad_cache_to(blocks, cfg: ModelConfig, cache_len: int):
    """Grow (or cut) the (n, B, s, Hkv, Dh) K/V caches to the cache's row
    count, zeros after the prompt's rows."""
    target = _cache_rows(cfg, cache_len)

    def pad(x):
        n, b, s, h, d = x.shape
        if s < target:
            out = x.new_zeros((n, b, target, h, d))
            out[:, :, :s] = x
            return out
        return x[:, :, :target].contiguous()

    return tree_map(pad, blocks)
