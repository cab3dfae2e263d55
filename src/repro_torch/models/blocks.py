"""Decoder layers and period specs of the model track (counterpart of
``repro.models.blocks``): attention (``"A"``) and Mamba-2 (``"M"``)
mixers, each followed by a dense MLP or an MoE (with the dense residual
or shared expert as the layer's ``mlp``), and the encoder-decoder's
cross-attention.  In a pattern with ``"E"`` layers (Nemotron-H) every
layer is one block x + f(RMSNorm(x)): a Mamba-2 mixer, attention, or an
MoE with its shared expert, and nothing follows the mixers.

Layers are grouped in "periods": the smallest repeating pattern of layer
kinds and MoE placement.  Params of one period are a dict ``{"layer_0":
{...}, ...}``; the full stack adds a leading period axis to every leaf,
as in the JAX package, and the forward passes take views of it.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.plane import tree_from_paths, tree_paths
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.common import (NO_SHARD, ShardCtx, apply_rope,
                                       dense_init, rms_norm,
                                       rope_frequencies)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: str          # 'A' | 'M' | 'E' (the MoE alone behind ln1)
    use_moe: bool
    has_mlp: bool      # dense MLP present (False for mamba2 pure blocks)


def period_spec(cfg: ModelConfig) -> List[LayerSpec]:
    pat = cfg.layer_pattern
    if "E" in pat:
        return [LayerSpec(kind, kind == "E", False) for kind in pat]
    moe_n = cfg.moe.every_n_layers if cfg.moe else 1
    plen = int(np.lcm(len(pat), moe_n)) if cfg.moe else len(pat)
    specs = []
    for i in range(plen):
        kind = pat[i % len(pat)]
        use_moe = cfg.moe is not None and (i % moe_n == moe_n - 1)
        has_mlp = (cfg.d_ff > 0) and not use_moe
        specs.append(LayerSpec(kind, use_moe, has_mlp))
    return specs


def num_periods(cfg: ModelConfig) -> int:
    plen = len(period_spec(cfg))
    if cfg.num_layers % plen:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers are not a "
                         f"whole number of {plen}-layer periods")
    return cfg.num_layers // plen


# ---------------------------------------------------------------- init ----

def init_attn_params(gen: torch.Generator, cfg: ModelConfig, dtype,
                     cross: bool = False):
    d, Hq, Hkv, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    wo = torch.randn((Hq, Dh, d), generator=gen, device=gen.device)
    p = {
        "wq": dense_init(gen, d, (Hq, Dh), dtype),
        "wk": dense_init(gen, d, (Hkv, Dh), dtype),
        "wv": dense_init(gen, d, (Hkv, Dh), dtype),
        "wo": (wo / float(np.sqrt(Hq * Dh))).to(dtype),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.zeros((Dh,), dtype=dtype, device=gen.device)
        p["k_norm"] = torch.zeros((Dh,), dtype=dtype, device=gen.device)
    return p


def init_mlp_params(gen: torch.Generator, cfg: ModelConfig, dtype):
    d, f = cfg.d_model, cfg.d_ff
    p = {
        "w_in": dense_init(gen, d, (f,), dtype),
        "w_out": dense_init(gen, f, (d,), dtype),
    }
    if cfg.gated_mlp:
        p["w_gate"] = dense_init(gen, d, (f,), dtype)
    return p


def init_layer_params(gen: torch.Generator, cfg: ModelConfig,
                      spec: LayerSpec, dtype):
    d = cfg.d_model
    p = {"ln1": torch.zeros((d,), dtype=dtype, device=gen.device)}
    if spec.kind == "A":
        p["attn"] = init_attn_params(gen, cfg, dtype)
    elif spec.kind == "M":
        p["mamba"] = mamba_lib.init_mamba_params(gen, d, cfg.ssm, dtype)
    if (spec.use_moe and spec.kind != "E") or spec.has_mlp:
        p["ln2"] = torch.zeros((d,), dtype=dtype, device=gen.device)
    if spec.use_moe:
        p["moe"] = moe_lib.init_moe_params(gen, d, cfg.moe, dtype)
    if spec.has_mlp or (spec.use_moe and (cfg.moe.dense_residual
                                          or cfg.moe.shared_expert)):
        p["mlp"] = init_mlp_params(gen, cfg, dtype)
    return p


def init_period_params(gen: torch.Generator, cfg: ModelConfig, dtype):
    return {f"layer_{j}": init_layer_params(gen, cfg, spec, dtype)
            for j, spec in enumerate(period_spec(cfg))}


def stack_trees(trees: list) -> dict:
    """Dict trees of equal structure as one tree with a leading axis of
    len(trees) on every leaf, stacked leaf by leaf, each input leaf freed
    once it is in the stack (the peak is the trees and one stacked leaf
    more).  One tree becomes views, no copy.  Consumes ``trees``."""
    paths = [path for path, _ in tree_paths(trees[0])]
    cols = [[x for _, x in tree_paths(t)] for t in trees]
    trees.clear()
    leaves = []
    for j in range(len(paths)):
        leaves.append(torch.stack([c[j] for c in cols]) if len(cols) > 1
                      else cols[0][j].unsqueeze(0))
        for c in cols:
            c[j] = None
    return tree_from_paths(paths, leaves)


def init_stacked_params(gen: torch.Generator, cfg: ModelConfig, dtype):
    """Period params with a leading ``num_periods`` axis on every leaf,
    the periods drawn one after the other (:func:`stack_trees`)."""
    return stack_trees([init_period_params(gen, cfg, dtype)
                        for _ in range(num_periods(cfg))])


# --------------------------------------------------------------- apply ----

def _proj(x, w):
    """x (..., d) @ w (d, *out) -> (..., *out), in x's dtype."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(
        x.shape[:-1] + w.shape[1:])


def mlp_forward(p, x, cfg: ModelConfig):
    h = x @ p["w_in"]
    if cfg.gated_mlp:
        g = x @ p["w_gate"]
        h = F.silu(g.float()).to(x.dtype) * h
    elif cfg.mlp_act == "relu2":
        h = torch.square(F.relu(h))
    else:   # jax.nn.gelu's default: the tanh approximation
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ p["w_out"]


def _qk_norm(p, q, k, cfg: ModelConfig):
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k


def attn_forward(p, x, cfg: ModelConfig, *, angles, causal=True,
                 kv_override=None, q_block=512, kv_block=512):
    """Full-sequence attention (training, prefill, the encoder, cross-
    attention).  x: (B, S, d); ``kv_override`` (B, S_kv, d): the keys'
    and values' source for cross-attention (no RoPE on its keys);
    ``angles`` None: no RoPE (the encoder-decoder's learned positions).
    The config's sliding window applies to causal attention only.
    Returns (y, (k, v)) with k, v (B, S_kv, Hkv, Dh) after RoPE, as the
    cache holds them."""
    q = _proj(x, p["wq"])
    src = x if kv_override is None else kv_override
    k = _proj(src, p["wk"])
    v = _proj(src, p["wv"])
    q, k = _qk_norm(p, q, k, cfg)
    if angles is not None:
        q = apply_rope(q, angles)
        if kv_override is None:
            k = apply_rope(k, angles)
    out = attn_lib.blocked_attention(
        q, k, v, causal=causal,
        window=cfg.sliding_window if causal else None,
        q_block=q_block, kv_block=kv_block)
    B, S = x.shape[:2]
    y = out.reshape(B, S, -1) @ p["wo"].reshape(-1, cfg.d_model)
    return y, (k, v)


def attn_decode(p, x, cfg: ModelConfig, cache, pos: int, *, window=None,
                ctx: ShardCtx = NO_SHARD):
    """One token per sequence.  x: (B, d); cache: {'k', 'v'} (B, S, Hkv,
    Dh); pos: the token's position, a Python int.  Writes the token's K/V
    into ``cache`` IN PLACE (slot pos % window for a rolling cache of
    ``window`` rows, else pos) and returns y (B, d).  RoPE unless the
    config is an encoder-decoder (learned positions).  Attention over the
    cache runs through ``ops.swa_decode_attention``: the kernel on a CUDA
    tensor, its plain version on a CPU one.

    With ``ctx.seq_shard_decode`` on a mesh, ``cache`` is this rank's
    slice of the sequence axis (``lm.shard_cache``): S counts every
    slice, the slot's owner writes it, and the attention runs
    ``attention.decode_attention_seq_sharded``."""
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    q, k = _qk_norm(p, q, k, cfg)
    if cfg.rope and not cfg.is_encdec:
        angle = rope_frequencies(cfg.head_dim, cfg.rope_theta,
                                 torch.full((1,), pos, device=x.device))
        q = apply_rope(q[:, None], angle)[:, 0]
        k = apply_rope(k[:, None], angle)[:, 0]
    sharded = ctx.seq_shard_decode and ctx.on_mesh
    s_loc = cache["k"].shape[1]
    offset = ctx.shard * s_loc if sharded else 0
    S = s_loc * ctx.shards if sharded else s_loc
    rolling = window is not None and S == window
    slot = pos % window if rolling else pos
    if slot >= S:
        raise ValueError(f"position {pos} does not fit a {S}-row cache")
    if offset <= slot < offset + s_loc:
        cache["k"][:, slot - offset] = k.to(cache["k"].dtype)
        cache["v"][:, slot - offset] = v.to(cache["v"].dtype)
    cache_len = min(pos + 1, S)
    # the JAX package masks positions < cache_len - window; a cache of at
    # most `window` rows (all that init_cache and prefill make) never cuts
    if window is not None and not rolling and window < S:
        raise ValueError(f"a {S}-row cache wider than the {window}-row "
                         "window is not supported (init_cache makes at "
                         "most `window` rows)")
    if sharded:
        out = attn_lib.decode_attention_seq_sharded(
            q, cache["k"], cache["v"], cache_len, ctx=ctx)
    else:
        out = ops.swa_decode_attention(q, cache["k"], cache["v"], cache_len)
    return out.reshape(x.shape[0], -1) @ p["wo"].reshape(-1, cfg.d_model)


def cross_attn_decode(p, x, cfg: ModelConfig, cross_cache):
    """The decoder's cross-attention for one token per sequence against
    the fixed encoder cache {'k', 'v'} (B, S_enc, Hkv, Dh): every
    position valid, through ``ops.swa_decode_attention``."""
    q = _proj(x, p["wq"])
    kc, vc = cross_cache["k"], cross_cache["v"]
    out = ops.swa_decode_attention(q, kc, vc, kc.shape[1])
    return out.reshape(x.shape[0], -1) @ p["wo"].reshape(-1, cfg.d_model)


def _zero_aux(device):
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {"load_balance": zero, "router_z": zero}


def _ffn(params, x, cfg: ModelConfig, spec: LayerSpec, moe_kw):
    """The layer's second half: x + MLP or MoE (+ its dense residual or
    shared expert) of the normed x.  Returns (x, aux), aux None without
    an MoE."""
    aux = None
    if spec.use_moe:
        h = rms_norm(x, params["ln2" if spec.kind != "E" else "ln1"],
                     cfg.norm_eps)
        if cfg.moe.dropless:
            y = moe_lib.dropless_forward(params["moe"], h, cfg.moe)
        else:
            y, aux = moe_lib.moe_forward(params["moe"], h, cfg.moe,
                                         **moe_kw)
        if "mlp" in params:   # arctic dense residual / shared expert
            y = y + mlp_forward(params["mlp"], h, cfg)
        x = x + y
    elif spec.has_mlp:
        h = rms_norm(x, params["ln2"], cfg.norm_eps)
        x = x + mlp_forward(params["mlp"], h, cfg)
    return x, aux


def layer_forward(params, x, cfg: ModelConfig, spec: LayerSpec, *, angles,
                  ssm_state=None, return_ssm_state=False, q_block=512,
                  kv_block=512):
    """Full-sequence layer (training, prefill).  Returns (x, aux, kv,
    state): aux the MoE terms {"load_balance", "router_z"} (zeros without
    an MoE); (k, v) of an attention layer, else None; the Mamba layer's
    final {"h", "conv"} state with ``return_ssm_state``, else None.
    ``ssm_state`` starts a Mamba layer from a carried state."""
    if spec.kind == "E":
        x, aux = _ffn(params, x, cfg, spec, {})
        return x, aux or _zero_aux(x.device), None, None
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    kv = new_state = None
    if spec.kind == "A":
        y, kv = attn_forward(params["attn"], h, cfg, angles=angles,
                             q_block=q_block, kv_block=kv_block)
    elif return_ssm_state:
        y, new_state = mamba_lib.ssd_forward(
            params["mamba"], h, cfg.ssm, init_state=ssm_state,
            return_state=True)
    else:
        y = mamba_lib.ssd_forward(params["mamba"], h, cfg.ssm,
                                  init_state=ssm_state)
    x, aux = _ffn(params, x + y, cfg, spec, {})
    return x, aux or _zero_aux(x.device), kv, new_state


def layer_decode(params, x, cfg: ModelConfig, spec: LayerSpec, cache,
                 pos: int, *, window=None, ctx: ShardCtx = NO_SHARD):
    """Single-token layer step; writes the layer's ``cache`` in place
    ({"k", "v"} of an attention layer, {"h", "conv"} of a Mamba one).  An
    MoE routes the B tokens drop-free: group_size = capacity = min(1024,
    B).  ``ctx``: :func:`attn_decode`'s."""
    gs = min(1024, x.shape[0])
    if spec.kind == "E":
        x, _ = _ffn(params, x[:, None], cfg, spec,
                    {"group_size": gs, "capacity": gs})
        return x[:, 0]
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    if spec.kind == "A":
        y = attn_decode(params["attn"], h, cfg, cache, pos, window=window,
                        ctx=ctx)
    else:
        y, new = mamba_lib.mamba_decode_step(params["mamba"], h, cache,
                                             cfg.ssm)
        for k, t in new.items():
            cache[k].copy_(t)
    x, _ = _ffn(params, (x + y)[:, None], cfg, spec,
                {"group_size": gs, "capacity": gs})
    return x[:, 0]
