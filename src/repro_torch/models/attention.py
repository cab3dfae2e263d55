"""Attention of the model track (counterpart of ``repro.models.attention``):
blocked causal / sliding-window / bidirectional attention for training,
prefill, the encoder and cross-attention, with the flash backward, and
the plain single-token decode.  The decode step of the serving path runs
the ``swa_decode_attention`` kernel instead (``kernels/ops.py``).

All softmax statistics are kept in float32 whatever the activation dtype.
The sequence-sharded decode (``decode_attention_seq_sharded``) combines
the partial softmaxes of the ranks that hold the slices of a cache.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models.common import ShardCtx, matmul_f32
from repro_torch.sharding.mesh import all_reduce

NEG_INF = -1e30


def _fit(n: int, b: int) -> int:
    """The largest block size <= b that divides n."""
    b = min(b, n)
    while n % b:
        b -= 1
    return b


def _scale(D: int) -> float:
    """1/sqrt(D) rounded to float32, as the JAX package computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(D)))


def _masked(qs: int, qb: int, ks: int, kb: int, causal: bool,
            window: Optional[int]) -> bool:
    """Whether the masks cover the (q rows qs.., kv rows ks..) tile
    entirely."""
    if causal and ks >= qs + qb:
        return True
    return window is not None and qs - (ks + kb - 1) >= window


def _tile_scores(qq, k, ks, kb, qpos, pos, causal, window, scale):
    """Masked f32 scores of one tile: qq (B*Hkv, G*qb, D) against the kv
    rows ks..ks+kb of k (B, S_kv, Hkv, D); returns (B, Hkv, G, qb, kb)."""
    B, _, Hkv, D = k.shape
    kk = k[:, ks:ks + kb].permute(0, 2, 3, 1).reshape(B * Hkv, D, kb)
    s = matmul_f32(qq, kk).view(B, Hkv, -1, qpos.numel(), kb) * scale
    kpos = pos[ks:ks + kb]
    if causal or window is not None:
        mask = torch.ones((qpos.numel(), kb), dtype=torch.bool,
                          device=s.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= qpos[:, None] - kpos[None, :] < window
        s = torch.where(mask, s, NEG_INF)
    return s


def _q_tile(q5, qs, qb):
    """(B, qb, Hkv, G, D) rows qs.. of q5 as (B*Hkv, G*qb, D)."""
    B, _, Hkv, G, D = q5.shape
    return q5[:, qs:qs + qb].permute(0, 2, 3, 1, 4).reshape(B * Hkv,
                                                           G * qb, D)


def _blocked_attention_fwd_only(q, k, v, *, causal=True, window=None,
                                q_block=512, kv_block=512):
    """Online-softmax attention over (q_block x kv_block) tiles.  Returns
    (out (B, S, Hq, Dv) in q's dtype, lse (B, Hkv, G, S) f32), Dv v's
    head dim (latent attention's differs from q's and k's D; the scale is
    1/sqrt(D)).

    Scores q.k are summed in f32 (bf16 operands multiplied exactly), p.v
    in f32.  A tile that the masks cover entirely is skipped: the JAX
    package runs it and adds exp(-1e30 - m) = 0 (or, before a row's first
    valid key, terms that the next valid tile scales by exp(-1e30 - m) =
    0), so the result is the same."""
    B, S, Hq, D = q.shape
    S_kv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hkv
    qb, kb = _fit(S, q_block), _fit(S_kv, kv_block)
    scale = _scale(D)
    dev = q.device
    out = torch.empty((B, S, Hkv, G, Dv), dtype=torch.float32, device=dev)
    lse = torch.empty((B, Hkv, G, S), dtype=torch.float32, device=dev)
    q5 = q.reshape(B, S, Hkv, G, D)
    pos = torch.arange(max(S, S_kv), device=dev)
    for qs in range(0, S, qb):
        qq = _q_tile(q5, qs, qb)
        qpos = pos[qs:qs + qb]
        acc = torch.zeros((B, Hkv, G, qb, Dv), dtype=torch.float32,
                          device=dev)
        m = torch.full((B, Hkv, G, qb), NEG_INF, dtype=torch.float32,
                       device=dev)
        lsum = torch.zeros((B, Hkv, G, qb), dtype=torch.float32, device=dev)
        for ks in range(0, S_kv, kb):
            if _masked(qs, qb, ks, kb, causal, window):
                continue
            vv = v[:, ks:ks + kb].permute(0, 2, 1, 3).reshape(B * Hkv, kb,
                                                              Dv)
            s = _tile_scores(qq, k, ks, kb, qpos, pos, causal, window, scale)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + torch.sum(p, dim=-1)
            pv = torch.bmm(p.view(B * Hkv, G * qb, kb), vv.float())
            acc = acc * corr[..., None] + pv.view(B, Hkv, G, qb, Dv)
            m = m_new
        blk = acc / torch.clamp(lsum[..., None], min=1e-30)
        out[:, qs:qs + qb] = blk.permute(0, 3, 1, 2, 4)
        lse[..., qs:qs + qb] = m + torch.log(torch.clamp(lsum, min=1e-30))
    return out.reshape(B, S, Hq, Dv).to(q.dtype), lse


def _flash_bwd(q, k, v, out, lse, dout, causal, window, q_block, kv_block):
    """The FlashAttention-2 backward of the JAX package's ``_flash_bwd``:
    per (kv block, q block) tile, p = exp(s - lse) recomputed, delta =
    rowsum(dout * out) in f32; dq accumulated over kv blocks, dk / dv over
    q blocks and over the G query heads of each KV head, in f32, each cast
    to its input's dtype.  Tiles that the masks cover entirely are skipped
    (the JAX package adds exact zeros there).  v's head dim may differ
    from q's and k's (latent attention)."""
    B, S, Hq, D = q.shape
    S_kv, Hkv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hkv
    qb, kb = _fit(S, q_block), _fit(S_kv, kv_block)
    scale = _scale(D)
    dev = q.device
    f32 = torch.float32
    q5 = q.reshape(B, S, Hkv, G, D)
    do5 = dout.reshape(B, S, Hkv, G, Dv)
    # delta_i = rowsum(dout * out): (B, Hkv, G, S)
    delta = torch.einsum("bskgd,bskgd->bkgs", do5.to(f32),
                         out.reshape(B, S, Hkv, G, Dv).to(f32))
    pos = torch.arange(max(S, S_kv), device=dev)
    dq = torch.zeros((B * Hkv, S // qb, G * qb, D), dtype=f32, device=dev)
    dk = torch.empty((B, S_kv, Hkv, D), dtype=f32, device=dev)
    dv = torch.empty((B, S_kv, Hkv, Dv), dtype=f32, device=dev)
    for ks in range(0, S_kv, kb):
        kk = k[:, ks:ks + kb].permute(0, 2, 1, 3).reshape(B * Hkv, kb, D)
        vv = v[:, ks:ks + kb].permute(0, 2, 1, 3).reshape(B * Hkv, kb, Dv)
        kk, vv = kk.to(f32), vv.to(f32)
        dk_j = torch.zeros((B * Hkv, kb, D), dtype=f32, device=dev)
        dv_j = torch.zeros((B * Hkv, kb, Dv), dtype=f32, device=dev)
        for i, qs in enumerate(range(0, S, qb)):
            if _masked(qs, qb, ks, kb, causal, window):
                continue
            qq = _q_tile(q5, qs, qb)
            s = _tile_scores(qq, k, ks, kb, pos[qs:qs + qb], pos, causal,
                             window, scale)
            p = torch.exp(s - lse[..., qs:qs + qb, None])  # (B,Hkv,G,qb,kb)
            p = p.view(B * Hkv, G * qb, kb)
            do = _q_tile(do5, qs, qb).to(f32)             # (B*Hkv,G*qb,Dv)
            dv_j += torch.bmm(p.transpose(1, 2), do)
            dp = torch.bmm(do, vv.transpose(1, 2))
            dlt = delta[..., qs:qs + qb].reshape(B * Hkv, G * qb, 1)
            ds = p * (dp - dlt) * scale
            dq[:, i] += torch.bmm(ds, kk)
            dk_j += torch.bmm(ds.transpose(1, 2), qq.to(f32))
        dk[:, ks:ks + kb] = dk_j.view(B, Hkv, kb, D).transpose(1, 2)
        dv[:, ks:ks + kb] = dv_j.view(B, Hkv, kb, Dv).transpose(1, 2)
    # (B*Hkv, nq, G*qb, D) -> (B, S, Hq, D)
    dq = dq.view(B, Hkv, S // qb, G, qb, D).permute(0, 2, 4, 1, 3, 5)
    return (dq.reshape(B, S, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """Blocked attention whose backward recomputes the probabilities per
    tile: the forward saves only q, k, v, out and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_block, kv_block):
        out, lse = _blocked_attention_fwd_only(
            q, k, v, causal=causal, window=window, q_block=q_block,
            kv_block=kv_block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocks = (causal, window, q_block, kv_block)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, dout.contiguous(),
                                *ctx.blocks)
        return dq, dk, dv, None, None, None, None


def blocked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None,
                      q_block: int = 512, kv_block: int = 512):
    """Memory-O(S * block) attention with online softmax.

    q, k: (B, S, Hq, D), (B, S_kv, Hkv, D); v: (B, S_kv, Hkv, Dv).
    Returns (B, S, Hq, Dv) in q's dtype, the scores scaled by
    1/sqrt(D).  ``causal``: mask keys after the query (the decoder); off
    for the encoder and cross-attention.  ``window``: keys with q_pos -
    k_pos >= window are masked.  Under autograd the backward is the flash
    backward (:func:`_flash_bwd`), which keeps only q, k, v, out and the
    f32 log-sum-exp; without it no graph is recorded."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, q_block,
                                     kv_block)
    return _blocked_attention_fwd_only(q, k, v, causal=causal, window=window,
                                       q_block=q_block, kv_block=kv_block)[0]


def decode_attention_plain(q, k_cache, v_cache, cache_len, *,
                           window: Optional[int] = None):
    """Single-token decode.  q: (B, Hq, D); caches: (B, S, Hkv, D);
    cache_len: an int or a (B,) tensor, the number of valid positions
    (the new token's position is cache_len - 1 after insertion).
    ``window`` also masks positions < cache_len - window.  Returns
    (B, Hq, D)."""
    B, S, Hkv, D = k_cache.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * _scale(D)
    pos = torch.arange(S, device=q.device)
    clen = torch.as_tensor(cache_len, device=q.device)
    clen = clen[:, None] if clen.dim() == 1 else clen[None]
    valid = pos[None, :] < clen
    if window is not None:
        valid &= pos[None, :] >= clen - window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    lsum = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p / torch.clamp(lsum, min=1e-30),
                       v_cache.float())
    return out.reshape(B, Hq, D).to(q.dtype)


def decode_attention_seq_sharded(q, k_cache, v_cache, cache_len, *,
                                 ctx: ShardCtx,
                                 window: Optional[int] = None):
    """Single-token decode over a cache whose sequence axis is split over
    ``ctx.mesh``: this rank holds positions ``[k * s, (k + 1) * s)`` of
    each (B, S, Hkv, D) cache as its (B, s, Hkv, D) ``k_cache`` /
    ``v_cache``, k = ``ctx.shard``.  Each rank computes the safe-softmax
    partial (m, l, o) over its slice at its global offset; ``all_reduce``
    MAX combines m, then SUM combines l and o.  q (B, Hq, D) and
    ``cache_len`` (an int or a (B,) tensor) are the same on every rank,
    and so is the returned (B, Hq, D).

    Plain torch in float32, as the reference computes it (``jnp`` inside
    ``shard_map``, no Pallas kernel); the single-device decode keeps the
    ``swa_decode_attention`` kernel."""
    B, s_loc, Hkv, D = k_cache.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * _scale(D)
    pos = ctx.shard * s_loc + torch.arange(s_loc, device=q.device)
    clen = torch.as_tensor(cache_len, device=q.device)
    clen = clen[:, None] if clen.dim() == 1 else clen[None]
    valid = pos[None, :] < clen
    if window is not None:
        valid &= pos[None, :] >= clen - window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = all_reduce(torch.amax(s, dim=-1), ctx.mesh, op="max", axis="cache")
    p = torch.exp(s - m[..., None])
    lsum = all_reduce(torch.sum(p, dim=-1), ctx.mesh, op="sum",
                      axis="cache")
    o = all_reduce(torch.einsum("bkgs,bskd->bkgd", p, v_cache.float()),
                   ctx.mesh, op="sum", axis="cache")
    out = o / torch.clamp(lsum[..., None], min=1e-30)
    return out.reshape(B, Hq, D).to(q.dtype)
