"""Attention of the model track (counterpart of ``repro.models.attention``):
blocked causal / sliding-window attention for prefill (forward only), and
the plain single-token decode.  The decode step of the serving path runs
the ``swa_decode_attention`` kernel instead (``kernels/ops.py``).

All softmax statistics are kept in float32 whatever the activation dtype.
The flash backward (training) and the sequence-sharded decode are not
ported yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models.common import matmul_f32

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


def blocked_attention(q, k, v, *, window: Optional[int] = None,
                      q_block: int = 512, kv_block: int = 512):
    """Causal online-softmax attention over (q_block x kv_block) tiles,
    forward only (``_blocked_attention_fwd_only`` of the JAX package; its
    bidirectional form serves the encoder, which is not ported yet).

    q: (B, S, Hq, D); k, v: (B, S_kv, Hkv, D).  Returns (B, S, Hq, D) in
    q's dtype.  ``window``: keys with q_pos - k_pos >= window are masked.
    Scores q.k are summed in f32 (bf16 operands multiplied exactly), p.v
    in f32.  A tile that the masks cover entirely is skipped: the JAX
    package runs it and adds exp(-1e30 - m) = 0 (or, before a row's first
    valid key, terms that the next valid tile scales by exp(-1e30 - m) =
    0), so the result is the same.
    """
    B, S, Hq, D = q.shape
    S_kv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qb, kb = _fit(S, q_block), _fit(S_kv, kv_block)
    scale = _scale(D)
    out = torch.empty((B, S, Hkv, G, D), dtype=torch.float32,
                      device=q.device)
    q5 = q.reshape(B, S, Hkv, G, D)
    pos = torch.arange(max(S, S_kv), device=q.device)
    for qs in range(0, S, qb):
        # (B, qb, Hkv, G, D) -> (B*Hkv, G*qb, D)
        qq = q5[:, qs:qs + qb].permute(0, 2, 3, 1, 4).reshape(
            B * Hkv, G * qb, D)
        qpos = pos[qs:qs + qb]
        acc = torch.zeros((B, Hkv, G, qb, D), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, Hkv, G, qb), NEG_INF, dtype=torch.float32,
                       device=q.device)
        lsum = torch.zeros((B, Hkv, G, qb), dtype=torch.float32,
                           device=q.device)
        for ks in range(0, S_kv, kb):
            if ks >= qs + qb or (window is not None
                                 and qs - (ks + kb - 1) >= window):
                continue   # the causal or the window mask covers the tile
            kk = k[:, ks:ks + kb].permute(0, 2, 3, 1).reshape(B * Hkv, D, kb)
            vv = v[:, ks:ks + kb].permute(0, 2, 1, 3).reshape(B * Hkv, kb, D)
            s = matmul_f32(qq, kk).view(B, Hkv, G, qb, kb) * scale
            kpos = pos[ks:ks + kb]
            mask = qpos[:, None] >= kpos[None, :]
            if window is not None:
                mask &= qpos[:, None] - kpos[None, :] < window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + torch.sum(p, dim=-1)
            pv = torch.bmm(p.view(B * Hkv, G * qb, kb), vv.float())
            acc = acc * corr[..., None] + pv.view(B, Hkv, G, qb, D)
            m = m_new
        blk = acc / torch.clamp(lsum[..., None], min=1e-30)
        out[:, qs:qs + qb] = blk.permute(0, 3, 1, 2, 4)
    return out.reshape(B, S, Hq, D).to(q.dtype)


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
