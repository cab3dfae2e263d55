"""Plain reference of a Moonlight (DeepSeek-V3 layers) language model for
the CPU tests: leading dense layers, then layers of latent attention (MLA)
and the held experts' part of a drop-free sigmoid-routed mixture of
SwiGLU experts plus a shared SwiGLU expert; the final norm, the untied
head, the mean next-token loss, and one CE-FL round (FedProx local steps,
eq.-10 accumulation, eq.-11 aggregation with equal weights and theta =
gamma; the Nemotron-H reference's round with this model's loss).

Plain PyTorch over the program's parameter tree (``lead`` layers
unstacked, a period axis on every ``blocks`` leaf).  It imports neither
the program nor JAX.  MLA is written from DeepSeek-V3's equations with
the full softmax over the sequence; the program runs the blocked online
softmax.  Departures from the published model, shared with the program:
RoPE rotates split halves (DeepSeek-V3's code rotates interleaved pairs,
a fixed permutation of the rope columns), the router's correction bias
is 0, the aux-loss coefficients are 0, norms scale by (1 + w), and the
gate and up matrices of an expert sit side by side in ``w_gate_up``.
``cfg`` is the program's ``ModelConfig``, read for its numbers only.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from nemotron_h_reference import _index, rms
from nemotron_h_reference import cefl_round as _cefl_round


def rope(x, theta):
    """Split-half rotary embedding of x (b, S, h, D) at positions 0..S-1."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    freq = 1.0 / theta ** (torch.arange(half, dtype=torch.float32) / half)
    ang = torch.arange(S, dtype=torch.float32)[:, None] * freq
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def mla(p, h, cfg):
    """Causal latent attention on normed inputs h (b, S, d)."""
    b, S, d = h.shape
    m, H = cfg.mla, cfg.num_heads
    nope, rp, dv, r = m.qk_nope_head_dim, m.qk_rope_head_dim, \
        m.v_head_dim, m.kv_lora_rank
    q = (h @ p["wq"].reshape(d, -1)).reshape(b, S, H, nope + rp)
    c, k_pe = (h @ p["wkv_a"]).split([r, rp], -1)
    c = rms(c, p["kv_norm"], cfg.norm_eps)
    kv = (c @ p["wkv_b"].reshape(r, -1)).reshape(b, S, H, nope + dv)
    k_nope, v = kv.split([nope, dv], -1)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], cfg.rope_theta)], -1)
    k_pe = rope(k_pe[:, :, None], cfg.rope_theta).expand(b, S, H, rp)
    k = torch.cat([k_nope, k_pe], -1)
    s = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(nope + rp)
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -torch.inf)
    out = torch.einsum("bhst,bthd->bshd", torch.softmax(s, -1), v)
    return out.reshape(b, S, H * dv) @ p["wo"].reshape(H * dv, d)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def mlp(p, x):
    return swiglu(x, p["w_gate"], p["w_in"], p["w_out"])


def experts(p, x, cfg, offset=None, held=None):
    """The routed part of an MoE layer over tokens x (T, d): experts
    offset .. offset + held - 1 of the router's, sigmoid top-k, gates
    normalised over the k and scaled, each expert on its tokens by a
    boolean gather."""
    m = cfg.moe
    offset = m.expert_offset if offset is None else offset
    held = m.held if held is None else held
    f = m.expert_ff
    scores = torch.sigmoid(x @ p["router"])
    top, ids = torch.topk(scores, m.top_k, dim=-1)
    gates = top / (top.sum(-1, keepdim=True) + 1e-20) * m.routed_scale
    y = torch.zeros_like(x)
    for e in range(held):
        pick = ids == offset + e
        tok = pick.any(-1)
        gate = (gates * pick).sum(-1)[tok]
        wgu = p["w_gate_up"][e]
        out = swiglu(x[tok], wgu[:, :f], wgu[:, f:], p["w_out"][e])
        y = y.index_add(0, torch.nonzero(tok)[:, 0], out * gate[:, None])
    return y


def moe_layer(lp, h, cfg):
    b, S, d = h.shape
    x = h.reshape(b * S, d)
    return (experts(lp["moe"], x, cfg) + mlp(lp["mlp"], x)).reshape(b, S, d)


def _layer(lp, x, cfg, dense):
    x = x + mla(lp["attn"], rms(x, lp["ln1"], cfg.norm_eps), cfg)
    h = rms(x, lp["ln2"], cfg.norm_eps)
    return x + (mlp(lp["mlp"], h) if dense else moe_layer(lp, h, cfg))


def logits(params, tokens, cfg):
    x = params["embed"][tokens.long()]
    for i in range(cfg.first_dense):
        x = _layer(params["lead"][f"layer_{i}"], x, cfg, dense=True)
    for i in range(params["blocks"]["layer_0"]["ln1"].shape[0]):
        x = _layer(_index(params["blocks"]["layer_0"], i), x, cfg,
                   dense=False)
    return rms(x, params["final_norm"], cfg.norm_eps) @ params["unembed"]


def loss(params, batch, cfg):
    lg = logits(params, batch["tokens"], cfg)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           batch["labels"].reshape(-1).long())


def cefl_round(p0, batch, cfg, *, gamma, eta, mu):
    """One CE-FL round of this model (``nemotron_h_reference.cefl_round``
    with this file's loss)."""
    return _cefl_round(p0, batch, cfg, gamma=gamma, eta=eta, mu=mu,
                       loss=loss)
