"""Plain reference of a Nemotron-H language model for the CPU tests: the
blocks x + f(RMSNorm(x)), f a Mamba-2 mixer with grouped B and C ('M'),
the held experts' part of a drop-free sigmoid-routed mixture of relu²
experts plus a shared expert ('E'), or causal GQA without positions
('A'); the final norm, the untied head, the mean next-token loss, and one
CE-FL round (FedProx local steps, eq.-10 accumulation, eq.-11
aggregation with equal weights and theta = gamma).

Plain PyTorch over the program's parameter tree (a period axis on every
block leaf).  It imports neither the program nor JAX.  The SSD is the
quadratic (masked attention) form over the whole sequence; the program
runs the chunked scan.  Departures from the published model, shared with
the program: the router's correction bias is 0, the aux-loss
coefficients are 0, and norms scale by (1 + w).  ``cfg`` is the
program's ``ModelConfig``, read for its numbers only.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1 + w)


def segsum(a):
    """a (..., S) -> (..., S, S): sum of a[j+1..t] at [t, j], -inf above
    the diagonal."""
    S = a.shape[-1]
    cs = torch.cumsum(a, -1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones(S, S, dtype=torch.bool, device=a.device).tril()
    return out.masked_fill(~mask, -torch.inf)


def mamba_mixer(p, h, cfg):
    b, S, _ = h.shape
    s = cfg.ssm
    H, P, G, N = s.num_heads or s.expand * cfg.d_model // s.head_dim, \
        s.head_dim, s.n_groups, s.state_dim
    d_inner = H * P
    z, xBC, dt = (h @ p["w_in"]).split([d_inner, d_inner + 2 * G * N, H],
                                       dim=-1)
    W = p["conv_w"].shape[0]
    xBC = F.conv1d(xBC.transpose(1, 2), p["conv_w"].T.unsqueeze(1),
                   p["conv_b"], padding=W - 1, groups=xBC.shape[-1])
    xBC = F.silu(xBC[..., :S].transpose(1, 2))
    x, Bm, Cm = xBC.split([d_inner, G * N, G * N], dim=-1)
    x = x.reshape(b, S, H, P)
    group = torch.arange(H) * G // H
    Bh = Bm.reshape(b, S, G, N)[:, :, group]
    Ch = Cm.reshape(b, S, G, N)[:, :, group]
    dt = F.softplus(dt + p["dt_bias"])
    a = (dt * -torch.exp(p["a_log"])).transpose(1, 2)         # (b, H, S)
    M = torch.einsum("bthn,bjhn->bhtj", Ch, Bh) * torch.exp(segsum(a)) \
        * dt.transpose(1, 2)[:, :, None, :]
    y = torch.einsum("bhtj,bjhp->bthp", M, x) + p["d_skip"][:, None] * x
    y = y.reshape(b, S, d_inner) * F.silu(z)
    yg = y.reshape(b, S, G, d_inner // G)
    y = (yg * torch.rsqrt(yg.pow(2).mean(-1, keepdim=True) + 1e-5)) \
        .reshape(b, S, d_inner) * (1 + p["norm"])
    return y @ p["w_out"]


def attention(p, h, cfg):
    b, S, d = h.shape
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (h @ p["wq"].reshape(d, -1)).reshape(b, S, Hq, D).transpose(1, 2)
    k = (h @ p["wk"].reshape(d, -1)).reshape(b, S, Hkv, D).transpose(1, 2)
    v = (h @ p["wv"].reshape(d, -1)).reshape(b, S, Hkv, D).transpose(1, 2)
    k = k.repeat_interleave(Hq // Hkv, dim=1)
    v = v.repeat_interleave(Hq // Hkv, dim=1)
    s = (q @ k.transpose(-1, -2)) / math.sqrt(D)
    s = s.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(), -torch.inf)
    out = torch.softmax(s, -1) @ v
    return out.transpose(1, 2).reshape(b, S, Hq * D) \
        @ p["wo"].reshape(Hq * D, d)


def experts(p, x, cfg, offset=None, held=None):
    """The routed part of an 'E' layer over tokens x (T, d): experts
    offset .. offset + held - 1 of the router's (p["w_in"][e - offset]),
    sigmoid top-k, gates normalised over the k and scaled."""
    m = cfg.moe
    offset = m.expert_offset if offset is None else offset
    held = m.held if held is None else held
    scores = torch.sigmoid(x @ p["router"])
    top, ids = torch.topk(scores, m.top_k, dim=-1)
    gates = top / (top.sum(-1, keepdim=True) + 1e-20) * m.routed_scale
    y = torch.zeros_like(x)
    for e in range(held):
        tok, slot = torch.nonzero(ids == offset + e, as_tuple=True)
        out = torch.relu(x[tok] @ p["w_in"][e]).square() @ p["w_out"][e]
        y = y.index_add(0, tok, out * gates[tok, slot][:, None])
    return y


def moe_layer(lp, h, cfg):
    b, S, d = h.shape
    x = h.reshape(b * S, d)
    shared = torch.relu(x @ lp["mlp"]["w_in"]).square() @ lp["mlp"]["w_out"]
    return (experts(lp["moe"], x, cfg) + shared).reshape(b, S, d)


def logits(params, tokens, cfg):
    x = params["embed"][tokens.long()]
    n_periods = params["blocks"]["layer_0"]["ln1"].shape[0]
    for i in range(n_periods):
        for j, kind in enumerate(cfg.layer_pattern):
            lp = _index(params["blocks"][f"layer_{j}"], i)
            h = rms(x, lp["ln1"], cfg.norm_eps)
            if kind == "M":
                x = x + mamba_mixer(lp["mamba"], h, cfg)
            elif kind == "A":
                x = x + attention(lp["attn"], h, cfg)
            else:
                x = x + moe_layer(lp, h, cfg)
    return rms(x, params["final_norm"], cfg.norm_eps) @ params["unembed"]


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def loss(params, batch, cfg):
    lg = logits(params, batch["tokens"], cfg)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           batch["labels"].reshape(-1).long())


def leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from leaves(tree[k], f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", tree[k]


def rebuild(names, values):
    out = {}
    for n, v in zip(names, values):
        node = out
        *path, last = n.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def cefl_round(p0, batch, cfg, *, gamma, eta, mu):
    """One CE-FL round over the n DPUs of ``batch`` (leaves (n, 1, mb,
    S)), every DPU running gamma steps; returns (the new model, the DPU
    mean of the last step's loss)."""
    names, base = zip(*leaves(p0))
    n = batch["tokens"].shape[0]
    r = 1.0 - eta * mu
    a = [r ** (gamma - 1 - k) for k in range(gamma)]
    agg = [torch.zeros_like(v) for v in base]
    last = []
    for i in range(n):
        b = {k: v[i, 0] for k, v in batch.items()}
        p = list(base)
        acc = [torch.zeros_like(v) for v in base]
        for k in range(gamma):
            ps = [v.detach().requires_grad_(True) for v in p]
            with torch.enable_grad():
                lv = loss(rebuild(names, ps), b, cfg)
                g = torch.autograd.grad(lv, ps)
            acc = [c + a[k] * x for c, x in zip(acc, g)]
            p = [v - eta * (x + mu * (v - b0))
                 for v, x, b0 in zip(p, g, base)]
        last.append(float(lv.detach()))
        agg = [s + c / (sum(a) * n) for s, c in zip(agg, acc)]
    return rebuild(names, [b0 - gamma * eta * s
                           for b0, s in zip(base, agg)]), sum(last) / n
