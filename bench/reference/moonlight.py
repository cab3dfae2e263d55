"""Plain reference of CE-FL training of a Moonlight-16B-A3B language model
(DeepSeek-V3's layers): the leading dense layers (latent attention and a
SwiGLU MLP), then layers of latent attention (MLA) and the held experts'
part of a drop-free sigmoid-routed mixture of SwiGLU experts with the
shared experts as one SwiGLU MLP; the final norm, the untied head, the
mean next-token loss, its gradient by autograd, FedProx local steps with
the eq.-10 accumulation and the eq.-11 aggregation over the DPU replicas
(as ``mamba2.cefl_round``).

Plain PyTorch, float32; the caller sets TF32 off.  It imports neither the
program nor JAX.  The model is the chip's share of an expert- and
vocabulary-parallel deployment, as the program's: the router scores all
``router_experts`` experts and only the ``n_routed_experts`` held ones
(ids ``expert_offset`` onwards) are computed, each on its tokens by a
boolean gather; the vocabulary is the slice.

MLA without a query LoRA, from DeepSeek-V3's equations: q = h W_q split
per head into q_nope and q_pe; [c, k_pe] = h W_kva, c RMS-normed;
[k_nope, v] = c W_kvb per head; RoPE on q_pe and on the one k_pe every
head shares; softmax(q k^T / sqrt(nope + rope)) v with the causal mask,
then W_o.  The softmax is the full one, computed for ``attn_block``
query positions at a time against the keys up to them, each block under
``torch.utils.checkpoint`` so that 8,192 positions fit.

Departures from the published model, each shared with the program:
- RoPE rotates split halves; DeepSeek-V3's code rotates interleaved
  pairs (with random weights, a fixed permutation of the rope columns);
- the router's correction bias is held at 0 (its aux-free update is not
  part of the round), and the aux-loss coefficients are 0;
- norms scale by (1 + w), the program's parametrisation;
- what the absent experts would add is left out (the chip's share).

Routing follows the program's choice on near-ties, as
``nemotron_h.route`` does (its ``TIE``, counted in ``stats``).

Planted faults (``fault``), for the limits: ``scale`` (scores over
sqrt(qk_nope_head_dim) = sqrt(128), not sqrt(192)), ``rope_nope`` (RoPE
also on k_nope), ``no_kv_norm`` (the latent left unnormed), ``relu2``
(relu² in place of silu in the routed experts) and ``no_scale`` (gates
without the routed scale).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.mamba2 import _leaves, _rebuild
from bench.reference.nemotron_h import _index, _rms, route

FAULTS = ("scale", "rope_nope", "no_kv_norm", "relu2", "no_scale")


def rope(x, theta):
    """Split-half rotary embedding of x (b, S, h, D) at positions
    0..S-1."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    freq = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freq
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attn_block(q, k, v, s0, scale):
    """Query positions s0.. (q (b, h, L, D)) against keys 0..s0+L-1."""
    L = q.shape[2]
    s = (q @ k.transpose(-1, -2)) * scale                 # (b, h, L, s0+L)
    qpos = torch.arange(s0, s0 + L, device=q.device)[:, None]
    kpos = torch.arange(s0 + L, device=q.device)[None, :]
    s = s.masked_fill(kpos > qpos, -torch.inf)
    return torch.softmax(s, dim=-1) @ v


def mla(p: dict, h, m: dict, fault=None):
    """Causal latent attention on normed inputs h (b, S, d)."""
    b, S, d = h.shape
    H = m["num_attention_heads"]
    nope, rp, dv, r = m["qk_nope_head_dim"], m["qk_rope_head_dim"], \
        m["v_head_dim"], m["kv_lora_rank"]
    theta = float(m["rope_theta"])
    q = (h @ p["wq"].reshape(d, -1)).reshape(b, S, H, nope + rp)
    c, k_pe = (h @ p["wkv_a"]).split([r, rp], -1)
    if fault != "no_kv_norm":
        c = _rms(c, p["kv_norm"], m["rms_norm_eps"])
    kv = (c @ p["wkv_b"].reshape(r, -1)).reshape(b, S, H, nope + dv)
    k_nope, v = kv.split([nope, dv], -1)
    if fault == "rope_nope":
        k_nope = rope(k_nope, theta)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], -1)
    k = torch.cat([k_nope, rope(k_pe[:, :, None], theta)
                   .expand(b, S, H, rp)], -1)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))       # (b, H, S, .)
    scale = 1.0 / math.sqrt(nope if fault == "scale" else nope + rp)
    L = min(m.get("attn_block", S), S)
    outs = []
    for s0 in range(0, S, L):
        args = (q[:, :, s0:s0 + L], k[:, :, :s0 + L], v[:, :, :s0 + L], s0,
                scale)
        outs.append(checkpoint(_attn_block, *args, use_reentrant=False)
                    if torch.is_grad_enabled() else _attn_block(*args))
    out = torch.cat(outs, dim=2).transpose(1, 2)           # (b, S, H, dv)
    return out.reshape(b, S, H * dv) @ p["wo"].reshape(H * dv, d)


def swiglu(x, w_gate, w_up, w_down, act=F.silu):
    return (act(x @ w_gate) * (x @ w_up)) @ w_down


def _relu2(x):
    return torch.relu(x).square()


def moe(p: dict, h, m: dict, program_ids=None, fault=None, stats=None):
    """The held experts' part of the routed layer plus the shared experts,
    on normed inputs h (b, S, d)."""
    b, S, d = h.shape
    x = h.reshape(b * S, d)
    ids, gates = route(p["moe"]["router"], x, m, program_ids, fault, stats)
    f = m["moe_intermediate_size"]
    act = _relu2 if fault == "relu2" else F.silu
    y = torch.zeros_like(x)
    off, held = m["expert_offset"], m["n_routed_experts"]
    for e in range(held):
        pick = ids == off + e
        tok = pick.any(-1)
        if not bool(tok.any()):
            continue
        gate = (gates * pick).sum(-1)[tok]
        wgu = p["moe"]["w_gate_up"][e]
        out = swiglu(x[tok], wgu[:, :f], wgu[:, f:], p["moe"]["w_out"][e],
                     act)
        y = y.index_add(0, torch.nonzero(tok)[:, 0], out * gate[:, None])
    mp = p["mlp"]
    shared = swiglu(x, mp["w_gate"], mp["w_in"], mp["w_out"])
    return (y + shared).reshape(b, S, d)


def nll_sum(params: dict, tokens, labels, m: dict, routes=None, fault=None,
            stats=None):
    """Summed next-token negative log-likelihood of rows (b, S).
    ``routes``: the program's choices, one (b * S, k) tensor per MoE layer
    in order, or None."""
    eps = m["rms_norm_eps"]
    x = params["embed"][tokens.long()]
    routes = iter(routes or [])
    layers = [(params["lead"][f"layer_{i}"], True)
              for i in range(m["first_k_dense_replace"])]
    stack = params["blocks"]["layer_0"]
    layers += [(_index(stack, i), False)
               for i in range(stack["ln1"].shape[0])]
    for lp, dense in layers:
        x = x + mla(lp["attn"], _rms(x, lp["ln1"], eps), m, fault)
        h = _rms(x, lp["ln2"], eps)
        if dense:
            mp = lp["mlp"]
            x = x + swiglu(h, mp["w_gate"], mp["w_in"], mp["w_out"])
        else:
            x = x + moe(lp, h, m, next(routes, None), fault, stats)
    x = _rms(x, params["final_norm"], eps)
    logits = x @ params["unembed"]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long(), reduction="sum")


def loss_and_grad(params: dict, tokens, labels, m: dict, rows: int,
                  routes=None, fault=None, stats=None):
    """Mean next-token loss over rows (b, S) and its gradient, the rows
    taken ``rows`` at a time.  ``routes``: the program's choices for all
    the rows, one (b * S, k) tensor per MoE layer."""
    names, values = zip(*_leaves(params))
    leaves = [v.detach().requires_grad_(True) for v in values]
    tree = _rebuild(names, leaves)
    total = float(tokens.numel())
    S = tokens.shape[1]
    loss, grads = 0.0, [torch.zeros_like(v) for v in values]
    for r in range(0, tokens.shape[0], rows):
        part_routes = None if routes is None else \
            [t[r * S:(r + rows) * S] for t in routes]
        with torch.enable_grad():
            part = nll_sum(tree, tokens[r:r + rows], labels[r:r + rows], m,
                           part_routes, fault, stats) / total
            # a planted fault may leave a leaf unused (no_kv_norm)
            gs = torch.autograd.grad(part, leaves, allow_unused=True)
        loss += float(part.detach())
        grads = [a if g is None else a + g for a, g in zip(grads, gs)]
        del part, gs
    return loss, _rebuild(names, grads)


def cefl_round(p0: dict, batch: dict, m: dict, *, gamma: int, eta: float,
               mu: float, rows: int, batch_keep: float = 1.0, routes=None,
               fault=None, stats=None):
    """One CE-FL round over n DPUs, as ``nemotron_h.cefl_round``:
    ``routes[k][i]`` the MoE layers' choices of local step k on DPU i
    (None: the reference's own).  ``batch_keep`` < 1 keeps the leading
    share of each DPU's rows, or of its one row's positions."""
    names, base = zip(*_leaves(p0))
    n = batch["tokens"].shape[0]
    r = 1.0 - eta * mu
    a = [r ** (gamma - 1 - k) for k in range(gamma)]
    agg = [torch.zeros_like(v) for v in base]
    last = []
    for i in range(n):
        tok, lab = batch["tokens"][i, 0], batch["labels"][i, 0]
        if tok.shape[0] > 1:
            keep = max(1, int(tok.shape[0] * batch_keep))
            tok, lab = tok[:keep], lab[:keep]
        elif batch_keep < 1.0:
            keep = int(tok.shape[1] * batch_keep)
            tok, lab = tok[:, :keep], lab[:, :keep]
        p = list(base)
        acc = [torch.zeros_like(v) for v in base]
        for k in range(gamma):
            rt = None
            if routes is not None and batch_keep == 1.0:
                rt = routes[k][i]
            loss, g = loss_and_grad(_rebuild(names, p), tok, lab, m, rows,
                                    rt, fault, stats)
            g = [x for _, x in _leaves(g)]
            acc = [c + a[k] * x for c, x in zip(acc, g)]
            p = [v - eta * (x + mu * (v - b0))
                 for v, x, b0 in zip(p, g, base)]
            del g
        last.append(loss)
        agg = [s + c / (sum(a) * n) for s, c in zip(agg, acc)]
    new = [b0 - gamma * eta * s for b0, s in zip(base, agg)]
    return _rebuild(names, new), sum(last) / n
