"""Plain reference of CE-FL training of a Nemotron-H language model
(NVIDIA-Nemotron-3-Nano-30B-A3B): the forward pass over the blocks
x + f(RMSNorm(x)), f one of a Mamba-2 mixer with grouped B and C ('M'), a
mixture of relu² experts with a shared expert ('E') and causal GQA
without positions ('A'); the mean next-token loss, its gradient by
autograd, FedProx local steps with the eq.-10 accumulation and the eq.-11
aggregation over the DPU replicas (as ``mamba2.cefl_round``).

Plain PyTorch, float32; the caller sets TF32 off.  It imports neither the
program nor JAX.  The model is the chip's share of an expert- and
vocabulary-parallel deployment, as the program's: the router scores all
``router_experts`` experts and only the ``n_routed_experts`` held ones
(ids ``expert_offset`` onwards) are computed; the vocabulary is the
slice.

Departures from the published model, each shared with the program:
- the router's correction bias is held at 0 (its aux-free update is not
  part of the round), and the aux-loss coefficients are 0;
- norms scale by (1 + w), the program's parametrisation;
- what the absent experts would add is left out (the chip's share).
Departures of form only: the SSD is the quadratic (masked attention) form
inside blocks of ``ssd_block`` positions with the state carried between
blocks (512 here, so that 4,096 positions fit; the program's chunk is
128), and attention is the full softmax over the sequence.

Routing is discrete.  Where the program's choice of a token's experts
differs from this reference's own top-k, and every expert the program
chose scores within ``TIE`` (relative) of the reference's k-th score, the
reference follows the program's choice: rounding decided that near-tie,
and either choice is sound.  Such tokens are counted (``ties``); a choice
that differs beyond the tie is kept as the reference's own and counted
(``mismatch``).

Planted faults (``fault``), for the limits: ``softmax`` scores,
``no_scale`` (gates without the routed scale), ``raw_gates`` (the chosen
scores, not normalised over the top-k) and ``capacity`` (pairs past
1.25 x the mean load of a 1,024-token group dropped, as capacity
dispatch does).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.mamba2 import _leaves, _rebuild, _segsum

# a near-tie: the program's experts score within this share of the k-th;
# rounding differences reach 5e-5 by the second round at these widths
TIE = 1e-3
FAULTS = ("softmax", "no_scale", "raw_gates", "capacity")


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1 + w)


def dims(m: dict):
    """(d_inner, heads, groups, state, head dim)."""
    H, P = m["mamba_num_heads"], m["mamba_head_dim"]
    return H * P, H, m["n_groups"], m["ssm_state_size"], P


def mamba_mixer(p: dict, h, m: dict):
    """One Mamba-2 mixer on normed inputs h (b, S, d)."""
    b, S, _ = h.shape
    d_inner, H, G, N, P = dims(m)
    z, xBC, dt = (h @ p["w_in"]).split([d_inner, d_inner + 2 * G * N, H],
                                       dim=-1)
    W = p["conv_w"].shape[0]
    xBC = F.conv1d(xBC.transpose(1, 2), p["conv_w"].T.unsqueeze(1),
                   p["conv_b"], padding=W - 1, groups=xBC.shape[-1])
    xBC = F.silu(xBC[..., :S].transpose(1, 2))
    x, Bm, Cm = xBC.split([d_inner, G * N, G * N], dim=-1)
    x = x.reshape(b, S, H, P)
    group = torch.arange(H, device=h.device) * G // H        # head -> group
    Bh = Bm.reshape(b, S, G, N)[:, :, group]                  # (b, S, H, N)
    Ch = Cm.reshape(b, S, G, N)[:, :, group]
    dt = F.softplus(dt + p["dt_bias"])                        # (b, S, H)
    a = dt * -torch.exp(p["a_log"])
    L = m.get("ssd_block", S)
    state = torch.zeros((b, H, P, N), dtype=h.dtype, device=h.device)
    ys = []
    for s0 in range(0, S, L):
        sl = slice(s0, s0 + L)
        ab = a[:, sl].transpose(1, 2)                          # (b, H, L)
        cs = torch.cumsum(ab, dim=-1)
        decay = torch.exp(_segsum(ab))                         # (b, H, L, L)
        M = torch.einsum("bthn,bjhn->bhtj", Ch[:, sl], Bh[:, sl]) * decay \
            * dt[:, sl].transpose(1, 2)[:, :, None, :]
        y = torch.einsum("bhtj,bjhp->bthp", M, x[:, sl])
        y = y + torch.einsum("bthn,bhpn->bthp", Ch[:, sl], state) \
            * torch.exp(cs).transpose(1, 2)[..., None]
        ys.append(y)
        w_end = torch.exp(cs[..., -1:] - cs) * dt[:, sl].transpose(1, 2)
        state = state * torch.exp(cs[..., -1])[..., None, None] \
            + torch.einsum("bhj,bjhp,bjhn->bhpn", w_end, x[:, sl], Bh[:, sl])
    y = torch.cat(ys, dim=1) + p["d_skip"][:, None] * x
    y = y.reshape(b, S, d_inner) * F.silu(z)
    yg = y.reshape(b, S, G, d_inner // G)                     # group-wise
    y = (yg * torch.rsqrt(yg.pow(2).mean(-1, keepdim=True) + 1e-5)) \
        .reshape(b, S, d_inner) * (1 + p["norm"])
    return y @ p["w_out"]


def attention(p: dict, h, m: dict):
    """Causal GQA without positions, scale 1/sqrt(head_dim)."""
    b, S, d = h.shape
    Hq, Hkv, D = m["num_attention_heads"], m["num_key_value_heads"], \
        m["head_dim"]
    q = (h @ p["wq"].reshape(d, -1)).reshape(b, S, Hq, D).transpose(1, 2)
    k = (h @ p["wk"].reshape(d, -1)).reshape(b, S, Hkv, D).transpose(1, 2)
    v = (h @ p["wv"].reshape(d, -1)).reshape(b, S, Hkv, D).transpose(1, 2)
    k = k.repeat_interleave(Hq // Hkv, dim=1)
    v = v.repeat_interleave(Hq // Hkv, dim=1)
    s = (q @ k.transpose(-1, -2)) / math.sqrt(D)
    mask = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~mask, -torch.inf)
    out = torch.softmax(s, dim=-1) @ v                        # (b, Hq, S, D)
    return out.transpose(1, 2).reshape(b, S, Hq * D) \
        @ p["wo"].reshape(Hq * D, d)


def route(router, h, m: dict, program_ids=None, fault=None, stats=None):
    """The top-k experts of each token (T, d) and their gates: sigmoid
    scores, top-k by score (correction bias 0), gates the chosen scores
    over their sum times ``routed_scaling_factor``.  With
    ``program_ids`` (T, k), near-ties follow the program (module doc)."""
    k = m["num_experts_per_tok"]
    logits = h @ router
    scores = torch.softmax(logits, -1) if fault == "softmax" \
        else torch.sigmoid(logits)
    top, ids = torch.topk(scores, k, dim=-1)
    if program_ids is not None:
        prog = program_ids.long()
        same = (torch.sort(prog, -1).values == torch.sort(ids, -1).values) \
            .all(-1)
        kth = top[:, -1:]
        near = (torch.gather(scores, 1, prog) >= kth * (1 - TIE)).all(-1)
        follow = ~same & near
        if stats is not None:
            stats["ties"] += int(follow.sum())
            stats["mismatch"] += int((~same & ~near).sum())
        ids = torch.where(follow[:, None], prog, ids)
        top = torch.gather(scores, 1, ids)
    if fault == "raw_gates":
        gates = top
    else:
        gates = top / (top.sum(-1, keepdim=True) + 1e-20)
    if fault != "no_scale":
        gates = gates * m["routed_scaling_factor"]
    return ids, gates


def _capacity_keep(ids, m: dict, group: int = 1024):
    """Capacity dispatch's kept pairs: in each group of ``group`` tokens,
    a pair is kept when fewer than C = 1.25 x group x k / E pairs of its
    expert come before it, counted token-major."""
    T, k = ids.shape
    E = m["router_experts"]
    C = max(int(group * k * 1.25 / E), k)
    g = ids.reshape(-1, group * k)
    onehot = F.one_hot(g, E)
    before = torch.cumsum(onehot, dim=1) - onehot
    pos = torch.gather(before, 2, g[..., None])[..., 0]
    return (pos < C).reshape(T, k)


def moe(p: dict, h, m: dict, program_ids=None, fault=None, stats=None):
    """The held experts' part of the routed layer plus the shared expert,
    on normed inputs h (b, S, d)."""
    b, S, d = h.shape
    x = h.reshape(b * S, d)
    ids, gates = route(p["moe"]["router"], x, m, program_ids, fault, stats)
    if fault == "capacity":
        gates = gates * _capacity_keep(ids, m)
    y = torch.zeros_like(x)
    off, held = m["expert_offset"], m["n_routed_experts"]
    for e in range(held):
        tok, slot = torch.nonzero(ids == off + e, as_tuple=True)
        if tok.numel():
            u = x[tok] @ p["moe"]["w_in"][e]
            out = torch.relu(u).square() @ p["moe"]["w_out"][e]
            y = y.index_add(0, tok, out * gates[tok, slot][:, None])
    shared = torch.relu(x @ p["mlp"]["w_in"]).square() @ p["mlp"]["w_out"]
    return (y + shared).reshape(b, S, d)


def pattern(m: dict) -> str:
    """The layers held here: the first ``num_hidden_layers`` of the
    published pattern."""
    return m["hybrid_override_pattern"][:m["num_hidden_layers"]]


def nll_sum(params: dict, tokens, labels, m: dict, routes=None, fault=None,
            stats=None):
    """Summed next-token negative log-likelihood of rows (b, S).
    ``routes``: the program's choices, one (b * S, k) tensor per expert
    layer in order, or None."""
    eps = m["norm_eps"]
    x = params["embed"][tokens.long()]
    routes = iter(routes or [])
    for i, kind in enumerate(pattern(m)):
        lp = {k: _index(v, 0) for k, v in
              params["blocks"][f"layer_{i}"].items()}
        h = _rms(x, lp["ln1"], eps)
        if kind == "M":
            x = x + mamba_mixer(lp["mamba"], h, m)
        elif kind == "*":
            x = x + attention(lp["attn"], h, m)
        else:
            x = x + moe(lp, h, m, next(routes, None), fault, stats)
    x = _rms(x, params["final_norm"], eps)
    logits = x @ params["unembed"]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long(), reduction="sum")


def _index(tree, i):
    """Period ``i`` of a stacked layer tree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def loss_and_grad(params: dict, tokens, labels, m: dict, rows: int,
                  routes=None, fault=None, stats=None):
    """Mean next-token loss over rows (b, S) and its gradient, the rows
    taken ``rows`` at a time.  ``routes``: the program's choices for all
    the rows, one (b * S, k) tensor per expert layer."""
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
            gs = torch.autograd.grad(part, leaves)
        loss += float(part.detach())
        grads = [a + g for a, g in zip(grads, gs)]
        del part, gs
    return loss, _rebuild(names, grads)


def cefl_round(p0: dict, batch: dict, m: dict, *, gamma: int, eta: float,
               mu: float, rows: int, batch_keep: float = 1.0, routes=None,
               fault=None, stats=None, coefs=None):
    """One CE-FL round over n DPUs, as ``mamba2.cefl_round``.  ``routes``:
    the program's choices of the round, ``routes[k][i]`` the expert
    layers' of local step k on DPU i (None: the reference's own).
    ``coefs``: (a_k list, their sum) in place of the exact ones (a
    diagnostic: the program's float32 closed forms)."""
    names, base = zip(*_leaves(p0))
    n = batch["tokens"].shape[0]
    r = 1.0 - eta * mu
    a = [r ** (gamma - 1 - k) for k in range(gamma)]
    a_sum = sum(a)
    if coefs is not None:
        a, a_sum = coefs
    agg = [torch.zeros_like(v) for v in base]
    last = []
    for i in range(n):
        tok, lab = batch["tokens"][i, 0], batch["labels"][i, 0]
        keep = max(1, int(tok.shape[0] * batch_keep))
        tok, lab = tok[:keep], lab[:keep]
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
        agg = [s + c / (a_sum * n) for s, c in zip(agg, acc)]
    new = [b0 - gamma * eta * s for b0, s in zip(base, agg)]
    return _rebuild(names, new), sum(last) / n
