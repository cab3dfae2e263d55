"""Mixture-of-Experts: capacity-based dispatch (counterpart of
``repro.models.moe``) and, for configs with ``MoEConfig.dropless``, a
drop-free layer over this chip's held experts (:func:`dropless_forward`).

Tokens are routed in groups of ``group_size`` tokens of the flattened
(B * S) axis, so a group can span sequences.  Dispatch and combine are
(G, T, E, C) tensors, and the expert products run on every expert's C
slots, as the JAX package's einsums do (a drop-free decode step reads
every expert's weights).

Variants covered (per the assigned architectures):
  * top-1 (llama4-maverick) / top-2 (arctic, jamba)
  * dense residual branch in parallel (arctic) and the always-on shared
    expert (llama4, nemotron-h): both are the layer's ``mlp``
    (``blocks.py``)
  * drop-free sigmoid top-6 over 128 relu² experts (nemotron-h) or 64
    SwiGLU experts (moonlight) with routed scaling, the chip's share of an
    expert-parallel layer
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import MoEConfig
from repro_torch.kernels import grouped_mm as gmm


def init_moe_params(gen: torch.Generator, d_model: int, m: MoEConfig,
                    dtype) -> dict:
    """Random parameters drawn from ``gen`` on its device: the router in
    float32 whatever ``dtype`` is, as in the JAX package; each expert's
    matrices drawn one expert at a time into their stacked tensors, so
    no float32 copy of a whole stack is made.  A drop-free SwiGLU layer
    holds each expert's gate and up matrices side by side, ``w_gate_up``
    (E, d, 2f), gate first."""
    dev = gen.device
    E, f = m.held, m.expert_ff
    scale_in = float(1.0 / np.sqrt(d_model))
    scale_out = float(1.0 / np.sqrt(f))

    def stacked(shape, scale):
        out = torch.empty((E,) + shape, dtype=dtype, device=dev)
        for e in range(E):
            out[e] = torch.randn(shape, generator=gen, device=dev) * scale
        return out

    p = {"router": torch.randn((d_model, m.num_experts), generator=gen,
                               device=dev) * scale_in}
    if m.dropless and m.expert_act == "swiglu":
        # gate and up side by side: one grouped product of width 2f
        p["w_gate_up"] = stacked((d_model, 2 * f), scale_in)
        p["w_out"] = stacked((f, d_model), scale_out)
        return p
    if m.expert_act != "relu2":
        p["w_gate"] = stacked((d_model, f), scale_in)
    p["w_in"] = stacked((d_model, f), scale_in)
    p["w_out"] = stacked((f, d_model), scale_out)
    return p


def moe_capacity(tokens_per_group: int, m: MoEConfig) -> int:
    c = int(tokens_per_group * m.top_k * m.capacity_factor / m.num_experts)
    return max(c, m.top_k)


def moe_route(router, xg, m: MoEConfig, C: int):
    """The routing of token groups xg (G, T, d): f32 logits and softmax,
    the top-k experts of each token (ties to the lower expert index, as
    ``jax.lax.top_k``), their gates renormalised, and each (token,
    choice) pair's position in its expert's queue, counted token-major
    over the (T * k) pairs.  Returns a dict of ``logits``, ``probs`` (G,
    T, E), ``gates`` (G, T, k) f32, ``expert_ids`` (G, T, k) and
    ``position`` (G, T, k) int64, ``kept`` (G, T, k) bool (position <
    C)."""
    G, T, _ = xg.shape
    k = m.top_k
    logits = xg.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = vals[..., :k], ids[..., :k]
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    onehot = F.one_hot(ids.reshape(G, T * k), m.num_experts)  # (G,T*k,E)
    before = torch.cumsum(onehot, dim=1) - onehot
    position = torch.gather(before, 2, ids.reshape(G, T * k, 1)).view(
        G, T, k)
    return {"logits": logits, "probs": probs, "gates": gates,
            "expert_ids": ids, "position": position, "kept": position < C}


def moe_forward(params: dict, x: torch.Tensor, m: MoEConfig,
                group_size: int = 1024,
                capacity: int = None) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d) -> (y, aux) with aux = {load_balance, router_z}, f32
    scalars.

    ``capacity``: expert capacity override; pass ``group_size`` (the worst
    case) for drop-free routing (the decode path).  Pairs past an
    expert's capacity are dropped: their slot row is zero.  Dispatch and
    combine are cast to x's dtype before their products (in a bf16 model
    the gates round to bf16), and SiLU runs in f32 on the gate product."""
    B, S, d = x.shape
    T = B * S
    group_size = min(group_size, T)
    if T % group_size:
        raise ValueError(f"{T} tokens are not a whole number of "
                         f"{group_size}-token MoE groups")
    G = T // group_size
    xg = x.reshape(G, group_size, d)
    E, k = m.num_experts, m.top_k
    C = capacity if capacity is not None else moe_capacity(group_size, m)
    r = moe_route(params["router"], xg, m, C)

    # each kept pair's slot e * C + position; a dropped pair adds 0 to a
    # slot of its own expert, which no other choice of the token uses
    slot = r["expert_ids"] * C + torch.clamp(r["position"], max=C - 1)
    kept = r["kept"].to(torch.float32)
    dispatch = torch.zeros((G, group_size, E * C), dtype=torch.float32,
                           device=x.device)
    combine = torch.zeros_like(dispatch)
    dispatch.scatter_add_(2, slot, kept)
    combine.scatter_add_(2, slot, kept * r["gates"])
    dispatch, combine = dispatch.to(x.dtype), combine.to(x.dtype)

    xe = torch.bmm(dispatch.transpose(1, 2), xg)             # (G, E*C, d)
    xe = xe.view(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
    h = torch.bmm(xe, params["w_in"])
    g = torch.bmm(xe, params["w_gate"])
    h = F.silu(g.float()).to(x.dtype) * h
    ye = torch.bmm(h, params["w_out"])                       # (E, G*C, d)
    ye = ye.view(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)
    y = torch.bmm(combine, ye)                               # (G, T, d)

    # aux losses (Switch-style)
    density = F.one_hot(r["expert_ids"], E).sum(dim=2).float().mean(dim=1)
    prob_mean = r["probs"].mean(dim=1)                       # (G, E)
    load_balance = E * torch.mean(torch.sum(density * prob_mean, dim=-1))
    router_z = torch.mean(torch.square(torch.logsumexp(r["logits"],
                                                       dim=-1)))
    return y.reshape(B, S, d), {"load_balance": load_balance,
                                "router_z": router_z}


# --------------------------------------------------------- drop-free ----

# the forward calls while tracing records, read once after the round by
# :func:`flush_counts`: (their moe.experts span token, pairs routed to a
# held expert, rows the up product wrote, offsets), the last three on the
# device
_CALLS: list = []


def _in_backward() -> bool:
    """True inside an autograd backward pass (a remat recompute)."""
    return torch._C._current_graph_task_id() != -1


class Route(NamedTuple):
    """A drop-free routing of T tokens (:func:`dropless_route`)."""
    gates: torch.Tensor     # (T, k) f32
    ids: torch.Tensor       # (T, k) int64, the chosen experts
    offsets: torch.Tensor   # (Eh + 1,) int64 segment bounds, sorted pairs
    rows: torch.Tensor      # (T * k,) int64, each sorted pair's token
    inv: torch.Tensor       # (T, k) int64, each pair's sorted position
    held: torch.Tensor      # (T, k) bool, the pair's expert is held here


def dropless_route(router, h, m: MoEConfig) -> Route:
    """Route tokens h (T, d) over all ``num_experts`` experts and sort the
    (token, choice) pairs of this chip's held experts by expert, on the
    device (no host read).  Scores: sigmoid of the f32 logits; the top-k
    by score (a correction bias would be added here
    for the choice; it is 0); gates: the chosen scores over their sum,
    times ``routed_scale``.  Held expert e's pairs are the sorted
    positions ``offsets[e] .. offsets[e + 1]``."""
    T = h.shape[0]
    k, Eh = m.top_k, m.held
    logits = h.float() @ router.float()
    scores = torch.sigmoid(logits)
    top, ids = torch.topk(scores, k, dim=-1)
    gates = top / (top.sum(dim=-1, keepdim=True) + 1e-20) * m.routed_scale
    local = ids - m.expert_offset
    held = (local >= 0) & (local < Eh)
    key = torch.where(held, local, Eh).reshape(-1)
    sorted_key, order = torch.sort(key, stable=True)
    offsets = torch.searchsorted(
        sorted_key, torch.arange(Eh + 1, device=h.device))
    rows = torch.div(order, k, rounding_mode="floor")
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(T * k, device=h.device))
    return Route(gates, ids, offsets, rows, inv.view(T, k), held)


def dropless_forward(params: dict, x: torch.Tensor, m: MoEConfig):
    """x (B, S, d) -> y (B, S, d): this chip's held experts' part of the
    drop-free routed layer (the shared expert is the layer's ``mlp``).
    Every pair routed to a held expert is computed: sorted by expert, the
    up products (relu² experts: w_in; SwiGLU: gate and up as one product
    of width 2f, then silu(g) * u) and the down products run as grouped
    products over the segments
    (``kernels.grouped_mm``), and the gated results are summed back per
    token in a fixed order.  Nothing is read on the host.  Traced as
    ``moe.route`` and ``moe.experts`` host spans, the latter with the
    products' shape (``experts``, ``d``, ``f``; ``pairs`` once read) and
    a ``moe.grouped`` span a launch inside; while tracing records, each
    forward call's pair counts wait on the device for
    :func:`flush_counts`: the routing's pairs to held experts, and the
    rows the up product's kernel counted as it wrote them."""
    B, S, d = x.shape
    h = x.reshape(B * S, d)
    with tracing.span("moe.route"):
        gates, _, offsets, rows, inv, held = dropless_route(
            params["router"], h, m)
    token = tracing.begin("moe.experts")
    written = None
    if token is not None:
        for key, v in (("experts", m.held), ("d", d), ("f", m.expert_ff)):
            tracing.annotate(token, key, v)
        if not _in_backward():
            written = torch.zeros((), dtype=torch.int64, device=h.device)
            _CALLS.append((token, held.sum(), written, offsets))
    try:
        if m.expert_act == "swiglu":
            gu = gmm.grouped_matmul(h, params["w_gate_up"], offsets, rows,
                                    inv, written)
            g, u = gu.split(m.expert_ff, dim=-1)
            a = F.silu(g) * u
        else:
            u = gmm.grouped_matmul(h, params["w_in"], offsets, rows, inv,
                                   written)
            a = torch.square(F.relu(u))
        o = gmm.grouped_matmul(a, params["w_out"], offsets)
        # y_t = sum_j gate_tj * o[inv_tj]: rows of pairs no held expert
        # took are zero
        y = torch.bmm(gates.to(o.dtype)[:, None, :], o[inv.reshape(-1)]
                      .view(B * S, m.top_k, d))[:, 0]
    finally:
        tracing.end(token)
    return y.view(B, S, d)


def flush_counts() -> None:
    """One host read of what the traced forward calls and grouped
    launches left on the device, recorded as a ``moe.counts`` span with
    ``moe_pairs_held`` (rows the up products wrote, summed over the
    forward calls, remat recomputes left out), ``moe_load_max`` (the
    largest over the calls of the most-loaded held expert's pairs over
    the held mean) and ``moe_dropped`` (pairs the router sent to a held
    expert less the rows written: a pair whose product was never
    computed); each launch's ``moe.grouped`` span gets its ``pairs``.
    Nothing to read: nothing happens."""
    calls, launches = list(_CALLS), list(gmm.PENDING)
    _CALLS.clear()
    gmm.PENDING.clear()
    if not calls and not launches:
        return
    parts = [torch.stack([n, w]) for _, n, w, _ in calls] \
        + [o[-1:] for _, o in launches] \
        + [o[1:] - o[:-1] for _, _, _, o in calls]
    flat = torch.cat([p.reshape(-1).to(torch.int64) for p in parts]) \
        .tolist()
    routed = flat[0:2 * len(calls):2]
    taken = flat[1:2 * len(calls):2]
    for (token, _, _, _), n in zip(calls, taken):
        tracing.annotate(token, "pairs", n)
    pos = 2 * len(calls)
    for token, _ in launches:
        tracing.annotate(token, "pairs", flat[pos])
        pos += 1
    load = 0.0
    for _, _, _, o in calls:
        n = o.numel() - 1
        seg = flat[pos:pos + n]
        pos += n
        if sum(seg):
            load = max(load, max(seg) * n / sum(seg))
    with tracing.span("moe.counts"):
        tracing.count("moe_pairs_held", sum(taken))
        tracing.count("moe_load_max", load)
        tracing.count("moe_dropped", sum(routed) - sum(taken))
