"""Mixture-of-Experts with capacity-based dispatch (counterpart of
``repro.models.moe``).

Tokens are routed in groups of ``group_size`` tokens of the flattened
(B * S) axis, so a group can span sequences.  Dispatch and combine are
(G, T, E, C) tensors, and the expert products run on every expert's C
slots, as the JAX package's einsums do (a drop-free decode step reads
every expert's weights).

Variants covered (per the assigned architectures):
  * top-1 (llama4-maverick) / top-2 (arctic, jamba)
  * dense residual branch in parallel (arctic) and the always-on shared
    expert (llama4): both are the layer's ``mlp`` (``blocks.py``)
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig


def init_moe_params(gen: torch.Generator, d_model: int, m: MoEConfig,
                    dtype) -> dict:
    """Random parameters drawn from ``gen`` on its device: the router in
    float32 whatever ``dtype`` is, as in the JAX package; each expert's
    matrices drawn one expert at a time into their stacked tensors, so
    no float32 copy of a whole stack is made."""
    dev = gen.device
    E, f = m.num_experts, m.expert_ff
    scale_in = float(1.0 / np.sqrt(d_model))
    scale_out = float(1.0 / np.sqrt(f))

    def stacked(shape, scale):
        out = torch.empty((E,) + shape, dtype=dtype, device=dev)
        for e in range(E):
            out[e] = torch.randn(shape, generator=gen, device=dev) * scale
        return out

    return {
        "router": torch.randn((d_model, E), generator=gen, device=dev)
        * scale_in,
        "w_gate": stacked((d_model, f), scale_in),
        "w_in": stacked((d_model, f), scale_in),
        "w_out": stacked((f, d_model), scale_out),
    }


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
