"""Frozen operation and byte counts of the Nemotron-H cell: the model's
matmul operations, and the grouped expert products' operations and bytes
at each launch's recorded shape.  Peaks are ``roofline``'s (float32 with
TF32 off, HBM)."""
from __future__ import annotations

from bench.roofline import bound_seconds

F32 = 4


def dense_forward_flops_per_token(m: dict, seq: int) -> float:
    """The matmul operations of one token through the period's layers
    that every token takes, and the head: the Mamba-2 in and out
    projections and the SSD's four chunk products (C·B^T per group, the
    intra-chunk product with x, the chunk states, the inter-chunk
    read-out); attention's q, k, v, o projections and its two causal
    products (half of the seq x seq square: seq / 2 keys a query); the
    router and the shared expert; the lm_head over the vocabulary slice.
    The routed experts are counted by pairs (:func:`routed_flops`);
    elementwise work, the depthwise conv and the norms are not counted."""
    d, V = m["hidden_size"], m["vocab_size"]
    H, P = m["mamba_num_heads"], m["mamba_head_dim"]
    G, N = m["n_groups"], m["ssm_state_size"]
    Q = min(m["chunk_size"], seq)
    Hq, Hkv, D = m["num_attention_heads"], m["num_key_value_heads"], \
        m["head_dim"]
    d_inner = H * P
    mamba = 2 * d * (2 * d_inner + 2 * G * N + H) + 2 * d_inner * d \
        + 2 * Q * N * G + 2 * Q * H * P + 4 * H * P * N
    attn = 2 * d * (Hq + 2 * Hkv) * D + 2 * Hq * D * d \
        + 2 * 2 * Hq * D * (seq / 2)
    moe = 2 * d * m["router_experts"] \
        + 2 * 2 * d * m["moe_shared_expert_intermediate_size"]
    per = {"M": mamba, "*": attn, "E": moe}
    kinds = m["hybrid_override_pattern"][:m["num_hidden_layers"]]
    return float(sum(per[k] for k in kinds) + 2 * d * V)


def routed_flops(m: dict, pairs: float) -> float:
    """The held experts' up and down products over ``pairs`` (token,
    expert) pairs."""
    return 2.0 * 2 * m["hidden_size"] * m["moe_intermediate_size"] * pairs


def train_flops(m: dict, seq: int, tokens: float, pairs: float) -> float:
    """Model operations of training on ``tokens`` whose forward passes
    routed ``pairs`` pairs to held experts: three times the forward, no
    recompute counted."""
    return 3.0 * (dense_forward_flops_per_token(m, seq) * tokens
                  + routed_flops(m, pairs))


def grouped_flops(launch: dict) -> float:
    """2 x pairs x K x N of one grouped launch."""
    return 2.0 * launch["pairs"] * launch["K"] * launch["N"]


def grouped_bytes(launch: dict) -> float:
    """One read of the pairs' rows of the K-wide operand and of the
    experts' K x N weights, one write of the pairs' N-wide rows (``mm``);
    or one read of both pair operands and one write of the weight
    gradients (``wgrad``)."""
    p, K, N, E = launch["pairs"], launch["K"], launch["N"], \
        launch["experts"]
    return float(F32 * (p * K + p * N + E * K * N))


def grouped_bound_seconds(launch: dict) -> float:
    return bound_seconds(grouped_bytes(launch), grouped_flops(launch))
