"""Frozen operation counts of the Moonlight cell: the model's matmul
operations per token and per routed pair, and the grouped expert
products' share of their roofline from the launches' recorded shapes.
Peaks are ``roofline``'s (float32 with TF32 off, HBM)."""
from __future__ import annotations

from bench.nemotron_flops import grouped_bound_seconds
from bench.program_spans import window_spans

SYMBOLS = {"mm": "grouped_mm_kernel", "wgrad": "grouped_wgrad_kernel"}


def mla_projection_flops(m: dict) -> float:
    """One token through an MLA layer's projections: W_q (d -> heads x
    192), W_kva (d -> 512 + 64), W_kvb (512 -> heads x (128 + 128)), W_o
    (heads x 128 -> d)."""
    d, H = m["hidden_size"], m["num_attention_heads"]
    nope, rope, dv, r = m["qk_nope_head_dim"], m["qk_rope_head_dim"], \
        m["v_head_dim"], m["kv_lora_rank"]
    return float(2 * d * H * (nope + rope) + 2 * d * (r + rope)
                 + 2 * r * H * (nope + dv) + 2 * H * dv * d)


def mla_core_flops(m: dict, seq: int) -> float:
    """One query's two causal products, q k^T over the 192-wide heads and
    p v over the 128-wide ones, seq / 2 keys a query."""
    H = m["num_attention_heads"]
    qk = m["qk_nope_head_dim"] + m["qk_rope_head_dim"]
    return 2.0 * H * (qk + m["v_head_dim"]) * (seq / 2)


def dense_forward_flops_per_token(m: dict, seq: int) -> float:
    """The matmul operations of one token through the layers that every
    token takes, and the head: MLA in every layer (projections and the
    causal core), the leading dense layers' SwiGLU MLP, each MoE layer's
    router and shared experts (one SwiGLU MLP of n_shared x 1,408), the
    lm_head over the vocabulary slice.  The routed experts are counted
    by pairs (:func:`routed_flops`); norms, RoPE and elementwise work are
    not counted."""
    d, V = m["hidden_size"], m["vocab_size"]
    n_dense = m["first_k_dense_replace"]
    n_moe = m["num_hidden_layers"] - n_dense
    attn = mla_projection_flops(m) + mla_core_flops(m, seq)
    dense = 2 * 3 * d * m["intermediate_size"]
    moe = 2 * d * m["router_experts"] \
        + 2 * 3 * d * m["n_shared_experts"] * m["moe_intermediate_size"]
    return float(m["num_hidden_layers"] * attn + n_dense * dense
                 + n_moe * moe + 2 * d * V)


def routed_flops(m: dict, pairs: float) -> float:
    """The held experts' gate, up and down products over ``pairs`` (token,
    expert) pairs."""
    return 2.0 * 3 * m["hidden_size"] * m["moe_intermediate_size"] * pairs


def train_flops(m: dict, seq: int, tokens: float, pairs: float) -> float:
    """Model operations of training on ``tokens`` whose forward passes
    routed ``pairs`` pairs to held experts: three times the forward, no
    recompute counted."""
    return 3.0 * (dense_forward_flops_per_token(m, seq) * tokens
                  + routed_flops(m, pairs))


def grouped_roofline(data):
    """The grouped launches' share of their roofline over the traced
    window, in %: each launch's bound (``nemotron_flops``, at the pairs,
    experts, K and N of its ``moe.grouped`` span) over the device time of
    the CUDA kernels' records.  Where the profiler dropped records, each
    kind's launches are counted by their mean bound, once a record."""
    launches = [s.attrs for s in window_spans(data, "moe.grouped")
                if "pairs" in s.attrs]
    bound = device = 0.0
    for kind, symbol in SYMBOLS.items():
        mine = [x for x in launches if x["kind"] == kind]
        records = data.kernel_records(symbol)
        if not mine or not records:
            continue
        mean = sum(grouped_bound_seconds(x) for x in mine) / len(mine)
        bound += mean * min(len(records), len(mine))
        device += sum(e - s for _, s, e in records[:len(mine)])
    return 100.0 * bound / device if device > 0 else None
