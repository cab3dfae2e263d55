"""The Moonlight cell's model: the program's configuration built from the
cell's configuration file, and random weights in the program's tree,
drawn from the seed on the device in one draw.  The token batches are
``inputs.token_batch`` over the vocabulary slice, the Nemotron cell's
law."""
from __future__ import annotations

import numpy as np
import torch


def moe_layers(m: dict) -> int:
    """The MoE layers held here: those after the leading dense ones."""
    return m["num_hidden_layers"] - m["first_k_dense_replace"]


def model_config(m: dict):
    """The program's ``ModelConfig`` of the configuration file ``m``:
    float32, latent attention, the leading dense layers, the held experts
    and their offset, drop-free sigmoid routing over SwiGLU experts, the
    shared experts as one MLP of their summed width."""
    from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig
    return ModelConfig(
        name=m["name"], family="moe", num_layers=m["num_hidden_layers"],
        d_model=m["hidden_size"], num_heads=m["num_attention_heads"],
        num_kv_heads=m["num_key_value_heads"],
        head_dim=m["qk_nope_head_dim"] + m["qk_rope_head_dim"],
        d_ff=m["intermediate_size"], vocab_size=m["vocab_size"],
        rope_theta=float(m["rope_theta"]), layer_pattern="A",
        mla=MLAConfig(kv_lora_rank=m["kv_lora_rank"],
                      qk_nope_head_dim=m["qk_nope_head_dim"],
                      qk_rope_head_dim=m["qk_rope_head_dim"],
                      v_head_dim=m["v_head_dim"],
                      q_lora_rank=m["q_lora_rank"]),
        first_dense=m["first_k_dense_replace"],
        moe=MoEConfig(num_experts=m["router_experts"],
                      top_k=m["num_experts_per_tok"],
                      expert_ff=m["moe_intermediate_size"],
                      shared_expert=True, router_z_loss=0.0, aux_loss=0.0,
                      expert_act="swiglu", dropless=True,
                      routed_scale=m["routed_scaling_factor"],
                      held_experts=m["n_routed_experts"],
                      expert_offset=m["expert_offset"],
                      shared_ff=m["n_shared_experts"]
                      * m["moe_intermediate_size"]),
        gated_mlp=True, dtype="float32", norm_eps=m["rms_norm_eps"],
        tie_embeddings=False, source=m["source"])


def shapes(m: dict) -> list:
    """(dotted name, shape, scale) of every drawn leaf: normal matrices
    scaled by 1/sqrt(fan-in), embedding rows N(0, 1); ``blocks`` leaves
    carry the stacked MoE layers' axis.  Unit embedding rows stand for
    the token-specific residual stream of a trained model: at the usual
    0.02 the near-uniform attention of random weights over thousands of
    positions adds one vector, alike at every position, that swamps the
    token, and the router then sends nearly every position to the same
    experts."""
    d, V, H = m["hidden_size"], m["vocab_size"], m["num_attention_heads"]
    nope, rope, dv, r = m["qk_nope_head_dim"], m["qk_rope_head_dim"], \
        m["v_head_dim"], m["kv_lora_rank"]
    E, Eh = m["router_experts"], m["n_routed_experts"]
    f, fd = m["moe_intermediate_size"], m["intermediate_size"]
    fs = m["n_shared_experts"] * f
    P = moe_layers(m)

    def attn(pre, lead):
        return [(pre + "attn.wq", lead + (d, H, nope + rope), d ** -0.5),
                (pre + "attn.wkv_a", lead + (d, r + rope), d ** -0.5),
                (pre + "attn.wkv_b", lead + (r, H, nope + dv), r ** -0.5),
                (pre + "attn.wo", lead + (H, dv, d), (H * dv) ** -0.5)]

    def mlp(pre, lead, width):
        return [(pre + "mlp.w_in", lead + (d, width), d ** -0.5),
                (pre + "mlp.w_gate", lead + (d, width), d ** -0.5),
                (pre + "mlp.w_out", lead + (width, d), width ** -0.5)]

    out = [("embed", (V, d), 1.0), ("unembed", (d, V), d ** -0.5)]
    for i in range(m["first_k_dense_replace"]):
        pre = f"lead.layer_{i}."
        out += attn(pre, ()) + mlp(pre, (), fd)
    pre = "blocks.layer_0."
    out += attn(pre, (P,)) + mlp(pre, (P,), fs)
    out += [(pre + "moe.router", (P, d, E), d ** -0.5),
            (pre + "moe.w_gate_up", (P, Eh, d, 2 * f), d ** -0.5),
            (pre + "moe.w_out", (P, Eh, f, d), f ** -0.5)]
    return out


def weights(m: dict, seed: int, device) -> dict:
    """Random float32 weights in the program's tree: the leaves of
    :func:`shapes` cut from one normal draw, zero norms (the program's
    norms scale by 1 + w)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d, r = m["hidden_size"], m["kv_lora_rank"]
    spec = shapes(m)
    flat = torch.randn(sum(int(np.prod(s)) for _, s, _ in spec),
                       generator=gen, device=device)
    out = {"final_norm": torch.zeros((d,), device=device)}
    off = 0
    for name, shape, scale in spec:
        n = int(np.prod(shape))
        leaf = flat[off:off + n].view(shape) * scale
        off += n
        node = out
        *path, last = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = leaf
    del flat
    layers = [(out["lead"][k], ()) for k in sorted(out.get("lead", {}))] \
        + [(out["blocks"]["layer_0"], (moe_layers(m),))]
    for layer, lead in layers:
        layer["ln1"] = torch.zeros(lead + (d,), device=device)
        layer["ln2"] = torch.zeros(lead + (d,), device=device)
        layer["attn"]["kv_norm"] = torch.zeros(lead + (r,), device=device)
    return out
