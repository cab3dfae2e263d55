"""The Nemotron-H cell's model: the program's configuration built from the
cell's configuration file, and random weights in the program's tree,
drawn from the seed on the device in two draws.  The token batches are
``inputs.token_batch`` over the vocabulary slice."""
from __future__ import annotations

import numpy as np
import torch


def layer_kinds(m: dict) -> str:
    """The layers held here, in the published pattern's letters."""
    return m["hybrid_override_pattern"][:m["num_hidden_layers"]]


def model_config(m: dict):
    """The program's ``ModelConfig`` of the configuration file ``m``:
    float32, the pattern's '*' written 'A', the held experts and their
    offset, drop-free sigmoid routing, NoPE attention."""
    from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig
    return ModelConfig(
        name=m["name"], family="hybrid", num_layers=m["num_hidden_layers"],
        d_model=m["hidden_size"], num_heads=m["num_attention_heads"],
        num_kv_heads=m["num_key_value_heads"], head_dim=m["head_dim"],
        d_ff=m["moe_shared_expert_intermediate_size"],
        vocab_size=m["vocab_size"],
        layer_pattern=layer_kinds(m).replace("*", "A"), rope=False,
        moe=MoEConfig(num_experts=m["router_experts"],
                      top_k=m["num_experts_per_tok"],
                      expert_ff=m["moe_intermediate_size"],
                      shared_expert=True, router_z_loss=0.0, aux_loss=0.0,
                      expert_act="relu2", dropless=True,
                      routed_scale=m["routed_scaling_factor"],
                      held_experts=m["n_routed_experts"],
                      expert_offset=m["expert_offset"]),
        ssm=SSMConfig(state_dim=m["ssm_state_size"],
                      head_dim=m["mamba_head_dim"], expand=m["expand"],
                      chunk_size=m["chunk_size"], conv_width=m["conv_kernel"],
                      dt_min=m["time_step_min"], dt_max=m["time_step_max"],
                      num_heads=m["mamba_num_heads"], n_groups=m["n_groups"]),
        gated_mlp=False, mlp_act="relu2", dtype="float32",
        norm_eps=m["norm_eps"], tie_embeddings=False, source=m["source"])


def weights(m: dict, seed: int, device) -> dict:
    """Random weights in the program's tree (one period: every block leaf
    with a leading axis of 1), float32: normal matrices scaled by
    1/sqrt(fan-in) (embedding 0.02, conv 0.1), zero norms and biases,
    A = -(1..H), dt log-uniform in [time_step_min, time_step_max] with
    its inverse softplus as the bias."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d, V = m["hidden_size"], m["vocab_size"]
    H, P = m["mamba_num_heads"], m["mamba_head_dim"]
    G, N, W = m["n_groups"], m["ssm_state_size"], m["conv_kernel"]
    Hq, Hkv, D = m["num_attention_heads"], m["num_key_value_heads"], \
        m["head_dim"]
    E, Eh = m["router_experts"], m["n_routed_experts"]
    f, fs = m["moe_intermediate_size"], \
        m["moe_shared_expert_intermediate_size"]
    d_inner = H * P
    d_conv = d_inner + 2 * G * N
    kinds = layer_kinds(m)
    shapes = [("embed", (V, d), 0.02), ("unembed", (d, V), d ** -0.5)]
    for i, kind in enumerate(kinds):
        pre = f"layer_{i}."
        if kind == "M":
            shapes += [(pre + "mamba.w_in", (d, d_inner + d_conv + H),
                        d ** -0.5),
                       (pre + "mamba.conv_w", (W, d_conv), 0.1),
                       (pre + "mamba.w_out", (d_inner, d), d_inner ** -0.5)]
        elif kind == "*":
            shapes += [(pre + "attn.wq", (d, Hq, D), d ** -0.5),
                       (pre + "attn.wk", (d, Hkv, D), d ** -0.5),
                       (pre + "attn.wv", (d, Hkv, D), d ** -0.5),
                       (pre + "attn.wo", (Hq, D, d), (Hq * D) ** -0.5)]
        else:
            shapes += [(pre + "moe.router", (d, E), d ** -0.5),
                       (pre + "moe.w_in", (Eh, d, f), d ** -0.5),
                       (pre + "moe.w_out", (Eh, f, d), f ** -0.5),
                       (pre + "mlp.w_in", (d, fs), d ** -0.5),
                       (pre + "mlp.w_out", (fs, d), fs ** -0.5)]
    flat = torch.randn(sum(int(np.prod(s)) for _, s, _ in shapes),
                       generator=gen, device=device)
    out = {"final_norm": torch.zeros((d,), device=device)}
    u = torch.rand((kinds.count("M"), H), generator=gen, device=device)
    lo, hi = float(np.log(m["time_step_min"])), \
        float(np.log(m["time_step_max"]))
    dts = torch.exp(u * (hi - lo) + lo)
    off = 0
    for name, shape, scale in shapes:
        n = int(np.prod(shape))
        leaf = flat[off:off + n].view(shape) * scale
        off += n
        node = out
        *path, last = name.split(".")
        if path:
            node = out.setdefault("blocks", {})
            for k in path:
                node = node.setdefault(k, {})
            leaf = leaf.unsqueeze(0)              # the period axis
        node[last] = leaf
    del flat
    zeros = torch.zeros
    j = 0
    for i, kind in enumerate(kinds):
        layer = out["blocks"][f"layer_{i}"]
        layer["ln1"] = zeros((1, d), device=device)
        if kind == "M":
            dt = dts[j:j + 1]
            j += 1
            layer["mamba"].update(
                conv_b=zeros((1, d_conv), device=device),
                a_log=torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                             device=device))[None],
                dt_bias=dt + torch.log(-torch.expm1(-dt)),
                d_skip=torch.ones((1, H), device=device),
                norm=zeros((1, d_inner), device=device))
    return out
