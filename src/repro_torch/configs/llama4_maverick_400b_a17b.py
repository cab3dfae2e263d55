"""llama4-maverick-400b-a17b [moe] — 128e top-1 MoE + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E family]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,              # shared-expert width
    vocab_size=202048,
    moe=MoEConfig(num_experts=128, top_k=1, expert_ff=8192, shared_expert=True,
                  every_n_layers=2),  # interleaved MoE (every other layer dense)
    frontend="vq_tokens",   # early-fusion vision tokens stubbed as in-vocab ids
    rope_theta=500000.0,
    source="hf:meta-llama/Llama-4 (Maverick 400B-A17B: 128e top-1 + shared expert)",
)
