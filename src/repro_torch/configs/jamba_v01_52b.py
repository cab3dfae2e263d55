"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887]."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    # Jamba period-8 block: attention at index 4 of each period, mamba elsewhere
    layer_pattern="MMMMAMMM",
    moe=MoEConfig(num_experts=16, top_k=2, expert_ff=14336, every_n_layers=2),
    ssm=SSMConfig(state_dim=16, head_dim=64, expand=2, chunk_size=64),
    source="arXiv:2403.19887 (Jamba v0.1)",
)
