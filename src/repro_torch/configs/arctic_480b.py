"""arctic-480b [moe] — 128 experts top-2 + dense residual MLP
[hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,              # dense residual branch width
    vocab_size=32000,
    moe=MoEConfig(num_experts=128, top_k=2, expert_ff=4864, dense_residual=True),
    source="hf:Snowflake/snowflake-arctic-base (dense-MoE hybrid)",
)
