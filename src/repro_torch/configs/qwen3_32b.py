"""qwen3-32b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B family scaled per assignment]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B (qk-norm GQA family), 32b dims per assignment",
)
