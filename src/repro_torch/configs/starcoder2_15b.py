"""starcoder2-15b [dense] — GQA, RoPE, native sliding-window 4096
[arXiv:2402.19173]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    sliding_window=4096,    # native to the model card
    gated_mlp=False,        # StarCoder2 uses a standard (non-gated) GELU MLP
    source="arXiv:2402.19173 (StarCoder2-15B)",
)
