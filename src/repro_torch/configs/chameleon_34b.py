"""chameleon-34b [vlm] — early fusion, VQ image tokens [arXiv:2405.09818]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,       # includes 8192 VQ image codes (early fusion)
    qk_norm=True,           # Chameleon uses qk-norm for stability
    frontend="vq_tokens",   # image tokenizer stubbed: ids already in-vocab
    source="arXiv:2405.09818 (Chameleon 34B)",
)
