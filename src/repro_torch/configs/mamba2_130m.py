"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,            # attention-free
    num_kv_heads=0,
    d_ff=0,                 # Mamba block carries its own 2x expansion
    vocab_size=50280,
    layer_pattern="M",
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=64),
    tie_embeddings=True,
    source="arXiv:2405.21060 (Mamba-2 / SSD), 130m config",
)
