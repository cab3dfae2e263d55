"""whisper-medium [audio] — encoder-decoder, conv frontend (stub)
[arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,          # decoder layers
    encoder_layers=24,
    encoder_seq=1500,       # 30s audio -> 1500 frames after conv frontend (stub)
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,        # MHA
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    frontend="audio_embed",
    gated_mlp=False,        # Whisper uses a standard GELU MLP
    tie_embeddings=True,
    source="arXiv:2212.04356 (Whisper medium)",
)
