"""moonlight-16b-a3b [moe] — DeepSeek-V3's layers at 16 B: latent attention
(MLA) without a query LoRA, a leading dense SwiGLU layer, then 26 layers
of 64 sigmoid-routed SwiGLU experts (top-6) with two shared experts
[hf:moonshotai/Moonlight-16B-A3B config.json, ``model_type``
``deepseek_v3``].

MLA: 16 heads, q/k head 192 (128 without positions + 64 with RoPE), v
head 128, a 512-wide latent behind an RMSNorm, one 64-wide RoPE key
shared by every head, ``rope_theta`` 50,000, no rope scaling.  Routing
(``noaux_tc`` with ``n_group`` = ``topk_group`` = 1): sigmoid scores, the
top 6, gates the chosen scores over their sum times 2.446, the
correction bias 0; drop-free.  The two shared experts are one SwiGLU MLP
of width 2 x 1,408."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonlight-16b-a3b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=192,           # q/k head: qk_nope 128 + qk_rope 64
    d_ff=11264,             # the leading dense layer's width
    vocab_size=163840,
    rope_theta=50000.0,
    layer_pattern="A",
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    first_dense=1,
    moe=MoEConfig(num_experts=64, top_k=6, expert_ff=1408,
                  shared_expert=True, router_z_loss=0.0, aux_loss=0.0,
                  expert_act="swiglu", dropless=True, routed_scale=2.446,
                  shared_ff=2816),
    dtype="bfloat16",
    norm_eps=1e-5,
    tie_embeddings=False,
    source="hf:moonshotai/Moonlight-16B-A3B (config.json)",
)
