"""nemotron3-nano-30b-a3b [hybrid] — Nemotron-H: Mamba-2 with 8 groups, a
sigmoid-routed relu² MoE (128 experts, top-6, one shared expert) and GQA
without positions, in the 52-layer pattern ``MEMEM*EMEMEM*…``
[hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16 config.json].

The pattern is not periodic, so the whole stack is one 52-layer period
('*' written 'A').  The config has no ``scoring_func``: its DeepSeek-V3
router keys (``n_group``, ``topk_group``, ``norm_topk_prob``,
``routed_scaling_factor``) give sigmoid scores, top-k on them, gates the
chosen scores over their sum times 2.5.  ``rope_theta`` and
``partial_rotary_factor`` are read as unused: Nemotron-H's attention
layers carry no positions.  Routing is drop-free."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"

CONFIG = ModelConfig(
    name="nemotron3-nano-30b-a3b",
    family="hybrid",
    num_layers=52,
    d_model=2688,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=3712,              # the shared expert's width
    vocab_size=131072,
    layer_pattern=PATTERN.replace("*", "A"),
    rope=False,
    moe=MoEConfig(num_experts=128, top_k=6, expert_ff=1856,
                  shared_expert=True, router_z_loss=0.0, aux_loss=0.0,
                  expert_act="relu2", dropless=True, routed_scale=2.5),
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=128,
                  conv_width=4, num_heads=64, n_groups=8),
    gated_mlp=False,
    mlp_act="relu2",
    dtype="bfloat16",
    norm_eps=1e-5,
    source="hf:nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16 (config.json)",
)
