"""Config dataclasses of the model track (counterpart of
``repro.configs.base``, copied as data).

Every architecture gets one module in this package defining a
``ModelConfig``; ``repro_torch.configs.get_config(arch_id)`` resolves it.
Input shapes (train / prefill / decode / long-context-decode) are global
and shared across architectures.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_ff: int                 # d_ff of each expert
    capacity_factor: float = 1.25
    dense_residual: bool = False   # Arctic: dense MLP in parallel with MoE
    shared_expert: bool = False    # Llama-4: always-on shared expert
    every_n_layers: int = 1        # MoE on layers where (layer % every_n) == every_n-1
    router_z_loss: float = 1e-3
    aux_loss: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128           # N (dstate)
    head_dim: int = 64             # P (headdim); nheads = expand*d_model/head_dim
    expand: int = 2
    chunk_size: int = 64           # SSD chunk length
    conv_width: int = 4
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # --- attention variants ---
    qk_norm: bool = False
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None      # native window (starcoder2) or opt-in
    # --- layer-type pattern -----------------------------------------------
    # string of 'A' (attention) / 'M' (mamba) repeated cyclically over layers
    layer_pattern: str = "A"
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # --- enc-dec (whisper) ---
    encoder_layers: int = 0                   # >0 => encoder-decoder
    encoder_seq: int = 1500                   # frames after conv frontend (stub)
    # --- modality frontend stub ---
    frontend: str = "none"                    # none | audio_embed | vq_tokens
    gated_mlp: bool = True                    # SwiGLU (3 mats) vs GELU (2 mats)
    # --- numerics / training ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # citation for the config values
    source: str = ""

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def pattern_for_layer(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    @property
    def attn_free(self) -> bool:
        return "A" not in self.layer_pattern and not self.is_encdec

    def param_count(self) -> int:
        """Analytic parameter count (total, incl. all experts)."""
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        n_layers = self.num_layers
        for i in range(n_layers):
            kind = self.pattern_for_layer(i)
            if kind == "A":
                qkv = d * self.num_heads * self.head_dim + 2 * d * self.num_kv_heads * self.head_dim
                o = self.num_heads * self.head_dim * d
                total += qkv + o
            else:  # mamba block
                s = self.ssm
                d_inner = s.expand * d
                nheads = d_inner // s.head_dim
                in_proj = d * (2 * d_inner + 2 * s.state_dim + nheads)
                out_proj = d_inner * d
                total += in_proj + out_proj + d_inner * s.conv_width
            # mlp/moe
            n_mats = 3 if self.gated_mlp else 2
            if self.moe is not None and (i % self.moe.every_n_layers == self.moe.every_n_layers - 1):
                m = self.moe
                total += m.num_experts * n_mats * d * m.expert_ff
                total += d * m.num_experts  # router
                if m.dense_residual or m.shared_expert:
                    total += n_mats * d * (self.d_ff or m.expert_ff)
            else:
                if self.d_ff:
                    total += n_mats * d * self.d_ff
            total += 2 * d  # norms
        if self.is_encdec:
            # encoder layers: self-attn + mlp; decoder counted above, add cross-attn
            enc = self.encoder_layers * (4 * d * self.num_heads * self.head_dim + 3 * d * self.d_ff + 2 * d)
            cross = n_layers * 4 * d * self.num_heads * self.head_dim
            total += enc + cross
        return total

    def active_param_count(self) -> int:
        """Params active per token (MoE: top_k experts only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        inactive_frac_layers = [i for i in range(self.num_layers)
                                if i % m.every_n_layers == m.every_n_layers - 1]
        inactive = len(inactive_frac_layers) * (m.num_experts - m.top_k) * 3 * self.d_model * m.expert_ff
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                       # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A smoke-test-sized variant of the same family (2 layers, d_model<=512,
    <=4 experts) as required by the assignment."""
    d_model = min(cfg.d_model, 256)
    head_dim = 32
    num_heads = max(2, min(4, cfg.num_heads))
    num_kv = max(1, min(num_heads, cfg.num_kv_heads if cfg.num_kv_heads <= num_heads else num_heads))
    while num_heads % num_kv:
        num_kv -= 1
    kw = dict(
        num_layers=2,
        d_model=d_model,
        num_heads=num_heads,
        num_kv_heads=num_kv,
        d_ff=min(cfg.d_ff, 512) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 512),
        head_dim=head_dim,
        encoder_layers=2 if cfg.is_encdec else 0,
        encoder_seq=16 if cfg.is_encdec else cfg.encoder_seq,
    )
    if "A" in cfg.layer_pattern and "M" in cfg.layer_pattern:
        kw["layer_pattern"] = "MA"   # keep the hybrid nature, 2-layer period
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2), expert_ff=128,
            every_n_layers=min(cfg.moe.every_n_layers, 2))
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_dim=16, head_dim=16, chunk_size=8)
    if cfg.sliding_window is not None:
        kw["sliding_window"] = 64
    kw.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw)
