"""Architecture config registry (counterpart of ``repro.configs``).

Each architecture is a module defining ``CONFIG``; ``get_config`` resolves
by id (dashes or underscores accepted).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES, MLAConfig, ModelConfig, MoEConfig, SSMConfig, ShapeConfig, reduced,
)

ARCH_IDS = [
    "mamba2-130m",
    "arctic-480b",
    "jamba-v0.1-52b",
    "whisper-medium",
    "codeqwen1.5-7b",
    "qwen3-32b",
    "chameleon-34b",
    "starcoder2-15b",
    "llama4-maverick-400b-a17b",
    "llama3-405b",
    "nemotron3-nano-30b-a3b",
    "moonlight-16b-a3b",
]

_MODULES = {
    "mamba2-130m": "mamba2_130m",
    "arctic-480b": "arctic_480b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "whisper-medium": "whisper_medium",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "qwen3-32b": "qwen3_32b",
    "chameleon-34b": "chameleon_34b",
    "starcoder2-15b": "starcoder2_15b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "llama3-405b": "llama3_405b",
    "nemotron3-nano-30b-a3b": "nemotron3_nano_30b_a3b",
    "moonlight-16b-a3b": "moonlight_16b_a3b",
    "cefl-paper": "cefl_paper",
}


def get_config(arch_id: str) -> ModelConfig:
    key = arch_id.replace("_", "-").lower()
    if key not in _MODULES:
        # allow python-style ids too
        matches = [k for k, v in _MODULES.items() if v == arch_id]
        if matches:
            key = matches[0]
        else:
            raise KeyError(f"unknown architecture {arch_id!r}; known: "
                           f"{sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[key]}")
    return mod.CONFIG
