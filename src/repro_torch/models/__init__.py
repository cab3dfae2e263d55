"""Counterpart of ``repro.models``: decoder-only LMs (dense / MoE / SSM /
hybrid), the Whisper-style encoder-decoder, and the paper's FL
classifier."""
from repro_torch.models import (  # noqa: F401
    attention, blocks, classifier, lm, mamba, moe,
)
from repro_torch.models.common import NO_SHARD, ShardCtx  # noqa: F401
