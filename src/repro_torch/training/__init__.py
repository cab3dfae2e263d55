"""Counterpart of ``repro.training``: checkpoints (``checkpoint.py``).
The reference's optimizers (``training.optim``: ``adamw``, ``sgd``) have
no caller on the port's paths and stay in the JAX package."""
from repro_torch.training.checkpoint import (  # noqa: F401
    load_checkpoint, save_checkpoint,
)
