"""The port's device rule: entry points run on ``"cuda"`` unless the caller
asks for the CPU, and a CUDA request on a machine without a card raises."""
from __future__ import annotations

import torch


def require_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it is a CUDA device and
    no card is available (there is no silent fall-back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was asked for, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return dev


def data_on(data: dict, device) -> dict:
    """A dict of arrays (numpy or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in data.items()}
