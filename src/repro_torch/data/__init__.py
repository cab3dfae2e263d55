"""Counterpart of ``repro.data``: the synthetic image pool, the per-UE
online streams and the LM token batches."""
from repro_torch.data.synthetic import (  # noqa: F401
    make_image_dataset, make_online_ues, make_token_batches,
)
