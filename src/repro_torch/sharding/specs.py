"""The divisibility rule of the sharded layouts.  Counterpart of
``sanitize_spec`` in ``repro.sharding.specs``.

A spec names, per dim of a shape, the mesh axis (or tuple of axes) that
splits it, or None.  An axis is kept only where its size (the product of
the sizes, for a tuple) divides the dim; otherwise that dim is replicated.
There is no padding: a ragged dim degrades to replication.

The reference's TPU-pod rules (``param_specs``, ``cache_specs``,
``batch_spec``, ``shard_ctx_for``, ``sanitize_tree``) feed its XLA launch
tooling and are not ported (ROADMAP queue 1 item 6.4).
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

Entry = Union[None, str, Tuple[str, ...]]


def sanitize_spec(spec: Sequence[Entry], shape: Sequence[int],
                  sizes: Mapping[str, int]) -> Tuple[Optional[Entry], ...]:
    """One entry per dim of ``shape``: ``spec``'s entry where the axes'
    size product divides the dim, else None.  ``sizes`` maps each mesh
    axis name to its size; a spec shorter than the shape pads with
    None."""
    entries = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        if entry is None:
            entries.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = 1
        for a in axes:
            size *= sizes[a]
        entries.append(entry if (size and dim % size == 0) else None)
    return tuple(entries)
