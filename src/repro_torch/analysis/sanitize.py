"""The runtime NaN/Inf sanitizer (counterpart of
``repro.analysis.sanitize``'s :func:`check_finite`).

:func:`check_finite` sweeps a tree of tensors (nested dicts, lists and
tuples, in the reference's leaf order: dict keys sorted) or a
:class:`~repro_torch.kernels.plane.ParamPlane`.  It reduces each
floating leaf on its own device and reads all the verdicts in one host
sync, so on the card it costs one sync per call: a debugging net that
``EngineOptions(sanitize=True)`` spreads over every round, not a hot
path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.plane import ParamPlane, tree_paths


class SanitizerError(AssertionError):
    """A runtime sanitizer tripped (NaN/Inf)."""


def _leaves(tree) -> list:
    """The leaves of ``tree`` in the reference's flatten order (a
    ParamPlane is its one data leaf; None is an empty subtree)."""
    if isinstance(tree, ParamPlane):
        return [tree.data]
    if isinstance(tree, dict):
        return [x for _, sub in tree_paths(tree) for x in _leaves(sub)]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [] if tree is None else [tree]


def check_finite(tree, what: str = "value") -> None:
    """Raise :class:`SanitizerError` if any floating tensor leaf of
    ``tree`` holds a NaN or an Inf; other leaves are skipped.  The
    message names the offending leaf indices."""
    idx, flags = [], []
    for i, leaf in enumerate(_leaves(tree)):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            idx.append(i)
            flags.append(torch.isfinite(leaf).all())
    if not flags:
        return
    dev = flags[0].device
    ok = torch.stack([f.to(dev) for f in flags]).cpu()       # the one sync
    bad = [i for i, good in zip(idx, ok.tolist()) if not good]
    if bad:
        raise SanitizerError(
            f"{what}: non-finite values in leaf indices {bad} — "
            f"bisect the round (torch.autograd.set_detect_anomaly) to "
            f"locate the source")
