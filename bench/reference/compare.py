"""How a run's outputs are held against the reference's: relative gaps of
scalars, and gaps of per-leaf change norms taken by the worst leaf."""
from __future__ import annotations

import math

import numpy as np
import torch

# a leaf whose reference change is under this share of the median leaf's
# moves by round-off alone (a bias under softmax); it is left out
NOUGHT = 1e-3


def rel_gap(got: float, want: float) -> float:
    if not (math.isfinite(got) and math.isfinite(want)):
        return math.inf
    return abs(got - want) / max(abs(want), 1e-30)


def change_norms(changes: dict) -> dict:
    """The norm of each leaf of a change (new model minus start)."""
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in changes.items()}


def norm_gap(got: dict, want: dict, keep=None) -> dict:
    """The worst leaf's gap between the program's change norm and the
    reference's, over the larger of that leaf's reference norm and the
    median leaf's.  Leaves whose reference change is nought to rounding
    are left out (``keep`` fixes the set, else the rule above picks it).
    Returns the worst leaf's gap, the same after the program's norms are
    rescaled by the one factor that best fits them to the reference's
    (``shape``: blind to a change of scale common to every leaf, so it
    sees the noise of each leaf apart from such a change), and the
    leaves kept."""
    if keep is None:
        med = float(np.median(list(want.values())))
        keep = [k for k, v in want.items() if v >= NOUGHT * med]
    med = float(np.median([want[k] for k in keep]))
    if not all(math.isfinite(got[k]) for k in keep):
        return {"gap": math.inf, "shape": math.inf, "kept": keep}
    scale = sum(got[k] * want[k] for k in keep) \
        / max(sum(got[k] ** 2 for k in keep), 1e-300)

    def worst(f):
        return max(abs(f * got[k] - want[k]) / max(want[k], med)
                   for k in keep)
    return {"gap": worst(1.0), "shape": worst(scale), "kept": keep}
