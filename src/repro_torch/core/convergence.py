"""Constants of the ML convergence bound (paper Theorem 1 / Corollary 1).
Counterpart of ``repro.core.convergence`` (``MLConstants`` only)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class MLConstants:
    """Smoothness, per-DPU data variability and noise of problem P's bound
    (the JAX package estimates them with paper Algs. 4-7, App. H)."""
    L: float = 1.0            # smoothness
    theta_i: np.ndarray = None    # local data variability (per DPU)
    sigma_i: np.ndarray = None    # local sample std (per DPU)
    zeta1: float = 1.0
    zeta2: float = 0.0
    F0_gap: float = 1.0       # F(x^0) - F*
