"""Online dataset dynamics (paper App. G): per-round arrivals ~ N(2000, 200),
non-iid 5-of-10 label support per UE.  Counterpart of
``repro.core.drift.OnlineDataset``: numpy, drawing the same numbers from
the same seeds, so both packages see identical streams.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class OnlineDataset:
    """Per-UE dynamic dataset: each round new points arrive (mean/var per
    App. G) drawn from the UE's label support; a fraction of old points
    expires.  Deterministic given the numpy seed."""
    features: np.ndarray          # pool (N, ...) to draw from
    labels: np.ndarray            # pool labels (N,)
    label_support: np.ndarray     # labels this UE can observe
    mean_arrivals: float = 2000.0
    std_arrivals: float = 200.0
    retention: float = 0.0        # fraction of previous data kept
    seed: int = 0
    drift_labels: bool = False    # label support rotates over time (drift)

    def __post_init__(self):
        self._rng = np.random.RandomState(self.seed)
        self._x: Optional[np.ndarray] = None
        self._y: Optional[np.ndarray] = None
        self._round = 0
        num_classes = int(self.labels.max()) + 1
        self._by_label = {c: np.nonzero(self.labels == c)[0]
                          for c in range(num_classes)}

    @property
    def num_classes(self):
        return int(self.labels.max()) + 1

    def step(self) -> dict:
        """Advance one global round; returns {'x', 'y'} current local data
        as host numpy arrays."""
        support = np.array(self.label_support)
        if self.drift_labels and self._round > 0:
            shift = self._round % self.num_classes
            support = (support + shift) % self.num_classes
        n_new = max(1, int(self._rng.normal(self.mean_arrivals,
                                            self.std_arrivals)))
        per_label = np.array_split(np.arange(n_new), len(support))
        idx = np.concatenate([
            self._rng.choice(self._by_label[int(c)], size=len(part),
                             replace=True)
            for c, part in zip(support, per_label) if len(part)])
        x_new, y_new = self.features[idx], self.labels[idx]
        if self._x is not None and self.retention > 0:
            keep = self._rng.rand(len(self._x)) < self.retention
            x_new = np.concatenate([self._x[keep], x_new])
            y_new = np.concatenate([self._y[keep], y_new])
        self._x, self._y = x_new, y_new
        self._round += 1
        return {"x": x_new, "y": y_new}
