"""Model/concept drift (paper Definition 1) and online dataset dynamics.
Counterpart of ``repro.core.drift``.

Drift Delta_i bounds the per-unit-time change of the *fractional* local loss:

    (D_i^{t+1}/D^{t+1}) F_i^{t+1}(x) - (D_i^t/D^t) F_i^t(x) <= tau^t Delta_i^t.

``estimate_drift`` measures the left-hand side empirically on probe models;
``OnlineDataset`` realizes the paper's dynamic data model (App. G): per-round
arrivals ~ N(2000, 200), non-iid 5-of-10 label support per UE, in numpy,
drawing the same numbers from the same seeds as the reference, so both
packages see identical streams.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.func import vmap

from repro_torch.device import data_on


def fractional_loss(loss_fn: Callable, params, data: dict, D_total: int):
    D_i = len(data["y"])
    return (D_i / D_total) * loss_fn(params, data)


def estimate_drift(loss_fn: Callable, params_probes: Sequence,
                   data_t: dict, data_tp1: dict, D_t: int, D_tp1: int,
                   tau: float) -> float:
    """Empirical Delta_i over a set of probe models (max over probes): the
    probe dicts are stacked on a leading axis and evaluated through one
    vmapped fractional-loss difference."""
    probes = list(params_probes)
    if not probes:
        raise ValueError("estimate_drift needs at least one probe model")
    stacked = {k: torch.stack([torch.as_tensor(p[k]) for p in probes])
               for k in probes[0]}
    dev = next(iter(stacked.values())).device
    data_t, data_tp1 = data_on(data_t, dev), data_on(data_tp1, dev)

    def diff(p):
        return fractional_loss(loss_fn, p, data_tp1, D_tp1) \
            - fractional_loss(loss_fn, p, data_t, D_t)

    vals = vmap(diff)(stacked)
    return float(torch.max(vals)) / max(tau, 1e-9)


def _estimate_drift_loop(loss_fn: Callable, params_probes: Sequence,
                         data_t: dict, data_tp1: dict, D_t: int, D_tp1: int,
                         tau: float) -> float:
    """Per-probe loop (the regression oracle of ``estimate_drift``)."""
    vals = []
    dev = torch.as_tensor(next(iter(params_probes[0].values()))).device
    data_t, data_tp1 = data_on(data_t, dev), data_on(data_tp1, dev)
    for p in params_probes:
        f1 = fractional_loss(loss_fn, p, data_tp1, D_tp1)
        f0 = fractional_loss(loss_fn, p, data_t, D_t)
        vals.append(float(f1 - f0) / max(tau, 1e-9))
    return max(vals)


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

    # -- full-state resume (repro_torch.experiments.runstate) -----------

    def state_dict(self) -> dict:
        """Everything that evolves round to round: PRNG state, the live
        data buffer, and the round counter.  Leaves are arrays/scalars so
        the dict rides through ``training.checkpoint`` unchanged.  ``_x``
        is None until the first ``step``; a zero-length buffer keeps the
        tree structure identical at every round."""
        kind, keys, pos, has_gauss, cached = self._rng.get_state()
        if kind != "MT19937":
            raise ValueError(f"unexpected RandomState kind {kind!r}")
        return {
            "rng": {"keys": np.asarray(keys), "pos": int(pos),
                    "has_gauss": int(has_gauss), "cached": float(cached)},
            "x": self.features[:0] if self._x is None
                 else np.asarray(self._x),
            "y": self.labels[:0] if self._y is None
                 else np.asarray(self._y),
            "has_data": int(self._x is not None),
            "round": int(self._round),
        }

    def load_state_dict(self, d: dict) -> None:
        self._rng.set_state(("MT19937",
                             np.asarray(d["rng"]["keys"], np.uint32),
                             int(d["rng"]["pos"]),
                             int(d["rng"]["has_gauss"]),
                             float(d["rng"]["cached"])))
        if int(d["has_data"]):
            self._x = np.asarray(d["x"])
            self._y = np.asarray(d["y"])
        else:
            self._x = self._y = None
        self._round = int(d["round"])

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
