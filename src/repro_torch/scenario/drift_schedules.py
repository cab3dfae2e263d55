"""Composable data-drift schedules (paper Definition 1 made concrete).
Counterpart of ``repro.scenario.drift_schedules`` (numpy, identical draws).

A schedule transforms the per-UE round dataset *after* ``OnlineDataset``
produced it, so arbitrary drift processes compose over the existing online
data model without touching it:

* :class:`LabelRotation` — periodic label-space rotation (concept drift:
  the y|x mapping shifts every ``period`` rounds).
* :class:`ArrivalBurst` — multiplies a window's arrival volume (flash
  crowd / lull; resampling with replacement, rng-driven).
* :class:`JoinLeave` — a per-UE on/off Markov process; offline UEs
  contribute an empty round dataset (their ``OnlineDataset`` still steps,
  so rejoin trajectories stay deterministic).

Schedules implement ``apply(t, ue, data, rng) -> data`` and optionally
``begin_round(t, n_ue, rng)`` (once per round, before any ``apply``) and
``events() -> (joined, left)``.  ``DynamicScenario`` threads them in UE
order every round, so rng consumption — and therefore the whole run — is
a pure function of the engine seed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


def _as_np(data):
    return np.asarray(data["x"]), np.asarray(data["y"])


def empty_like(data) -> dict:
    """A zero-example round dataset with the same feature shape/dtypes."""
    x, y = _as_np(data)
    return {"x": x[:0], "y": y[:0]}


@dataclasses.dataclass
class LabelRotation:
    """Rotate labels by ``shift`` classes every ``period`` rounds."""
    period: int = 5
    shift: int = 1
    num_classes: int = 10

    def apply(self, t, ue, data, rng):
        k = (t // max(self.period, 1)) * self.shift % self.num_classes
        if k == 0 or len(data["y"]) == 0:
            return data
        x, y = _as_np(data)
        return {"x": x, "y": (y + k) % self.num_classes}

    # stateless: the rotation is a pure function of the round index
    def state_dict(self):
        return {}

    def load_state_dict(self, d):
        pass


@dataclasses.dataclass
class ArrivalBurst:
    """Scale arrival volume by ``factor`` for rounds in [start, start+length)
    on the UEs in ``ues`` (None = all).  factor > 1 resamples up with
    replacement (a burst), factor < 1 subsamples (a lull)."""
    start: int = 0
    length: int = 0
    factor: float = 3.0
    ues: Optional[Tuple[int, ...]] = None

    def apply(self, t, ue, data, rng):
        if not (self.start <= t < self.start + self.length):
            return data
        if self.ues is not None and ue not in self.ues:
            return data
        x, y = _as_np(data)
        D = len(y)
        if D == 0:
            return data
        n = int(round(D * self.factor))
        if self.factor > 0.0:
            n = max(1, n)           # a lull never silences a UE entirely
        if n == 0:
            return empty_like(data)  # factor=0: a true zero-arrival window
        idx = rng.choice(D, size=n, replace=True) if n > D \
            else rng.permutation(D)[:n]
        return {"x": x[idx], "y": y[idx]}

    # stateless: window membership is a pure function of the round index
    def state_dict(self):
        return {}

    def load_state_dict(self, d):
        pass


@dataclasses.dataclass
class JoinLeave:
    """Per-UE availability churn: online UEs drop with prob ``p_leave``,
    offline UEs return with prob ``p_return``; never fewer than
    ``min_active`` stay online."""
    p_leave: float = 0.12
    p_return: float = 0.45
    min_active: int = 2

    def __post_init__(self):
        self._active = None
        self._joined: Tuple[int, ...] = ()
        self._left: Tuple[int, ...] = ()

    def reset(self, n_ue: int):
        self._active = np.ones(n_ue, bool)
        self._joined, self._left = (), ()

    def begin_round(self, t, n_ue, rng):
        if self._active is None or len(self._active) != n_ue:
            self.reset(n_ue)
        draws = rng.uniform(0.0, 1.0, n_ue)
        joined, left = [], []
        for ue in range(n_ue):
            if self._active[ue]:
                if draws[ue] < self.p_leave \
                        and int(self._active.sum()) > self.min_active:
                    self._active[ue] = False
                    left.append(ue)
            elif draws[ue] < self.p_return:
                self._active[ue] = True
                joined.append(ue)
        self._joined, self._left = tuple(joined), tuple(left)

    def events(self):
        return self._joined, self._left

    def state_dict(self):
        if self._active is None:
            return {"initialized": 0}
        # copy: ``begin_round`` mutates ``_active`` in place, and a
        # snapshot must not alias live state
        return {"initialized": 1, "active": np.array(self._active, bool),
                "joined": np.asarray(self._joined, np.int64),
                "left": np.asarray(self._left, np.int64)}

    def load_state_dict(self, d):
        if not int(d["initialized"]):
            self._active = None
            self._joined, self._left = (), ()
            return
        self._active = np.array(d["active"], bool)
        self._joined = tuple(int(u) for u in np.asarray(d["joined"]))
        self._left = tuple(int(u) for u in np.asarray(d["left"]))

    def apply(self, t, ue, data, rng):
        if self._active is not None and not self._active[ue]:
            return empty_like(data)
        return data
