"""Adversarial client models: the threat layer of the scenario subsystem.
Counterpart of ``repro.scenario.adversary`` (numpy, identical draws).

Production edge FL faces client populations the six benign presets never
exercise (the mobile-edge FL survey's first-order threat classes):

* :class:`ByzantineUpdate` — compromised UEs corrupt the *update* they
  report (sign-flipped and scaled, or Gaussian-noise-swamped).  Data is
  untouched; the attack lives at the aggregation input, which is exactly
  what the ``EngineOptions.robust_agg`` trimmed-mean/median counter
  (``core.aggregation.robust_aggregate``) defends.
* :class:`LabelPoison` — data poisoning: compromised UEs train on
  label-flipped examples (y -> C-1-y), degrading the global model
  through honest aggregation.
* :class:`Straggler` — afflicted UEs compute at ``f_n / slowdown``; the
  scaling rides through the existing Sec. II-E cost model (compute delay
  ``d_n^P ∝ 1/f_n``), so straggler-dominated wall-clock shows up in the
  reported round delay without touching the solver's idealized plan.
* :class:`Dropout` — hard i.i.d. availability failure: each round each
  UE independently contributes nothing with probability ``p`` (unlike
  the Markov :class:`~repro_torch.scenario.drift_schedules.JoinLeave` churn,
  there is no persistence).

All adversaries implement the drift-schedule protocol (``apply`` /
``begin_round`` / ``events``), so they compose with the
benign schedules through ``DynamicScenario(schedules=...)`` in the same
fixed UE order — a run stays a pure function of the engine seed.  The two
non-data channels ride on :class:`~repro_torch.scenario.base.ScenarioEvents`:
``corrupted`` (consumed by the executors between local training and
aggregation) and ``compute_scale`` (consumed by ``Engine.finish_round``
cost accounting).

The compromised set is resolved deterministically at ``reset`` (bind)
time: ``ues`` wins when given, else ``round(frac * n_ue)`` evenly spaced
indices — stable across runs so fixed-seed comparisons (the robustness
acceptance test) are meaningful.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.scenario.drift_schedules import _as_np, empty_like

CORRUPTION_MODES = ("sign_flip", "gauss")


def resolve_ues(n_ue: int, frac: float,
                ues: Optional[Tuple[int, ...]]) -> Tuple[int, ...]:
    """The deterministic compromised-UE set: explicit ``ues`` (clamped to
    range) or ``round(frac * n_ue)`` evenly spaced indices."""
    if ues is not None:
        return tuple(sorted({int(u) for u in ues if 0 <= int(u) < n_ue}))
    k = int(round(float(frac) * n_ue))
    if k <= 0:
        return ()
    idx = np.round(np.linspace(0, n_ue - 1, num=min(k, n_ue))).astype(int)
    return tuple(sorted({int(i) for i in idx}))


class _Stateless:
    """Adversaries whose only state is the bind-time compromised set."""

    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, d: dict) -> None:
        pass


@dataclasses.dataclass
class ByzantineUpdate(_Stateless):
    """Update-level corruption at the compromised UEs, from ``start`` on.

    ``mode="sign_flip"``: the reported accumulated gradient becomes
    ``-scale * d_i`` (and the local model ``x - scale * (x_i - x)``),
    the classical directed attack.  ``mode="gauss"``: ``scale``-std
    Gaussian noise is added instead (an undirected jammer), drawn from
    the round's ``torch.Generator``, so corrupted runs stay reproducible
    from the seed.
    """
    mode: str = "sign_flip"
    frac: float = 0.2
    scale: float = 4.0
    ues: Optional[Tuple[int, ...]] = None
    start: int = 0

    def __post_init__(self):
        if self.mode not in CORRUPTION_MODES:
            raise ValueError(f"unknown corruption mode {self.mode!r}; "
                             f"known: {CORRUPTION_MODES}")
        self._set: Tuple[int, ...] = ()

    def reset(self, n_ue: int) -> None:
        self._set = resolve_ues(n_ue, self.frac, self.ues)

    def corrupted(self, t: int) -> Tuple[Tuple[int, str, float], ...]:
        if t < self.start:
            return ()
        return tuple((ue, self.mode, float(self.scale))
                     for ue in self._set)

    def apply(self, t, ue, data, rng):
        return data                   # the attack is post-training


@dataclasses.dataclass
class LabelPoison(_Stateless):
    """Label-flipping data poisoning (y -> num_classes-1-y) at the
    compromised UEs, from ``start`` on."""
    frac: float = 0.3
    num_classes: int = 10
    ues: Optional[Tuple[int, ...]] = None
    start: int = 0

    def __post_init__(self):
        self._set: Tuple[int, ...] = ()

    def reset(self, n_ue: int) -> None:
        self._set = resolve_ues(n_ue, self.frac, self.ues)

    def apply(self, t, ue, data, rng):
        if t < self.start or ue not in self._set or not len(data["y"]):
            return data
        x, y = _as_np(data)
        return {"x": x, "y": (self.num_classes - 1 - y) % self.num_classes}


@dataclasses.dataclass
class Straggler(_Stateless):
    """Compute-rate degradation: afflicted UEs realize ``f_n / slowdown``
    — charged through the existing cost model (``network_costs``), where
    compute delay scales as 1/f_n and compute energy as f_n^2."""
    frac: float = 0.3
    slowdown: float = 4.0
    ues: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.slowdown <= 0:
            raise ValueError("slowdown must be positive")
        self._set: Tuple[int, ...] = ()

    def reset(self, n_ue: int) -> None:
        self._set = resolve_ues(n_ue, self.frac, self.ues)

    def compute_scale(self, t: int, n_ue: int) -> Tuple[float, ...]:
        scale = np.ones(n_ue)
        for ue in self._set:
            scale[ue] = 1.0 / self.slowdown
        return tuple(float(s) for s in scale)

    def apply(self, t, ue, data, rng):
        return data


@dataclasses.dataclass
class Dropout:
    """Hard i.i.d. dropout: each round, each UE independently contributes
    an empty round dataset with probability ``p`` (no Markov persistence
    — compare :class:`~repro_torch.scenario.drift_schedules.JoinLeave`).  At
    least ``min_active`` UEs always survive: the lowest-index down UEs
    are restored deterministically."""
    p: float = 0.1
    min_active: int = 1

    def __post_init__(self):
        self._down = None
        self._joined: Tuple[int, ...] = ()
        self._left: Tuple[int, ...] = ()

    def reset(self, n_ue: int) -> None:
        self._down = np.zeros(n_ue, bool)
        self._joined, self._left = (), ()

    def begin_round(self, t, n_ue, rng):
        if self._down is None or len(self._down) != n_ue:
            self.reset(n_ue)
        prev = self._down.copy()
        down = rng.uniform(0.0, 1.0, n_ue) < self.p
        for ue in np.nonzero(down)[0]:
            if int((~down).sum()) >= self.min_active:
                break
            down[ue] = False
        self._down = down
        self._joined = tuple(int(u) for u in np.nonzero(prev & ~down)[0])
        self._left = tuple(int(u) for u in np.nonzero(~prev & down)[0])

    def events(self):
        return self._joined, self._left

    def state_dict(self) -> dict:
        if self._down is None:
            return {"initialized": 0}
        return {"initialized": 1, "down": np.array(self._down, bool),
                "joined": np.asarray(self._joined, np.int64),
                "left": np.asarray(self._left, np.int64)}

    def load_state_dict(self, d: dict) -> None:
        if not int(d["initialized"]):
            self._down = None
            self._joined, self._left = (), ()
            return
        self._down = np.asarray(d["down"], bool)
        self._joined = tuple(int(u) for u in np.asarray(d["joined"]))
        self._left = tuple(int(u) for u in np.asarray(d["left"]))

    def apply(self, t, ue, data, rng):
        if self._down is not None and self._down[ue]:
            return empty_like(data)
        return data
