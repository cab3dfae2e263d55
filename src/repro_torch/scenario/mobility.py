"""Geometry + UE mobility models for the dynamic scenarios.  Counterpart
of ``repro.scenario.mobility`` (numpy, identical draws).

``layout_from_network`` drops the abstract three-tier topology onto a 2-D
field (DCs on a ring, BSs clustered around their anchor DC, UEs around a
home BS of their subnetwork — the App. F-D subnetwork structure made
spatial).  Mobility models then advance UE positions each round:

* :class:`RandomWaypoint` — pick a waypoint uniformly in the field, walk
  toward it at a per-leg speed, pause, repeat (the classic pedestrian
  model; an optional *attractor* window pins waypoints to a hotspot for
  flash-crowd scenarios).
* :class:`GaussMarkov` — temporally correlated velocity process
  ``v_t = a v_{t-1} + (1-a) v_mean + sqrt(1-a^2) sigma w_t`` with boundary
  reflection (vehicular motion: smooth headings, no ping-pong).

All state lives in plain numpy arrays and every draw comes from the rng
handed in by the scenario, so trajectories are a pure function of the
engine seed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class FieldLayout:
    """Positions (meters) of every node on the [0, area]^2 field."""
    area: float
    dc_pos: np.ndarray    # (S, 2)
    bs_pos: np.ndarray    # (B, 2)
    ue_pos: np.ndarray    # (N, 2)


def layout_from_network(net, rng, area: float = 2000.0) -> FieldLayout:
    """Spatialize a ``Network``: DC anchors on a ring, BSs near their DC,
    UEs near a random BS of their home subnetwork."""
    N, B, S = net.dims
    ang = 2.0 * np.pi * np.arange(S) / max(S, 1)
    dc_pos = area * (0.5 + 0.32 * np.stack([np.cos(ang), np.sin(ang)], 1))
    bs_pos = dc_pos[np.asarray(net.subnet_of_bs)] \
        + rng.uniform(-0.12, 0.12, (B, 2)) * area
    ue_pos = np.zeros((N, 2))
    for n in range(N):
        cands = np.nonzero(np.asarray(net.subnet_of_bs)
                           == net.subnet_of_ue[n])[0]
        home = int(rng.choice(cands)) if len(cands) else int(rng.choice(B))
        ue_pos[n] = bs_pos[home] + rng.uniform(-0.07, 0.07, 2) * area
    clip = lambda p: np.clip(p, 0.0, area)  # noqa: E731
    return FieldLayout(area=area, dc_pos=clip(dc_pos), bs_pos=clip(bs_pos),
                       ue_pos=clip(ue_pos))


class MobilityModel:
    """Base: ``init(rng, pos, area)`` seeds per-UE state, ``step(t, rng,
    pos, area, dt)`` returns the positions after ``dt`` seconds."""

    def init(self, rng, pos: np.ndarray, area: float) -> None:
        raise NotImplementedError

    def step(self, t: int, rng, pos: np.ndarray, area: float,
             dt: float) -> np.ndarray:
        raise NotImplementedError

    # full-state resume hooks (repro_torch.experiments.runstate): models
    # carry only numpy arrays, so the default covers every stateless model
    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, d: dict) -> None:
        pass


class RandomWaypoint(MobilityModel):
    """Random-waypoint mobility with optional hotspot attraction.

    ``speed`` is the (lo, hi) m/s range drawn per leg; while ``t`` lies in
    ``attract_rounds`` every new waypoint is the hotspot
    (``attractor`` in [0,1]^2 field fractions) plus a small scatter —
    the flash-crowd ingredient.
    """

    def __init__(self, speed: Tuple[float, float] = (0.8, 2.0),
                 pause: float = 0.0,
                 attractor: Optional[Tuple[float, float]] = None,
                 attract_rounds: Tuple[int, int] = (0, 0)):
        self.speed = speed
        self.pause = pause
        self.attractor = attractor
        self.attract_rounds = attract_rounds
        self._wp = None
        self._v = None
        self._pause_left = None

    def _new_leg(self, t, rng, n, area):
        lo, hi = self.attract_rounds
        if self.attractor is not None and lo <= t < hi:
            center = np.asarray(self.attractor) * area
            wp = center[None] + rng.uniform(-0.03, 0.03, (n, 2)) * area
        else:
            wp = rng.uniform(0.0, area, (n, 2))
        v = rng.uniform(self.speed[0], self.speed[1], n)
        return np.clip(wp, 0.0, area), v

    def init(self, rng, pos, area):
        n = len(pos)
        self._wp, self._v = self._new_leg(0, rng, n, area)
        self._pause_left = np.zeros(n)

    def state_dict(self):
        if self._wp is None:
            return {"initialized": 0}
        return {"initialized": 1, "wp": np.asarray(self._wp),
                "v": np.asarray(self._v),
                "pause_left": np.asarray(self._pause_left)}

    def load_state_dict(self, d):
        if not int(d["initialized"]):
            self._wp = self._v = self._pause_left = None
            return
        self._wp = np.asarray(d["wp"])
        self._v = np.asarray(d["v"])
        self._pause_left = np.asarray(d["pause_left"])

    def step(self, t, rng, pos, area, dt):
        n = len(pos)
        # draw the round's candidate legs unconditionally so the rng
        # consumption (and thus determinism) is independent of arrivals
        new_wp, new_v = self._new_leg(t, rng, n, area)
        pause_draw = rng.uniform(0.0, 1.0, n)
        vec = self._wp - pos
        dist = np.linalg.norm(vec, axis=1)
        paused = self._pause_left > 0.0
        self._pause_left = np.maximum(self._pause_left - dt, 0.0)
        travel = np.where(paused, 0.0, self._v * dt)
        arrive = travel >= dist
        frac = np.where(dist > 1e-9, np.minimum(travel, dist)
                        / np.maximum(dist, 1e-9), 0.0)
        out = pos + vec * frac[:, None]
        self._wp = np.where(arrive[:, None], new_wp, self._wp)
        self._v = np.where(arrive, new_v, self._v)
        self._pause_left = np.where(
            arrive, self.pause * pause_draw, self._pause_left)
        return np.clip(out, 0.0, area)


class GaussMarkov(MobilityModel):
    """Gauss-Markov mobility: AR(1) velocity with boundary reflection."""

    def __init__(self, mean_speed: float = 15.0, alpha: float = 0.8,
                 sigma: float = 4.0):
        self.mean_speed = mean_speed
        self.alpha = alpha
        self.sigma = sigma
        self._v = None
        self._v_mean = None

    def init(self, rng, pos, area):
        n = len(pos)
        heading = rng.uniform(0.0, 2.0 * np.pi, n)
        dir_ = np.stack([np.cos(heading), np.sin(heading)], 1)
        self._v_mean = dir_ * self.mean_speed
        self._v = self._v_mean + rng.normal(0.0, self.sigma, (n, 2))

    def state_dict(self):
        if self._v is None:
            return {"initialized": 0}
        return {"initialized": 1, "v": np.asarray(self._v),
                "v_mean": np.asarray(self._v_mean)}

    def load_state_dict(self, d):
        if not int(d["initialized"]):
            self._v = self._v_mean = None
            return
        self._v = np.asarray(d["v"])
        self._v_mean = np.asarray(d["v_mean"])

    def step(self, t, rng, pos, area, dt):
        a = self.alpha
        w = rng.normal(0.0, 1.0, self._v.shape)
        self._v = a * self._v + (1.0 - a) * self._v_mean \
            + np.sqrt(max(1.0 - a * a, 0.0)) * self.sigma * w
        out = pos + self._v * dt
        # reflect at the field boundary (flip position, velocity, and the
        # mean heading so the process doesn't fight the wall)
        for lo, hi in ((0.0, area),):
            under, over = out < lo, out > hi
            out = np.where(under, 2 * lo - out, out)
            out = np.where(over, 2 * hi - out, out)
            flip = under | over
            self._v = np.where(flip, -self._v, self._v)
            self._v_mean = np.where(flip, -self._v_mean, self._v_mean)
        return np.clip(out, 0.0, area)
