"""JSONL trace sink: the experiment layer's flight recorder.  Counterpart
of ``repro.experiments.trace``.

``run`` writes one JSON line per (run, round) through a :class:`TraceSink`
— machine-readable round metrics.  Records are plain dicts; the canonical
round record comes from :func:`round_record` / :func:`report_from_record`
(exact round trip, asserted by tests).
"""
from __future__ import annotations

import json
import os
from typing import IO, Optional

import numpy as np

from repro_torch.core.api import RoundPlan, RoundReport


def plan_to_lists(plan: Optional[RoundPlan]) -> Optional[dict]:
    if plan is None:
        return None
    return {k: np.asarray(v).tolist() for k, v in plan.to_w().items()}


def plan_from_lists(d: Optional[dict]) -> Optional[RoundPlan]:
    if d is None:
        return None
    return RoundPlan.from_w({k: np.asarray(v, np.float32)
                             for k, v in d.items()})


def report_to_record(r: RoundReport) -> dict:
    """A RoundReport as a JSON-able dict (float values survive exactly:
    python floats are binary64 ⊃ the f32 metrics)."""
    return {
        "round": int(r.round), "acc": float(r.acc), "loss": float(r.loss),
        "energy": float(r.energy), "delay": float(r.delay),
        "cum_energy": float(r.cum_energy), "cum_delay": float(r.cum_delay),
        "aggregator": int(r.aggregator),
        "dc_points": [int(x) for x in r.dc_points],
        "gamma_mean": float(r.gamma_mean), "m_mean": float(r.m_mean),
        "plan": plan_to_lists(r.plan),
        "wall_time": float(r.wall_time),
        "handovers": [[int(a), int(b), int(c)]
                      for a, b, c in r.handovers],
        "aggregator_moved": bool(r.aggregator_moved),
        "active_ues": int(r.active_ues),
    }


def report_from_record(d: dict) -> RoundReport:
    return RoundReport(
        round=int(d["round"]), acc=float(d["acc"]), loss=float(d["loss"]),
        energy=float(d["energy"]), delay=float(d["delay"]),
        cum_energy=float(d["cum_energy"]),
        cum_delay=float(d["cum_delay"]),
        aggregator=int(d["aggregator"]),
        dc_points=tuple(int(x) for x in d["dc_points"]),
        gamma_mean=float(d["gamma_mean"]), m_mean=float(d["m_mean"]),
        plan=plan_from_lists(d.get("plan")),
        wall_time=float(d["wall_time"]),
        handovers=tuple((int(a), int(b), int(c))
                        for a, b, c in d["handovers"]),
        aggregator_moved=bool(d["aggregator_moved"]),
        active_ues=int(d["active_ues"]))


def round_record(name: str, seed: int, report: RoundReport, *,
                 executor: str = "", with_plan: bool = False) -> dict:
    """The JSONL line a sweep executor writes per (run, round).  Plans
    are omitted by default (they dominate line size); ``with_plan=True``
    keeps them for full-fidelity traces."""
    rec = report_to_record(report)
    if not with_plan:
        rec.pop("plan")
    rec.update(kind="round", experiment=name, seed=int(seed))
    if executor:
        rec["executor"] = executor
    return rec


class TraceSink:
    """Append-only JSONL writer.  ``TraceSink(None)`` is a no-op sink, so
    executors write unconditionally.  Lines are flushed as written —
    a killed run's trace is complete up to its last finished round."""

    def __init__(self, path=None, *, append: bool = False):
        self.path = os.fspath(path) if path is not None else None
        self._fh: Optional[IO] = None
        if self.path:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "a" if append else "w")

    def write(self, record: dict) -> None:
        if self._fh is None:
            return
        self._fh.write(json.dumps(record) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "TraceSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_trace(path) -> list:
    """All records of a JSONL trace file."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
