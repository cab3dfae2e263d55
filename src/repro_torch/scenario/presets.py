"""Named scenario presets (the registry's built-ins), registered under the
same names as ``repro.scenario.presets``.

Mirrors the strategy presets in ``core/strategies.py``: each name maps to
a configured :class:`~repro_torch.scenario.dynamic.DynamicScenario`
(``static`` lives in ``scenario/base.py``).  Paper touchstones:
``campus_walk`` and ``vehicular`` realize the Sec. III mobility-driven
network evolution at pedestrian / vehicular timescales, ``flash_crowd``
the spatial+volume burst, ``label_shift`` pure concept drift
(Definition 1), and ``churn`` device availability dynamics; ``byzantine``, ``poisoned`` and
``stragglers`` are the threat presets, ``fuzzmix:<seed>`` a random
composition of all the ingredients.
"""
from __future__ import annotations

import numpy as np

from repro_torch.scenario.adversary import (ByzantineUpdate, Dropout,
                                            LabelPoison, Straggler)
from repro_torch.scenario.base import register_scenario
from repro_torch.scenario.drift_schedules import (ArrivalBurst, JoinLeave,
                                                  LabelRotation)
from repro_torch.scenario.dynamic import DynamicScenario
from repro_torch.scenario.mobility import GaussMarkov, RandomWaypoint


@register_scenario("campus_walk")
def campus_walk(arg: str = "") -> DynamicScenario:
    """Pedestrians on a campus: random-waypoint walking speeds, one-minute
    rounds, light mesh churn.  ``campus_walk:fast`` doubles the motion per
    round (shorter demo runs still see handovers)."""
    dt = 120.0 if arg == "fast" else 60.0
    return DynamicScenario(
        mobility=RandomWaypoint(speed=(0.8, 2.0)),
        area=1500.0, dt=dt, handover_margin_db=2.0,
        mesh_outage_p=0.02, wired_jitter=0.1)


@register_scenario("vehicular")
def vehicular(arg: str = "") -> DynamicScenario:
    """Vehicles on an urban grid: Gauss-Markov velocities around 18 m/s,
    half-minute rounds (~500 m of motion each), aggressive handover,
    noticeable mesh churn."""
    return DynamicScenario(
        mobility=GaussMarkov(mean_speed=18.0, alpha=0.75, sigma=5.0),
        area=2500.0, dt=30.0, handover_margin_db=1.0,
        mesh_outage_p=0.05, wired_jitter=0.15)


@register_scenario("flash_crowd")
def flash_crowd(arg: str = "") -> DynamicScenario:
    """A crowd converges on a hotspot in rounds 5-12 while its arrival
    volume triples: the floating aggregator has to chase the data."""
    return DynamicScenario(
        mobility=RandomWaypoint(speed=(1.0, 3.0), attractor=(0.82, 0.5),
                                attract_rounds=(5, 12)),
        schedules=(ArrivalBurst(start=5, length=7, factor=3.0),),
        area=1500.0, dt=90.0, handover_margin_db=2.0,
        mesh_outage_p=0.02, wired_jitter=0.1)


@register_scenario("label_shift")
def label_shift(arg: str = "") -> DynamicScenario:
    """Pure concept drift: static radio plane, labels rotate one class
    every ``period`` rounds (``label_shift:<period>``)."""
    period = int(arg) if arg else 4
    return DynamicScenario(
        mobility=None,
        schedules=(LabelRotation(period=period, shift=1),),
        wired_jitter=0.1)


@register_scenario("churn")
def churn(arg: str = "") -> DynamicScenario:
    """Device availability churn on top of slow pedestrian drift: UEs
    leave/rejoin round to round (their data streams keep evolving while
    offline)."""
    return DynamicScenario(
        mobility=RandomWaypoint(speed=(0.3, 1.0)),
        schedules=(JoinLeave(p_leave=0.15, p_return=0.45, min_active=2),),
        area=1500.0, dt=60.0, handover_margin_db=3.0,
        mesh_outage_p=0.03, wired_jitter=0.1)


# ------------------------------------------------- adversarial presets --

@register_scenario("byzantine")
def byzantine(arg: str = "") -> DynamicScenario:
    """Sign-flip byzantine UEs on a static radio plane:
    ``byzantine:<frac>`` compromises ``round(frac * N)`` evenly spaced
    UEs (default 0.2; ``byzantine:0`` is the clean twin with identical
    rng consumption, the acceptance-test baseline).  Pair with
    ``EngineOptions(robust_agg="trimmed_mean")`` to defend."""
    frac = float(arg) if arg else 0.2
    return DynamicScenario(
        mobility=None,
        schedules=(ByzantineUpdate(mode="sign_flip", frac=frac,
                                   scale=4.0),),
        wired_jitter=0.1)


@register_scenario("poisoned")
def poisoned(arg: str = "") -> DynamicScenario:
    """Label-flipping data poisoning (``poisoned:<frac>``, default 0.3)
    on a static radio plane: compromised UEs train on y -> C-1-y."""
    frac = float(arg) if arg else 0.3
    return DynamicScenario(
        mobility=None,
        schedules=(LabelPoison(frac=frac),),
        wired_jitter=0.1)


@register_scenario("stragglers")
def stragglers(arg: str = "") -> DynamicScenario:
    """Straggler-dominated edge: 30% of UEs compute at
    ``f_n / slowdown`` (``stragglers:<slowdown>``, default 4x) and every
    UE hard-drops i.i.d. with p=0.1, over slow pedestrian drift."""
    slowdown = float(arg) if arg else 4.0
    return DynamicScenario(
        mobility=RandomWaypoint(speed=(0.3, 1.0)),
        schedules=(Straggler(frac=0.3, slowdown=slowdown),
                   Dropout(p=0.1, min_active=1)),
        area=1500.0, dt=60.0, handover_margin_db=3.0,
        mesh_outage_p=0.02, wired_jitter=0.1)


@register_scenario("fuzzmix")
def fuzzmix(arg: str = "") -> DynamicScenario:
    """A randomly composed scenario — mobility x channel x drift x
    adversary — fully determined by the integer arg (``fuzzmix:<seed>``),
    so any composition replays from its name alone."""
    rng = np.random.RandomState(int(arg) if arg else 0)
    mobility = [
        None,
        RandomWaypoint(speed=(0.5, 2.0)),
        GaussMarkov(mean_speed=12.0, alpha=0.7, sigma=4.0),
    ][rng.randint(3)]
    pool = [
        lambda: LabelRotation(period=int(rng.randint(2, 6)),
                              shift=int(rng.randint(1, 12))),
        lambda: ArrivalBurst(start=int(rng.randint(0, 3)),
                             length=int(rng.randint(1, 4)),
                             factor=float(rng.uniform(0.5, 3.0))),
        lambda: JoinLeave(p_leave=float(rng.uniform(0.05, 0.25)),
                          p_return=float(rng.uniform(0.3, 0.7)),
                          min_active=2),
        lambda: ByzantineUpdate(
            mode=("sign_flip", "gauss")[rng.randint(2)],
            frac=float(rng.uniform(0.1, 0.35)),
            scale=float(rng.uniform(1.0, 6.0))),
        lambda: LabelPoison(frac=float(rng.uniform(0.1, 0.4))),
        lambda: Straggler(frac=float(rng.uniform(0.1, 0.5)),
                          slowdown=float(rng.uniform(2.0, 8.0))),
        lambda: Dropout(p=float(rng.uniform(0.05, 0.25)), min_active=1),
    ]
    picks = sorted(rng.choice(len(pool), size=rng.randint(1, 4),
                              replace=False))
    schedules = tuple(pool[i]() for i in picks)
    return DynamicScenario(
        mobility=mobility, schedules=schedules,
        area=float(rng.uniform(1000.0, 2500.0)),
        dt=float(rng.uniform(30.0, 120.0)),
        handover_margin_db=float(rng.uniform(1.0, 3.0)),
        mesh_outage_p=float(rng.uniform(0.0, 0.08)),
        wired_jitter=float(rng.uniform(0.05, 0.2)))
