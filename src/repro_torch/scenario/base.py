"""Scenario protocol + registry: per-round evolution of the CE-FL world.
Counterpart of ``repro.scenario.base`` (the protocol, the registry and the
static world).

A :class:`Scenario` advances the network (a fresh ``Network`` with
re-derived rates, same dims and cfg) and the data (per-UE round datasets)
each round, and reports what happened as :class:`ScenarioEvents`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Protocol, Sequence, Tuple, \
    runtime_checkable


@dataclasses.dataclass(frozen=True)
class ScenarioEvents:
    """What the environment did this round (consumed by ``RoundReport``)."""
    round: int
    handovers: Tuple[Tuple[int, int, int], ...] = ()  # (ue, old_bs, new_bs)
    joined: Tuple[int, ...] = ()                      # UEs back online
    left: Tuple[int, ...] = ()                        # UEs gone offline
    mesh_down: Tuple[Tuple[int, int], ...] = ()       # DC-DC links in outage
    active_ues: int = -1
    # adversary channels (scenario/adversary.py): update corruptions the
    # executor applies between local training and aggregation, and the
    # per-UE realized compute-rate scaling finish_round charges through
    # the cost model (empty tuples = clean round)
    corrupted: Tuple[Tuple[int, str, float], ...] = ()  # (ue, mode, scale)
    compute_scale: Tuple[float, ...] = ()               # (N,) f_n scaling


@runtime_checkable
class Scenario(Protocol):
    """Pluggable environment dynamics.

    ``bind`` attaches the scenario to a base network + engine options and
    resets all internal state; ``step`` advances one global round and
    returns ``(net_t, data_per_ue, events)``.  ``step`` must call
    ``ds.step()`` on every online dataset exactly once per round and draw
    any scenario randomness from the passed ``rng`` (the engine's seeded
    ``RandomState``), so a run is a pure function of the seed.
    """

    def bind(self, net, opts) -> None:
        ...

    def step(self, t: int, online_datasets: Sequence, rng):
        ...


_SCENARIO_REGISTRY: Dict[str, Callable[..., Scenario]] = {}


def register_scenario(name: str):
    """Class/function decorator: ``@register_scenario("static")``.  The
    factory is called with the optional ``:``-suffix of the spec string."""
    if ":" in name:
        raise ValueError(f"scenario name {name!r} must not contain ':'")

    def deco(factory):
        if name in _SCENARIO_REGISTRY:
            raise ValueError(f"scenario {name!r} already registered")
        _SCENARIO_REGISTRY[name] = factory
        return factory
    return deco


def available_scenarios() -> List[str]:
    return sorted(_SCENARIO_REGISTRY)


def get_scenario(spec) -> Scenario:
    """Resolve ``"name"`` / ``"name:arg"`` / a scenario instance."""
    if not isinstance(spec, str):
        return spec
    name, _, arg = spec.partition(":")
    try:
        factory = _SCENARIO_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; available: "
            f"{available_scenarios()}") from None
    return factory(arg) if arg else factory()


@register_scenario("static")
class StaticScenario:
    """The frozen world: per-round lognormal rate jitter
    (``Network.resample_rates``) and untouched online datasets.  The
    jitter is the ``static:<jitter>`` argument when given (the fuzzer
    draws it), else ``opts.rate_jitter``."""

    def __init__(self, jitter=""):
        self._jitter_arg = float(jitter) if jitter != "" else None
        self._net = None
        self._jitter = None

    def bind(self, net, opts):
        self._net = net
        self._jitter = self._jitter_arg if self._jitter_arg is not None \
            else opts.rate_jitter

    def step(self, t, online_datasets, rng):
        data = [ds.step() for ds in online_datasets]
        net_t = self._net.resample_rates(rng, self._jitter)
        return net_t, data, ScenarioEvents(round=t,
                                           active_ues=len(online_datasets))

    # full-state resume: the static world keeps no mutable state beyond
    # what bind() derives; the jitter draws live on the engine rng
    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, d: dict) -> None:
        pass
