"""Declarative experiment specs: the paper's result grid as data.
Counterpart of ``repro.experiments.spec``.

An :class:`ExperimentSpec` is a frozen, JSON-round-trippable description
of ONE experiment cell — model + data + network dims + scenario +
strategy + engine hyper-parameters + the seed list — from which
``repro_torch.experiments.run`` reproduces a result without any
hand-assembled script.

Single source of truth for seeds: the per-run seed drives the engine's
generators, the scenario evolution (through the engine rng), and the
per-UE online-data streams.  ``ExperimentSpec.engine_options(seed)`` /
``run_seeds`` are the only derivation points.

Named presets live in ``presets.py`` and are resolved through the same
string-registry pattern as strategies and scenarios::

    spec = get_experiment("quickstart")
    spec = spec.override(**{"engine.rounds": 4, "seeds": (0, 1)})
    assert from_json(to_json(spec)) == spec

The port's specs carry the fields the port runs: the classifier and LM
models, and the engine fields of the port's ``EngineOptions``.  A spec
file the reference wrote loads here: its ``engine.kernel_backend`` is
accepted at the reference's default ``"auto"`` and dropped (kernels
dispatch by the tensor's device), and any other value raises
``ValueError`` on every path (``from_dict``, ``from_json``,
``override``, the CLI's ``--set``).  ``engine.mesh_shape`` shards the
fused round over a ``(dpu, rows)`` rank mesh of the initialised default
group (``torchrun ... run NAME --set mesh_shape=2,2``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.api import EngineOptions


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """What trains.  ``kind="classifier"`` is the paper's FL workload
    (``repro_torch.models.classifier``); ``kind="lm"`` is the mesh-native
    LM path (``repro_torch.experiments.lm``)."""
    kind: str = "classifier"
    # classifier fields
    input_shape: Tuple[int, ...] = (14, 14, 1)
    hidden: Tuple[int, ...] = (64,)
    num_classes: int = 10
    # lm fields (batch layout of the mesh round)
    arch: str = "mamba2-130m"
    reduced: bool = True
    batch: int = 8
    seq: int = 256
    n_dpu: int = 2
    n_micro: int = 1
    gamma: int = 2


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """The synthetic pool + per-UE online streams (paper App. G)."""
    pool: int = 6000
    pool_seed: int = 0            # the pool is shared across the sweep
    mean_arrivals: float = 300.0
    std_arrivals: float = 30.0
    labels_per_ue: int = 5
    drift_labels: bool = False
    eval_examples: int = 500


@dataclasses.dataclass(frozen=True)
class NetworkSpec:
    """Topology dims (paper Sec. VI: 20/10/5 full size).  The topology
    seed is spec-level: one network, many seeded runs over it."""
    num_ue: int = 6
    num_bs: int = 3
    num_dc: int = 2
    topology_seed: int = 0


@dataclasses.dataclass(frozen=True)
class ConstsSpec:
    """ML constants (paper Table III / Algs. 4-6).  ``mode="fixed"``
    takes the values below; ``mode="estimate"`` runs the one-shot
    pre-training estimation on probe UEs (seeded off the spec, not the
    run) and pads the per-UE Theta/sigma with UE means for the DCs."""
    mode: str = "fixed"
    L: float = 4.0
    theta: float = 2.0
    sigma: float = 1.0
    zeta1: float = 2.0
    zeta2: float = 1.0
    estimate_iters: int = 3
    probe_seed: int = 99


@dataclasses.dataclass(frozen=True)
class ObjectiveSpec:
    """Objective weights of problem P (xi1..xi3, drift Delta).  ``T`` is
    derived from ``engine.rounds`` at build time."""
    xi1: float = 1.0
    xi2: float = 1e-2
    xi3: float = 1e-3
    drift: float = 0.3


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    """Loop hyper-parameters — the frozen mirror of
    :class:`~repro_torch.core.api.EngineOptions` minus strategy / scenario
    / seed, which live on the ExperimentSpec (seeds as the sweep axis)."""
    rounds: int = 8
    eta: float = 0.1
    mu: float = 0.01
    theta: Optional[float] = None
    reoptimize_every: int = 1
    solver_outer: int = 2
    distributed_solver: bool = False
    solver_backend: str = "jit"
    gamma_default: int = 2
    m_default: float = 0.5
    rate_jitter: float = 0.15
    eval_every: int = 1
    sanitize: bool = False          # NaN/Inf check of the params after
                                    # every round (repro_torch.analysis)
    robust_agg: str = "none"        # byzantine counter: "none" /
                                    # "trimmed_mean" / "median"
    trim_frac: float = 0.1
    mesh_shape: Optional[Tuple[int, int]] = None
                                    # ('dpu', 'rows') rank-mesh split for
                                    # the sharded plane round; None ->
                                    # single-device
    cohort_size: Optional[int] = None
                                    # per-round client sampling (K UEs drawn
                                    # per round); None -> full participation

    def __post_init__(self):
        # JSON and the CLI give a list or "2,2": store the tuple
        if self.mesh_shape is not None:
            object.__setattr__(self, "mesh_shape",
                               _int_pair(self.mesh_shape))


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One experiment cell; ``seeds`` is the sweep axis."""
    name: str = "custom"
    model: ModelSpec = ModelSpec()
    data: DataSpec = DataSpec()
    network: NetworkSpec = NetworkSpec()
    consts: ConstsSpec = ConstsSpec()
    objective: ObjectiveSpec = ObjectiveSpec()
    engine: EngineSpec = EngineSpec()
    strategy: str = "cefl"
    scenario: str = "static"
    seeds: Tuple[int, ...] = (0,)

    # ------------------------------------------------ seed derivation --

    def engine_options(self, seed: int) -> EngineOptions:
        """THE seed derivation point: one run seed feeds the engine's
        generators, the scenario (via the engine rng), and — through
        ``build.ExperimentContext.make_ues`` — the per-UE data streams."""
        e = self.engine
        return EngineOptions(
            rounds=e.rounds, eta=e.eta, mu=e.mu, theta=e.theta,
            strategy=self.strategy, scenario=self.scenario,
            reoptimize_every=e.reoptimize_every,
            solver_outer=e.solver_outer,
            distributed_solver=e.distributed_solver,
            solver_backend=e.solver_backend,
            gamma_default=e.gamma_default, m_default=e.m_default,
            rate_jitter=e.rate_jitter, seed=int(seed),
            eval_every=e.eval_every, sanitize=e.sanitize,
            robust_agg=e.robust_agg,
            trim_frac=e.trim_frac, mesh_shape=e.mesh_shape,
            cohort_size=e.cohort_size)

    @property
    def run_seeds(self) -> Tuple[int, ...]:
        return tuple(int(s) for s in self.seeds)

    # ----------------------------------------------------- overriding --

    def override(self, **updates) -> "ExperimentSpec":
        """Dotted-path functional update::

            spec.override(**{"engine.rounds": 4, "strategy": "fixed:0",
                             "seeds": (0, 1)})
        """
        spec = self
        for path, value in updates.items():
            parts = path.split(".")
            spec = _replace_path(spec, parts, value)
        return spec

    # ----------------------------------------------------------- json --

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentSpec":
        return _from_dict(cls, d)


def _int_pair(value) -> Tuple[int, int]:
    """A mesh shape from a tuple, a list or a "d,r" string."""
    if isinstance(value, str):
        value = value.replace(",", " ").split()
    d, r = (int(v) for v in value)
    return d, r


# The reference's EngineSpec field with no counterpart: kernel dispatch
# follows the tensor's device (repro_torch.kernels.ops), so the value
# that means the same, the reference's default, is accepted and dropped.
_KERNEL_BACKEND = "kernel_backend"


def _drop_kernel_backend(value) -> None:
    if value != "auto":
        raise ValueError(
            f"engine.kernel_backend={value!r} has no counterpart in the "
            "port, by the device rule: kernel dispatch follows the tensor's "
            "device (a CUDA tensor launches the hand-written kernel, a CPU "
            "tensor runs the plain version) and there is no backend knob; "
            "only the reference's default 'auto' is accepted (and dropped)")


def _replace_path(obj, parts: List[str], value):
    field_types = {f.name: f for f in dataclasses.fields(obj)}
    head = parts[0]
    if isinstance(obj, EngineSpec) and parts == [_KERNEL_BACKEND]:
        _drop_kernel_backend(value)
        return obj
    if head not in field_types:
        raise KeyError(f"{type(obj).__name__} has no field {head!r} "
                       f"(available: {sorted(field_types)})")
    if len(parts) == 1:
        value = _coerce_value(getattr(obj, head), value,
                              field_types[head].type)
        return dataclasses.replace(obj, **{head: value})
    return dataclasses.replace(
        obj, **{head: _replace_path(getattr(obj, head), parts[1:], value)})


def _coerce_value(current, value, annotation=""):
    """Match the current field's shape: tuples stay tuples, and numeric
    strings (CLI ``--set``) coerce to the current type; a string for an
    unset tuple field (``mesh_shape=2,2``) gives a tuple of ints."""
    if current is None and isinstance(value, str) \
            and "Tuple" in str(annotation):
        return tuple(int(v) for v in value.replace(",", " ").split())
    if isinstance(current, tuple) and not isinstance(value, tuple):
        if isinstance(value, str):
            value = [v for v in value.replace(",", " ").split() if v]
        return tuple(type(current[0])(v) if current else v for v in value) \
            if current else tuple(value)
    if isinstance(value, str) and not isinstance(current, str):
        if isinstance(current, bool):
            return value.lower() in ("1", "true", "yes", "on")
        if isinstance(current, int):
            return int(value)
        if isinstance(current, float) or current is None:
            return float(value)
    return value


def _from_dict(cls, d: dict):
    if cls is EngineSpec and _KERNEL_BACKEND in d:
        d = dict(d)
        _drop_kernel_backend(d.pop(_KERNEL_BACKEND))
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if dataclasses.is_dataclass(f.default):
            kwargs[f.name] = _from_dict(type(f.default), v)
        elif isinstance(f.default, tuple) and v is not None:
            kwargs[f.name] = tuple(
                tuple(x) if isinstance(x, list) else x for x in v)
        else:
            kwargs[f.name] = v
    extra = set(d) - {f.name for f in dataclasses.fields(cls)}
    if extra:
        raise KeyError(f"unknown {cls.__name__} fields {sorted(extra)}")
    return cls(**kwargs)


def to_json(spec: ExperimentSpec, *, indent: int = 1) -> str:
    return json.dumps(spec.to_dict(), indent=indent)


def from_json(s: str) -> ExperimentSpec:
    return ExperimentSpec.from_dict(json.loads(s))


# -------------------------------------------------------- registry -----

_EXPERIMENT_REGISTRY: Dict[str, Callable[[], ExperimentSpec]] = {}


def register_experiment(name: str):
    """Decorator registering a preset factory: ``@register_experiment(
    "quickstart")`` over a zero-arg callable returning a spec."""
    def deco(factory):
        if name in _EXPERIMENT_REGISTRY:
            raise ValueError(f"experiment {name!r} already registered")
        _EXPERIMENT_REGISTRY[name] = factory
        return factory
    return deco


def available_experiments() -> List[str]:
    return sorted(_EXPERIMENT_REGISTRY)


def get_experiment(spec) -> ExperimentSpec:
    """Resolve a preset name / an ExperimentSpec instance / a dict."""
    if isinstance(spec, ExperimentSpec):
        return spec
    if isinstance(spec, dict):
        return ExperimentSpec.from_dict(spec)
    try:
        factory = _EXPERIMENT_REGISTRY[spec]
    except KeyError:
        raise KeyError(
            f"unknown experiment {spec!r}; available: "
            f"{available_experiments()}") from None
    out = factory()
    if out.name != spec:
        out = dataclasses.replace(out, name=spec)
    return out
