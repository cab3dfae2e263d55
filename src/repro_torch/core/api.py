"""Typed orchestration API for CE-FL (paper Secs. II+IV-VI).  Counterpart
of ``repro.core.api``:

* :class:`RoundPlan` — the network-aware decision w^t (offloading rho,
  compute settings f/z/gamma/m, aggregator I_s, link allocations) as a
  frozen, validated dataclass of float32 CPU tensors.
* :class:`RoundReport` — what one global round produced.
* :class:`RunResult` — a whole run: the report sequence plus final params.
* :class:`DecisionStrategy` — the pluggable "given the network and the
  data profile, pick w^t" protocol, with a string-keyed registry.

The execution side lives in ``repro_torch.core.engine``; built-in
strategies in ``repro_torch.core.strategies``.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, List, Optional, Protocol, Sequence,
                    Tuple, runtime_checkable)

import numpy as np
import torch

from repro_torch.sharding.mesh import mesh_dims

# Decision-variable keys, in the canonical order of the decision dict `w`
# (repro_torch.network.costs docstring).
PLAN_KEYS: Tuple[str, ...] = (
    "rho_nb", "rho_bs", "f_n", "z_s", "gamma", "m",
    "I_s", "I_nb", "I_bn", "R_bs", "delta_A", "delta_R",
)


@dataclasses.dataclass
class EngineOptions:
    """Hyper-parameters of the orchestration loop."""
    rounds: int = 20
    eta: float = 0.05
    mu: float = 0.01
    theta: Optional[float] = None   # None -> sum_i p_i gamma_i (tau_eff),
                                    # the paper's "compensating" scaling
    strategy: str = "greedy_data"   # any name in available_strategies()
    scenario: str = "static"        # environment dynamics (any name in
                                    # repro_torch.scenario.base's registry)
    reoptimize_every: int = 1
    solver_outer: int = 4           # SCA outer iterations of ``cefl``
    distributed_solver: bool = False   # centralized is faster for sims
    solver_backend: str = "jit"     # the one solver (the name of the
                                    # reference's batched backend); "ref"
                                    # raises: the numpy oracle stays in
                                    # the JAX package
    gamma_default: int = 2
    m_default: float = 0.5
    rate_jitter: float = 0.15
    seed: int = 0
    eval_every: int = 1             # eval cadence: eval_fn runs on rounds
                                    # t % eval_every == 0 and the last
                                    # round; off-cadence rounds carry the
                                    # last measured accuracy forward
    sanitize: bool = False          # runtime sanitizer
                                    # (repro_torch.analysis): a NaN/Inf
                                    # check of the aggregated params after
                                    # every round.  Debug aid: one host
                                    # sync a round, keep off in benchmarks
    robust_agg: str = "none"        # byzantine-robust aggregation:
                                    # "none" (weighted eq. 11), or
                                    # "trimmed_mean" / "median", the
                                    # unweighted coordinate-wise reduce
                                    # over the DPU stack
                                    # (core.aggregation.robust_aggregate)
    trim_frac: float = 0.1          # trim fraction per side for
                                    # robust_agg="trimmed_mean" (k =
                                    # min(floor(n*frac), (n-1)//2))
    mesh_shape: Optional[Tuple[int, int]] = None
                                    # (dpu, rows) rank-mesh split for the
                                    # sharded parameter plane
                                    # (repro_torch.sharding.plane): data-
                                    # parallel over the DPU stack x FSDP
                                    # rows, over the first dpu*rows ranks
                                    # of the initialised default group.
                                    # None -> single-device execution
    cohort_size: Optional[int] = None
                                    # per-round client sampling: K UEs drawn
                                    # uniformly without replacement each
                                    # round; the others sit out (no data, no
                                    # solver rows, no cost).  None/K >= N ->
                                    # full participation

    def __post_init__(self):
        if self.mesh_shape is not None:
            # raises without a process group or past the world's size
            self.mesh_shape = mesh_dims(self.mesh_shape)


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """The decision w^t of one global round (executable, i.e. indicators
    already rounded to one-hot).  All leaves are float32 CPU tensors."""
    rho_nb: torch.Tensor     # (N, B) UE -> BS offload fractions
    rho_bs: torch.Tensor     # (B, S) BS -> DC dispersion (rows on simplex)
    f_n: torch.Tensor        # (N,)   UE CPU frequencies
    z_s: torch.Tensor        # (S,)   DC per-machine processing rates
    gamma: torch.Tensor      # (N+S,) local SGD iterations per DPU
    m: torch.Tensor          # (N+S,) mini-batch ratios per DPU
    I_s: torch.Tensor        # (S,)   one-hot floating-aggregator choice
    I_nb: torch.Tensor       # (N, B) one-hot UE uplink BS association
    I_bn: torch.Tensor       # (B, N) one-hot BS downlink association (cols)
    R_bs: torch.Tensor       # (B, S) wired BS->DC rate allocation
    delta_A: torch.Tensor    # ()     aggregation-phase delay budget
    delta_R: torch.Tensor    # ()     broadcast-phase delay budget

    @classmethod
    def from_w(cls, w: Dict) -> "RoundPlan":
        """Build from a decision dict (extra keys ignored); leaves on
        another device (the ``cefl`` solve's) are copied to the CPU."""
        missing = [k for k in PLAN_KEYS if k not in w]
        if missing:
            raise KeyError(f"decision dict missing keys {missing}")
        return cls(**{k: torch.as_tensor(w[k], dtype=torch.float32).cpu()
                      for k in PLAN_KEYS})

    def to_w(self) -> Dict:
        """The dict view (what greedy/costs consume)."""
        return {k: getattr(self, k) for k in PLAN_KEYS}

    @property
    def aggregator(self) -> int:
        """Index of the floating aggregation DC (argmax of I_s)."""
        return int(np.argmax(self.I_s.numpy()))

    def replace(self, **updates) -> "RoundPlan":
        return dataclasses.replace(
            self, **{k: torch.as_tensor(v, dtype=torch.float32)
                     for k, v in updates.items()})

    def validate(self, net=None, *, atol: float = 1e-4) -> "RoundPlan":
        """Check the simplex/box/one-hot feasibility of an executable plan.

        Raises ``ValueError`` listing every violated condition; returns
        ``self`` so calls can be chained.
        """
        errs: List[str] = []
        rho_nb = self.rho_nb.numpy()
        rho_bs = self.rho_bs.numpy()
        if rho_nb.min() < -atol:
            errs.append(f"rho_nb has negative entries (min {rho_nb.min()})")
        if (rho_nb.sum(axis=1) > 1 + atol).any():
            errs.append("rho_nb row sums exceed 1 (eq. 55)")
        if rho_bs.min() < -atol:
            errs.append(f"rho_bs has negative entries (min {rho_bs.min()})")
        if np.abs(rho_bs.sum(axis=1) - 1.0).max() > atol:
            errs.append("rho_bs rows must lie on the simplex (eq. 56)")

        def _one_hot(x, axis, name):
            x = x.numpy()
            if np.abs(x.sum(axis=axis) - 1.0).max() > atol or \
                    np.abs(x * (1.0 - x)).max() > atol:
                errs.append(f"{name} is not one-hot (eqs. 61-62)")

        _one_hot(self.I_s, 0, "I_s")
        _one_hot(self.I_nb, 1, "I_nb")
        _one_hot(self.I_bn, 0, "I_bn")
        gamma = self.gamma.numpy()
        m = self.m.numpy()
        if (gamma <= 0).any():
            errs.append("gamma must be positive (eq. 59)")
        if (m <= 0).any() or (m > 1 + atol).any():
            errs.append("m must lie in (0, 1] (eq. 58)")
        if net is not None:
            N, B, S = net.dims
            shapes = {"rho_nb": (N, B), "rho_bs": (B, S), "f_n": (N,),
                      "z_s": (S,), "gamma": (N + S,), "m": (N + S,),
                      "I_s": (S,), "I_nb": (N, B), "I_bn": (B, N),
                      "R_bs": (B, S)}
            for k, want in shapes.items():
                got = tuple(getattr(self, k).shape)
                if got != want:
                    errs.append(f"{k} shape {got} != {want} for dims "
                                f"N={N} B={B} S={S}")
            f_n = self.f_n.numpy()
            if f_n.min() < net.cfg.f_min - atol or \
                    f_n.max() > net.cfg.f_max + atol:
                errs.append("f_n outside [f_min, f_max] (eq. 57)")
        if errs:
            raise ValueError("invalid RoundPlan: " + "; ".join(errs))
        return self


@dataclasses.dataclass(frozen=True)
class RoundReport:
    """Everything one global round produced (paper Sec. II-E accounting)."""
    round: int
    acc: float               # eval_fn(params) after aggregation
    loss: float              # example-weighted mean local training loss
                             # over all gamma steps of the active DPUs
    energy: float            # round energy (J), eq. 44 terms c-e
    delay: float             # round delay (s), delta_A + delta_R
    cum_energy: float
    cum_delay: float
    aggregator: int          # DC index of the floating aggregation point
    dc_points: Tuple[int, ...]   # datapoints that landed at each DC
    gamma_mean: float
    m_mean: float
    plan: Optional[RoundPlan] = None
    wall_time: float = 0.0   # seconds spent in this round (train + eval)
    # --- environment dynamics (filled by the scenario) ---
    handovers: Tuple[Tuple[int, int, int], ...] = ()
                             # UE-BS re-associations, each (ue, old, new)
    aggregator_moved: bool = False
                             # floating aggregation point migrated vs the
                             # previous round's plan
    active_ues: int = -1     # UEs that contributed data


@dataclasses.dataclass
class RunResult:
    """A full orchestration run: per-round reports + final model."""
    reports: List[RoundReport]
    params: Any = None

    def __len__(self):
        return len(self.reports)

    @property
    def final(self) -> RoundReport:
        return self.reports[-1]

    def series(self, field: str) -> list:
        return [getattr(r, field) for r in self.reports]

    def to_history(self) -> Dict[str, list]:
        """The per-round series as one dict (the plots' schema)."""
        return {
            "round": self.series("round"),
            "acc": self.series("acc"),
            "loss": self.series("loss"),
            "energy": self.series("energy"),
            "delay": self.series("delay"),
            "aggregator": self.series("aggregator"),
            "cum_energy": self.series("cum_energy"),
            "cum_delay": self.series("cum_delay"),
            "dc_points": [list(r.dc_points) for r in self.reports],
            "gamma_mean": self.series("gamma_mean"),
            "m_mean": self.series("m_mean"),
        }


@dataclasses.dataclass(frozen=True)
class DecisionContext:
    """Read-only context handed to a strategy's ``decide``."""
    round: int
    consts: Any                       # core.convergence.MLConstants
    ow: Any                           # solver.objective.ObjectiveWeights
    opts: EngineOptions
    prev_plan: Optional[RoundPlan] = None   # warm start
    device: Any = None                # the engine's device: where ``cefl``
                                      # solves (None: D_bar's device)


@runtime_checkable
class DecisionStrategy(Protocol):
    """Pluggable network-aware decision maker.

    Optional class attributes consumed by the Engine:
      * ``aggregation``: "cefl" (eq. 11 scaled-gradient), "fednova", or
        "fedavg" (model averaging).  Default "cefl".
      * ``proximal``: whether local training uses the FedProx mu.
        Default True.
    """

    def decide(self, net, D_bar, ctx: DecisionContext) -> RoundPlan:
        ...


_STRATEGY_REGISTRY: Dict[str, Callable[..., DecisionStrategy]] = {}


def register_strategy(name: str):
    """Class decorator: ``@register_strategy("greedy_data")``.  The factory
    is called with the (optional) ``:``-suffix of the spec string, e.g.
    ``"fixed:2"`` -> ``factory("2")``."""
    if ":" in name:
        raise ValueError(f"strategy name {name!r} must not contain ':'")

    def deco(factory):
        if name in _STRATEGY_REGISTRY:
            raise ValueError(f"strategy {name!r} already registered")
        _STRATEGY_REGISTRY[name] = factory
        return factory
    return deco


def available_strategies() -> List[str]:
    return sorted(_STRATEGY_REGISTRY)


def get_strategy(spec) -> DecisionStrategy:
    """Resolve ``"name"`` / ``"name:arg"`` / a strategy instance."""
    if not isinstance(spec, str):
        return spec
    name, _, arg = spec.partition(":")
    try:
        factory = _STRATEGY_REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown strategy {name!r}; available: "
            f"{available_strategies()}") from None
    return factory(arg) if arg else factory()


RoundCallback = Callable[[RoundReport], Optional[bool]]


def weighted_mean(values: Sequence[float], weights: Sequence[float]) -> float:
    w = np.asarray(weights, float)
    if w.sum() <= 0:
        return float("nan")
    return float(np.sum(np.asarray(values, float) * w) / w.sum())
