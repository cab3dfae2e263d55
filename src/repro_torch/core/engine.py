"""The CE-FL orchestration engine.  Counterpart of ``repro.core.engine``
(the simulation and mesh executors and the round loop).

Each global round t (paper Secs. II+IV-VI):
  1. the :class:`~repro_torch.scenario.base.Scenario` evolves the world
     (mobility, handover, mesh churn, per-round rates, drifted per-UE
     data) and names the round's adversary events,
  2. the :class:`~repro_torch.core.api.DecisionStrategy` picks the plan
     w^t (offloading rho, compute settings f/z/gamma/m, floating
     aggregator I_s),
  3. data offloading is realized (UE -> BS -> DC partitions),
  4. every DPU runs FedProx local training (eqs. 5-10) through the
     executor: :class:`SimExecutor` (per DPU group, mini-batches drawn)
     or :class:`MeshExecutor` (one step over every live DPU, leading-slice
     mini-batches),
  5. the round's update corruptions are applied, then the accumulated
     gradients are aggregated at the floating aggregation DC (eq. 11),
     or FedNova / FedAvg for the baselines, or by the byzantine-robust
     trimmed mean / median (``EngineOptions.robust_agg``),
  6. delay / energy are charged per Sec. II-E and reported through
     :class:`~repro_torch.core.api.RoundReport` callbacks.

Where things live.  The control plane stays on the host: the plan, the
``(N, B)``-sized network arrays and the delay/energy math are float32 CPU
tensors (the JAX package pulls them to numpy every round too), and the
offloading split runs in numpy.  The ``cefl`` strategy's SCA solve is the
exception: it runs on the engine's ``device``, as the JAX package's jitted
solve runs on its default device, and hands back a CPU plan.  Everything
sized by the parameters or the data lives on the engine's ``device``: the
parameter planes, the staged data stacks, the mini-batch indices, the
gradients, the kernels' work and the eval pass.

Randomness.  The numpy ``RandomState`` streams (scenario ticks, rates,
offloading) match the JAX package bit for bit; the mini-batch draws and
the Gaussian update corruption come from one ``torch.Generator`` on
``device`` seeded from ``opts.seed`` where the JAX package uses a
``jax.random`` key chain, so the two differ there.  The corruption noise
is drawn only for live Gaussian targets, so a clean round consumes the
same draws as before.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import aggregation, fedprox
from repro_torch.core import strategies as _strategies  # noqa: F401  (registers)
from repro_torch.core.api import (DecisionContext, EngineOptions,
                                  RoundCallback, RoundPlan, RoundReport,
                                  RunResult, get_strategy, weighted_mean)
from repro_torch.core.round_step import CEFLHyper, build_cefl_round_step
from repro_torch.device import require_device
from repro_torch.kernels.plane import (as_plane, as_tree,
                                      tree_from_paths, tree_paths)
from repro_torch.network.costs import network_costs, round_delay, \
    round_energy
from repro_torch.scenario.base import get_scenario


# ------------------------------------------------------- offloading -----

def realize_offloading(rng, data_per_ue: List[dict], w, net):
    """Split each UE's round data per rho_nb / rho_bs into DPU datasets.

    Returns (ue_datasets, dc_datasets) as lists of {'x','y'} numpy dicts
    (None for a DC that received nothing).  The split conserves
    datapoints exactly: every input point lands at exactly one DPU, even
    in the all-offload edge case (each UE always keeps at least one point
    by clawing it back from its BS allocation) and the degenerate case
    where every rho_bs share floors to zero (the whole BS pool then goes
    to the DC with the largest rho share).  The floors take float32
    shares, as the JAX package does, so both split identically.
    """
    if isinstance(w, RoundPlan):
        w = w.to_w()
    N, B, S = net.dims
    rho_nb = np.asarray(w["rho_nb"], np.float32)
    rho_bs = np.asarray(w["rho_bs"], np.float32)
    bs_pool_x, bs_pool_y = [[] for _ in range(B)], [[] for _ in range(B)]
    ue_data = []
    for n, d in enumerate(data_per_ue):
        x, y = np.asarray(d["x"]), np.asarray(d["y"])
        D = len(y)
        if D == 0:
            ue_data.append({"x": x, "y": y})
            continue
        perm = rng.permutation(D)
        counts = np.floor(rho_nb[n] * D).astype(int)
        # all-offload guard: every UE keeps >= 1 point, taken back from
        # its largest BS allocation (rather than duplicating a point)
        excess = counts.sum() - (D - 1)
        while excess > 0:
            j = int(np.argmax(counts))
            take = min(excess, counts[j])
            counts[j] -= take
            excess -= take
        start = 0
        for b in range(B):
            take = perm[start:start + counts[b]]
            start += counts[b]
            if len(take):
                bs_pool_x[b].append(x[take])
                bs_pool_y[b].append(y[take])
        keep = perm[start:]
        ue_data.append({"x": x[keep], "y": y[keep]})
    dc_x, dc_y = [[] for _ in range(S)], [[] for _ in range(S)]
    for b in range(B):
        if not bs_pool_x[b]:
            continue
        x = np.concatenate(bs_pool_x[b])
        y = np.concatenate(bs_pool_y[b])
        perm = rng.permutation(len(y))
        counts = np.floor(rho_bs[b] * len(y)).astype(int)
        # BSs keep no data: the rounding remainder goes to the DC with the
        # largest rho share (covers the all-floored-to-zero pool case);
        # shave from the largest counts if a row ever over-allocates.
        rem = len(y) - counts.sum()
        while rem < 0:
            j = int(np.argmax(counts))
            give = min(-rem, counts[j])
            counts[j] -= give
            rem += give
        counts[int(np.argmax(rho_bs[b]))] += rem
        start = 0
        for s in range(S):
            take = perm[start:start + counts[s]]
            start += counts[s]
            if len(take):
                dc_x[s].append(x[take])
                dc_y[s].append(y[take])
    dc_data = []
    for s in range(S):
        if dc_x[s]:
            dc_data.append({"x": np.concatenate(dc_x[s]),
                            "y": np.concatenate(dc_y[s])})
        else:
            dc_data.append(None)
    return ue_data, dc_data


# -------------------------------------------------------- executor -----

def _plan_settings(plan: RoundPlan):
    gammas = np.maximum(np.rint(plan.gamma.numpy()), 1).astype(int)
    ms = np.clip(plan.m.numpy(), 0.05, 1.0)
    return gammas, ms


def live_dpus(datasets) -> list:
    """(DPU index, dataset) of every DPU that holds data this round."""
    return [(i, d) for i, d in enumerate(datasets)
            if d is not None and len(d["y"])]


def dpu_groups(plan: RoundPlan, live) -> Dict[tuple, list]:
    """Positions in ``live`` grouped by (gamma, m, mini-batch bucket): each
    group trains with one ``fedprox_accum`` launch per local step."""
    gammas, ms = _plan_settings(plan)
    groups: Dict[tuple, list] = {}
    for j, (i, d) in enumerate(live):
        bucket = fedprox._bucket(fedprox.batch_size(len(d["y"]), ms[i]))
        groups.setdefault((int(gammas[i]), float(ms[i]), bucket),
                          []).append(j)
    return groups


def _aggregate(params, results, agg: str, *, eta: float,
               theta: Optional[float], robust: str = "none",
               trim_frac: float = 0.1):
    weights = [r.num_examples for r in results]
    if robust != "none":
        # byzantine counter: coordinate-wise trimmed mean / median instead
        # of the weighted sum.  Weight-free, and theta (when not pinned)
        # is the UNWEIGHTED gamma mean, because the D_i a compromised
        # client reports are not trusted either.
        if agg == "fedavg":
            return aggregation.robust_fedavg_aggregate(
                [r.params for r in results], mode=robust,
                trim_frac=trim_frac)
        theta_val = float(theta) if (agg != "fednova"
                                     and theta is not None) \
            else float(np.mean([r.gamma for r in results]))
        return aggregation.robust_aggregate(
            params, [r.d_i for r in results], theta=theta_val, eta=eta,
            mode=robust, trim_frac=trim_frac)
    if agg == "fedavg":
        return aggregation.fedavg_aggregate(
            [r.params for r in results], weights)
    if agg == "fednova":
        return aggregation.fednova_aggregate(
            params, [r.d_i for r in results], weights,
            [r.gamma for r in results], eta=eta)
    wn = np.asarray(weights, float)
    wn = wn / wn.sum()
    theta_val = theta if theta is not None else float(
        np.sum(wn * np.array([r.gamma for r in results])))   # tau_eff
    return aggregation.aggregate(params, [r.d_i for r in results], weights,
                                 theta=theta_val, eta=eta)


def gaussian_noise(generator: torch.Generator):
    """``noise(like)``: a standard-normal tensor shaped like ``like``,
    drawn from ``generator`` (on ``like``'s device)."""
    def noise(like: torch.Tensor) -> torch.Tensor:
        return torch.randn(like.shape, generator=generator,
                           device=like.device, dtype=like.dtype)
    return noise


def corrupt_local_results(results, live, corrupt, anchor, noise):
    """Apply the round's update corruptions (``ScenarioEvents.corrupted``
    triples ``(ue, mode, scale)``) to the matching ``LocalResult``s, in
    place, between local training and aggregation.

    sign_flip: d_i -> -scale * d_i and params -> anchor - scale *
    (params - anchor) (the anchor-relative flip, so FedAvg model averaging
    sees the same attack direction eq. 11 does).  gauss: adds scale-std
    Gaussian noise to both, ``noise(d_i)`` then ``noise(params)`` per
    target in sorted order; ``noise`` is called only for gauss targets
    that are live this round (:func:`gaussian_noise` draws it from the
    round's generator; a test hands in the reference's draws).
    """
    by_dpu = {i: j for j, (i, _) in enumerate(live)}
    anchor_data = as_plane(anchor).data
    for ue, mode, scale in sorted(corrupt):
        if ue not in by_dpu:
            continue
        r = results[by_dpu[ue]]
        d, p = r.d_i.data, r.params.data
        if mode == "sign_flip":
            d = -scale * d
            p = anchor_data - scale * (p - anchor_data)
        elif mode == "gauss":
            d = d + scale * noise(d)
            p = p + scale * noise(p)
        else:
            raise ValueError(f"unknown corruption mode {mode!r}")
        r.d_i = r.d_i.with_data(d)
        r.params = r.params.with_data(p)


class SimExecutor:
    """Simulation backend: per-DPU FedProx on each DPU's own dataset, on
    the parameters' device.

    DPUs sharing (gamma, m, mini-batch bucket) train as one group: one
    batched loss/grad and one ``fedprox_accum`` launch per local step.
    Aggregation is one ``nova_aggregate`` launch over the stacked d_i
    planes (FedAvg averages the local models instead).

    A round whose live DPUs form ONE group under eq.-11 or FedNova
    aggregation runs as a single program (``fedprox.local_round_plane``):
    training + eq. 10 + eq. 11 and, when ``eval_fn`` is given, the eval
    pass on the new model.  Update corruption (``corrupt``) and robust
    aggregation (``robust_agg`` != "none", one ``robust_aggregate``
    launch) act between training and aggregation, so such rounds never
    fuse.
    """

    def run_round(self, params, plan: RoundPlan, datasets, *, loss_fn,
                  eta: float, mu: float, theta: Optional[float], agg: str,
                  generator: torch.Generator, eval_fn=None, corrupt=(),
                  robust_agg: str = "none", trim_frac: float = 0.1):
        """Returns ``(new_params, mean_loss, acc)``; ``acc`` is None unless
        the round fused its eval (the caller then evaluates)."""
        params = as_plane(params)
        live = live_dpus(datasets)
        if not live:
            return params, float("nan"), None
        groups = dpu_groups(plan, live)
        if (len(groups) == 1 and agg in ("cefl", "fednova")
                and not corrupt and robust_agg == "none"):
            (gamma, m, _bucket), idxs = next(iter(groups.items()))
            # tau_eff = sum_i p_i gamma_i degenerates to gamma here,
            # which is also FedNova's theta
            theta_val = float(theta) if (agg == "cefl"
                                         and theta is not None) \
                else float(gamma)
            Ds = [len(live[j][1]["y"]) for j in idxs]
            new_params, losses, acc = fedprox.local_round_plane(
                params, loss_fn, [live[j][1] for j in idxs],
                gamma=gamma, m_frac=m, eta=eta, mu=mu, generator=generator,
                theta=theta_val, eval_fn=eval_fn)
            return new_params, weighted_mean(list(losses), Ds), acc
        results = [None] * len(live)
        for (gamma, m, _bucket), idxs in groups.items():
            out = fedprox.local_train_batched(
                params, loss_fn, [live[j][1] for j in idxs],
                gamma=gamma, m_frac=m, eta=eta, mu=mu, generator=generator)
            for j, r in zip(idxs, out):
                results[j] = r
        if corrupt:
            corrupt_local_results(results, live, corrupt, params,
                                  gaussian_noise(generator))
        new_params = _aggregate(params, results, agg, eta=eta, theta=theta,
                                robust=robust_agg, trim_frac=trim_frac)
        mean_loss = weighted_mean([r.loss for r in results],
                                  [r.num_examples for r in results])
        return new_params, mean_loss, None


@dataclasses.dataclass
class MeshLayout:
    """How :class:`MeshExecutor` packs a round's live DPUs: their positions
    in the round's DPU list, dataset sizes D_i, the power-of-two batch
    bucket every dataset is zero-padded to, and their local iterations."""
    dpus: List[int]
    sizes: List[int]
    bucket: int
    gammas: np.ndarray

    @property
    def gamma_max(self) -> int:
        return int(self.gammas.max())


def mesh_layout(plan: RoundPlan, datasets) -> Optional[MeshLayout]:
    """The mesh packing of a round (None when no DPU holds data)."""
    live = live_dpus(datasets)
    if not live:
        return None
    gammas, _ = _plan_settings(plan)
    sizes = [len(d["y"]) for _, d in live]
    return MeshLayout(dpus=[i for i, _ in live], sizes=sizes,
                      bucket=fedprox._bucket(max(sizes)),
                      gammas=np.array([gammas[i] for i, _ in live]))


@dataclasses.dataclass
class MeshRound:
    """A round packed for the mesh step: its layout, the ``(n, 1, bucket,
    ...)`` batch and the ``meta`` of ``core.round_step``, on one device,
    and the theta applied outside the step."""
    layout: MeshLayout
    batch: dict
    meta: dict
    theta: float


@dataclasses.dataclass
class MeshExecutor:
    """Mesh backend: the paper loop through the SPMD round step
    (``core.round_step``).

    The live DPUs are packed on a leading DPU axis on the device (datasets
    zero-padded to a shared power-of-two bucket, the CE-FL mini-batch
    ratio applied as a leading-example mask), so one ``round_step`` call
    trains and aggregates every DPU: ``gamma_max`` ``fedprox_accum``
    launches and one ``nova_aggregate_stacked`` launch per round on the
    plane.  Differences from :class:`SimExecutor`: mini-batches are the
    deterministic leading slice, not random draws (the same at m = 1), so
    nothing is drawn; the reported loss is the unweighted DPU mean of the
    last local iteration; FedAvg model averaging, update corruption and
    robust aggregation have no form here.

    Steps are cached per (loss_fn, DPU count, bucket, gamma_max, mu, eta);
    theta is applied outside the step (``x + theta * (new - x)``), so a
    per-round tau_eff needs no new step.  ``use_plane`` (default) runs the
    plane form; False runs the tree form (plain torch, no kernel).
    """
    use_plane: bool = True
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    def _get_step(self, loss_fn, n_dpu, bucket, gamma_max, mu, eta):
        key = (loss_fn, n_dpu, bucket, gamma_max, mu, eta)
        if key not in self._cache:
            self._cache[key] = build_cefl_round_step(loss_fn, CEFLHyper(
                eta=eta, mu=mu, theta=1.0, gamma_max=gamma_max, n_micro=1))
        return self._cache[key]

    def stage(self, plan: RoundPlan, datasets, *, agg: str,
              theta: Optional[float], device) -> Optional["MeshRound"]:
        """Pack the round's live DPUs on ``device``: the zero-padded batch,
        the step's ``meta`` and the round's theta (tau_eff under
        ``fednova`` or when ``theta`` is None).  None when no DPU holds
        data."""
        layout = mesh_layout(plan, datasets)
        if layout is None:
            return None
        _, ms = _plan_settings(plan)
        bucket = layout.bucket
        # one zero-padded (n, n_micro=1, bucket, ...) stack per field
        batch = {}
        for name, first in datasets[layout.dpus[0]].items():
            first = torch.as_tensor(first)
            stack = torch.zeros((len(layout.dpus), 1, bucket)
                                + tuple(first.shape[1:]), dtype=first.dtype,
                                device=device)
            for j, (i, D) in enumerate(zip(layout.dpus, layout.sizes)):
                stack[j, 0, :D].copy_(torch.as_tensor(datasets[i][name]))
            batch[name] = stack
        # real examples sit first, so folding the pad into the mini-batch
        # ratio makes the leading-example mask select ceil(m_i * D_i) of
        # them and none of the padding
        m_eff = np.array([ms[i] * D / bucket
                          for i, D in zip(layout.dpus, layout.sizes)])
        w = np.asarray(layout.sizes, float)
        w = w / w.sum()
        if agg == "fednova" or theta is None:
            theta_val = float(np.sum(w * layout.gammas))      # tau_eff
        else:
            theta_val = float(theta)
        meta = {"gamma": torch.as_tensor(layout.gammas, dtype=torch.int32,
                                         device=device),
                "m_frac": torch.as_tensor(m_eff, dtype=torch.float32,
                                          device=device),
                "weight": torch.as_tensor(w, dtype=torch.float32,
                                          device=device)}
        return MeshRound(layout=layout, batch=batch, meta=meta,
                         theta=theta_val)

    def run_round(self, params, plan: RoundPlan, datasets, *, loss_fn,
                  eta: float, mu: float, theta: Optional[float], agg: str,
                  generator: Optional[torch.Generator] = None, eval_fn=None,
                  corrupt=(), robust_agg: str = "none",
                  trim_frac: float = 0.1):
        """Returns ``(new_params, mean_loss, None)``: the caller
        evaluates.  ``generator`` and ``eval_fn`` are not used (nothing
        is drawn, nothing fused)."""
        del generator, eval_fn, trim_frac
        if agg == "fedavg":
            raise NotImplementedError(
                "MeshExecutor aggregates accumulated gradients (eq. 11); "
                "FedAvg model averaging needs SimExecutor")
        if corrupt or robust_agg != "none":
            raise NotImplementedError(
                "update corruption / robust aggregation run between local "
                "training and aggregation, which the mesh round step does "
                "not expose; use SimExecutor")
        plane = as_plane(params)
        staged = self.stage(plan, datasets, agg=agg, theta=theta,
                            device=plane.data.device)
        if staged is None:
            return params, float("nan"), None
        layout, batch, meta = staged.layout, staged.batch, staged.meta
        n, theta_val = len(layout.dpus), staged.theta
        step = self._get_step(loss_fn, n, layout.bucket, layout.gamma_max,
                              mu, eta)
        if self.use_plane:
            stack = plane.broadcast(n)
            new_stack, metrics = step(
                stack.with_data(stack.data.contiguous()), batch, meta)
            # theta = 1 inside the step; the global update is rescaled here
            new_params = plane.with_data(
                plane.data + theta_val * (new_stack.data[0] - plane.data))
            return new_params, float(metrics["loss"]), None
        pairs = tree_paths(as_tree(params))
        stacked = tree_from_paths(
            [path for path, _ in pairs],
            [x.unsqueeze(0).expand((n,) + tuple(x.shape)).contiguous()
             for _, x in pairs])
        new_stack, metrics = step(stacked, batch, meta)
        new_params = tree_from_paths(
            [path for path, _ in pairs],
            [x + theta_val * (x1[0] - x) for (_, x), (_, x1)
             in zip(pairs, tree_paths(new_stack))])
        return new_params, float(metrics["loss"]), None


# ----------------------------------------------------------- engine -----

@dataclasses.dataclass
class LoopState:
    """The full mutable state of one orchestration run between rounds:
    the host ``RandomState``, the device ``torch.Generator`` of the
    mini-batch draws, the parameter plane and the run's accounting.
    ``loss_fn`` / ``eval_fn`` are behavior, not state."""
    rng: np.random.RandomState
    generator: torch.Generator
    params: object
    loss_fn: object = None
    eval_fn: object = None
    reports: List[RoundReport] = dataclasses.field(default_factory=list)
    cum_E: float = 0.0
    cum_D: float = 0.0
    plan: Optional[RoundPlan] = None
    prev_agg: Optional[int] = None
    t: int = 0
    stopped: bool = False
    last_acc: float = float("nan")


@dataclasses.dataclass
class StagedRound:
    """Host-side output of :meth:`Engine.begin_round`: everything the
    executor needs to run the device work of round ``t``."""
    t: int
    net_t: object
    D_bar: np.ndarray
    plan: RoundPlan
    datasets: list                 # ue_data + dc_data, one entry per DPU
    n_dc: int
    events: object
    t0: float


class Engine:
    """Drives the CE-FL loop with a pluggable strategy on one device.

    >>> engine = Engine(net, "greedy_data", consts=consts, ow=ow,
    ...                 opts=EngineOptions(rounds=8), device="cuda")
    >>> result = engine.run(online_ues, init_params=p0,
    ...                     loss_fn=classifier_loss, eval_fn=eval_fn)
    >>> result.final.acc, result.to_history()["loss"]

    ``device`` defaults to ``"cuda"``; a CPU run must be asked for with
    ``device="cpu"``, and a CUDA request without a card raises.
    """

    def __init__(self, net, strategy=None, *, consts, ow,
                 opts: Optional[EngineOptions] = None, scenario=None,
                 executor=None, callbacks: Sequence[RoundCallback] = (),
                 validate_plans: bool = True, device="cuda"):
        """``scenario``: a name from the scenario registry ("static",
        "byzantine:0.2", ...) or a Scenario instance; None takes
        ``opts.scenario``.  ``executor``: :class:`SimExecutor` (the
        default) or :class:`MeshExecutor`.  ``callbacks`` get each
        round's report; one returning True stops the run after that
        round.  ``validate_plans``: check every decided plan's
        feasibility (``RoundPlan.validate``)."""
        self.device = require_device(device)
        self.net = net
        self.opts = opts or EngineOptions()
        self.strategy = get_strategy(
            strategy if strategy is not None else self.opts.strategy)
        self.scenario = get_scenario(
            scenario if scenario is not None else self.opts.scenario)
        self.executor = executor if executor is not None else SimExecutor()
        self.callbacks: List[RoundCallback] = list(callbacks)
        self.validate_plans = validate_plans
        self.consts = consts
        self.ow = ow

    def on_round_end(self, callback: RoundCallback) -> RoundCallback:
        """Register a callback (usable as a decorator).  Returning True
        from a callback stops the run after the current round."""
        self.callbacks.append(callback)
        return callback

    def decide(self, net_t, D_bar, t: int,
               prev_plan: Optional[RoundPlan]) -> RoundPlan:
        """The strategy's plan for round ``t``.  ``D_bar`` reaches the
        strategy as a CPU tensor; ``cefl`` moves it to the engine's device
        (``ctx.device``) and solves there."""
        ctx = DecisionContext(round=t, consts=self.consts, ow=self.ow,
                              opts=self.opts, prev_plan=prev_plan,
                              device=self.device)
        plan = self.strategy.decide(
            net_t, torch.as_tensor(D_bar, dtype=torch.float32), ctx)
        if self.validate_plans:
            plan.validate(net_t)
        return plan

    # --- the round loop, exposed one round at a time -------------------
    #
    # Engine.run is init_loop + while + (begin_round, execute_round,
    # finish_round): host work, device work, accounting.

    @property
    def aggregation(self) -> str:
        return getattr(self.strategy, "aggregation", "cefl")

    @property
    def mu_effective(self) -> float:
        return self.opts.mu if getattr(self.strategy, "proximal", True) \
            else 0.0

    def init_loop(self, online_datasets, *, init_params, loss_fn=None,
                  eval_fn=None) -> LoopState:
        """Bind the scenario and build the round-0 loop state.
        ``init_params``: a dict tree of tensors or a ParamPlane; it is
        flattened onto a plane on the engine's device."""
        del online_datasets  # streams carry their own state
        plane = as_plane(init_params)
        plane = plane.with_data(plane.data.to(self.device))
        self.scenario.bind(self.net, self.opts)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.opts.seed)
        return LoopState(rng=np.random.RandomState(self.opts.seed),
                         generator=generator, params=plane,
                         loss_fn=loss_fn, eval_fn=eval_fn)

    def begin_round(self, state: LoopState, online_datasets) -> StagedRound:
        """Host side of round ``state.t``: scenario tick, plan decision,
        offloading realization.  Mutates ``state`` (rng, plan)."""
        t = state.t
        t0 = time.time()
        net_t, data_per_ue, events = self.scenario.step(
            t, online_datasets, state.rng)
        D_bar = np.array([len(d["y"]) for d in data_per_ue], float)
        if state.plan is None or t % self.opts.reoptimize_every == 0:
            state.plan = self.decide(net_t, D_bar, t, prev_plan=state.plan)
        ue_data, dc_data = realize_offloading(state.rng, data_per_ue,
                                              state.plan, net_t)
        return StagedRound(t=t, net_t=net_t, D_bar=D_bar, plan=state.plan,
                           datasets=ue_data + dc_data, n_dc=len(dc_data),
                           events=events, t0=t0)

    def should_eval(self, t: int) -> bool:
        every = max(1, self.opts.eval_every)
        return t % every == 0 or t == self.opts.rounds - 1

    def execute_round(self, state: LoopState, staged: StagedRound):
        """Device phase of round ``staged.t``: the executor call, with the
        round's update corruptions, the configured robust aggregation and,
        on eval-cadence rounds, the eval pass handed in.  Updates
        ``state.params`` and returns ``(mean_loss, acc)``; ``acc`` is None
        unless the round fused its eval."""
        opts = self.opts
        eval_fn = state.eval_fn if self.should_eval(staged.t) else None
        state.params, mean_loss, acc = self.executor.run_round(
            state.params, staged.plan, staged.datasets,
            loss_fn=state.loss_fn, eta=opts.eta, mu=self.mu_effective,
            theta=opts.theta, agg=self.aggregation,
            generator=state.generator, eval_fn=eval_fn,
            corrupt=staged.events.corrupted,
            robust_agg=opts.robust_agg, trim_frac=opts.trim_frac)
        return mean_loss, acc

    def finish_round(self, state: LoopState, staged: StagedRound,
                     mean_loss: float, acc: Optional[float] = None) -> \
            RoundReport:
        """Account the finished round: costs, eval (per the cadence),
        report, callbacks.  Advances ``state.t``."""
        plan = staged.plan
        w = plan.to_w()
        if staged.events.compute_scale:
            # stragglers: the plan's idealized f_n vs the realized rate,
            # charged through the Sec. II-E cost model (compute delay ~
            # 1/f_n, compute energy ~ f_n^2)
            w["f_n"] = w["f_n"] * torch.as_tensor(
                staged.events.compute_scale, dtype=torch.float32)
        costs = network_costs(w, staged.net_t, staged.D_bar)
        E = float(round_energy(costs, self.ow.xi3_sub))
        Dl = float(round_delay(costs))
        state.cum_E += E
        state.cum_D += Dl
        if acc is None:
            if self.should_eval(staged.t):
                with torch.no_grad():
                    acc = float(state.eval_fn(as_tree(state.params)))
            else:
                acc = state.last_acc
        state.last_acc = float(acc)
        gammas, ms = _plan_settings(plan)
        dc_data = staged.datasets[len(staged.datasets) - staged.n_dc:]
        report = RoundReport(
            round=staged.t, acc=float(acc), loss=mean_loss,
            energy=E, delay=Dl, cum_energy=state.cum_E,
            cum_delay=state.cum_D,
            aggregator=plan.aggregator,
            dc_points=tuple(0 if d is None else len(d["y"])
                            for d in dc_data),
            gamma_mean=float(gammas.mean()), m_mean=float(ms.mean()),
            plan=plan, wall_time=time.time() - staged.t0,
            handovers=tuple(staged.events.handovers),
            aggregator_moved=(state.prev_agg is not None
                              and plan.aggregator != state.prev_agg),
            active_ues=int(staged.events.active_ues))
        state.prev_agg = plan.aggregator
        state.reports.append(report)
        for cb in self.callbacks:
            if cb(report) is True:
                state.stopped = True
        state.t += 1
        return report

    def run(self, online_datasets, *, init_params, loss_fn,
            eval_fn) -> RunResult:
        """Run the full orchestration loop.

        ``online_datasets``: one ``core.drift.OnlineDataset`` per UE.
        ``loss_fn(params, batch, example_weights)``: params with a leading
        DPU axis, ``(G, B, ...)`` batch, ``(G, B)`` weights -> ``(G,)``
        losses.  ``eval_fn(params) -> accuracy``.
        """
        state = self.init_loop(online_datasets, init_params=init_params,
                               loss_fn=loss_fn, eval_fn=eval_fn)
        return self.run_loop(state, online_datasets)

    def run_loop(self, state: LoopState, online_datasets) -> RunResult:
        """Drive an initialized LoopState to completion."""
        while state.t < self.opts.rounds and not state.stopped:
            staged = self.begin_round(state, online_datasets)
            mean_loss, acc = self.execute_round(state, staged)
            self.finish_round(state, staged, mean_loss, acc)
        return RunResult(reports=state.reports, params=as_tree(state.params))

