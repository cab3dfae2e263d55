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
offloading split runs in numpy, on index arrays (every ``Engine`` keeps
the host heap its rows free, see :func:`keep_host_heap`).  The ``cefl`` strategy's SCA solve is the
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

import ctypes
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import aggregation, fedprox
from repro_torch.core import strategies as _strategies  # noqa: F401  (registers)
from repro_torch.core.api import (DecisionContext, EngineOptions,
                                  RoundCallback, RoundPlan, RoundReport,
                                  RunResult, get_strategy, weighted_mean)
from repro_torch.core.round_step import CEFLHyper, build_cefl_round_step
from repro_torch.device import require_device
from repro_torch.kernels.plane import (ParamPlane, as_plane, as_tree,
                                      tree_from_paths, tree_paths)
from repro_torch.network.costs import network_costs, round_delay, \
    round_energy
from repro_torch.network.topology import subnetwork
from repro_torch.scenario.base import get_scenario
from repro_torch.sharding import plane as shard_plane
from repro_torch.sharding.mesh import plane_mesh


# ------------------------------------------------------- offloading -----

def keep_host_heap() -> bool:
    """Have the C library keep the heap memory a round frees for the next
    round, rather than hand it back to the kernel.

    A paper-width round allocates about 125 MB of UE rows and as much
    again in the split's datasets, and frees both before the next round.
    glibc by default returns large blocks to the kernel (``mmap``'d blocks
    on free, the heap's top once it passes the trim threshold), so every
    round faults all of those pages in again; on an H100 machine's host
    that took more than half of the split's time.  Here every block comes
    from the heap (``M_MMAP_MAX`` 0) and up to 1 GiB may stay free at its
    top (``M_TRIM_THRESHOLD``).  Process-wide; returns False where the C
    library has no ``mallopt``.
    """
    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (OSError, AttributeError, TypeError):
        return False
    mallopt.argtypes = (ctypes.c_int, ctypes.c_int)
    mallopt.restype = ctypes.c_int
    M_TRIM_THRESHOLD, M_MMAP_MAX = -1, -4
    return bool(mallopt(M_TRIM_THRESHOLD, 1 << 30)) and \
        bool(mallopt(M_MMAP_MAX, 0))


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

    The split itself runs on index arrays: a point is its row in the
    UEs' rows laid end to end, and the BS pools and DC shares are
    permuted and cut as such ids, with the same draws in the same order
    as a split of the rows would take.  Only the datasets are allocated:
    a UE's kept rows in one gather, a DC's one contributing UE at a time
    (a gather of that UE's share, put in place).  The innermost open
    tracing span counts ``offload_bytes`` (the rows this call allocates:
    the datasets and those shares) and ``round_bytes`` (the UEs' input
    rows).
    """
    if isinstance(w, RoundPlan):
        w = w.to_w()
    N, B, S = net.dims
    rho_nb = np.asarray(w["rho_nb"], np.float32)
    rho_bs = np.asarray(w["rho_bs"], np.float32)
    xs = [np.asarray(d["x"]) for d in data_per_ue]
    ys = [np.asarray(d["y"]) for d in data_per_ue]
    first = np.cumsum([0] + [len(y) for y in ys])
    bs_pool = [[] for _ in range(B)]
    ue_data = []
    for n, (x, y) in enumerate(zip(xs, ys)):
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
            if counts[b]:
                bs_pool[b].append(first[n] + perm[start:start + counts[b]])
            start += counts[b]
        keep = perm[start:]
        ue_data.append({"x": x[keep], "y": y[keep]})
    dc_ids = [[] for _ in range(S)]
    for b in range(B):
        if not bs_pool[b]:
            continue
        pool = np.concatenate(bs_pool[b])
        perm = rng.permutation(len(pool))
        counts = np.floor(rho_bs[b] * len(pool)).astype(int)
        # BSs keep no data: the rounding remainder goes to the DC with the
        # largest rho share (covers the all-floored-to-zero pool case);
        # shave from the largest counts if a row ever over-allocates.
        rem = len(pool) - counts.sum()
        while rem < 0:
            j = int(np.argmax(counts))
            give = min(-rem, counts[j])
            counts[j] -= give
            rem += give
        counts[int(np.argmax(rho_bs[b]))] += rem
        start = 0
        for s in range(S):
            if counts[s]:
                dc_ids[s].append(pool[perm[start:start + counts[s]]])
            start += counts[s]
    dc_data, taken = [], 0
    for parts in dc_ids:
        if not parts:
            dc_data.append(None)
            continue
        # the DC's ids sorted, so grouped by UE: its rows
        # positions[cuts[n]:cuts[n + 1]] take UE n's rows ids[...] - first[n]
        ids = np.concatenate(parts)
        positions = np.argsort(ids)
        ids = ids[positions]
        cuts = np.searchsorted(ids, first)
        srcs = np.flatnonzero(np.diff(cuts))
        dc = {}
        for key, arrays in (("x", xs), ("y", ys)):
            out = np.empty((len(ids),) + arrays[srcs[0]].shape[1:],
                           np.result_type(*(arrays[n] for n in srcs)))
            for n in srcs:
                a, z = cuts[n], cuts[n + 1]
                rows = arrays[n][ids[a:z] - first[n]]
                out[positions[a:z]] = rows
                taken += rows.nbytes
            dc[key] = out
        dc_data.append(dc)
    tracing.count("round_bytes", sum(a.nbytes for a in xs + ys))
    tracing.count("offload_bytes", taken + sum(
        d[k].nbytes for d in ue_data + dc_data if d is not None
        for k in ("x", "y")))
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


def fuses(groups: Dict[tuple, list], agg: str, corrupt,
          robust_agg: str) -> bool:
    """Whether a round runs as ONE fused program: its live DPUs form one
    group, the aggregation is eq. 11 or FedNova, and nothing acts between
    training and aggregation (no corruption, no robust reduce)."""
    return (len(groups) == 1 and agg in ("cefl", "fednova")
            and not corrupt and robust_agg == "none")


def fused_theta(agg: str, theta: Optional[float], gamma: int) -> float:
    """theta of a fused round: tau_eff = sum_i p_i gamma_i degenerates to
    the group's gamma, which is also FedNova's theta."""
    return float(theta) if (agg == "cefl" and theta is not None) \
        else float(gamma)


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


@dataclasses.dataclass
class SimExecutor:
    """Simulation backend: per-DPU FedProx on each DPU's own dataset, on
    the parameters' device.

    DPUs sharing (gamma, m, mini-batch bucket) train as one group: one
    batched loss/grad and one ``fedprox_accum`` launch per local step.
    Aggregation is one ``nova_aggregate`` launch over the stacked d_i
    planes (FedAvg averages the local models instead).

    A grouped round whose live DPUs form ONE group under eq.-11 or
    FedNova aggregation runs as a single program
    (``fedprox.local_round_plane``): training + eq. 10 + eq. 11 and, when
    ``eval_fn`` is given, the eval pass on the new model.  Update
    corruption (``corrupt``) and robust aggregation (``robust_agg`` !=
    "none", one ``robust_aggregate`` launch) act between training and
    aggregation, so such rounds never fuse (:func:`fuses`).

    With ``mesh_shape`` = (dpu, rows), the fused round runs sharded over
    that rank mesh (``sharding.plane.local_round_plane_sharded``): the DPU
    group data-parallel over 'dpu', the plane rows over 'rows'.  Every
    rank runs the engine loop from the same seed (torchrun style), so the
    ranks stage the same round; rounds that cannot fuse run the
    single-device paths on every rank, redundantly.
    """
    mesh_shape: Optional[tuple] = None   # (dpu, rows) rank split

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
        if fuses(groups, agg, corrupt, robust_agg):
            (gamma, m, _bucket), idxs = next(iter(groups.items()))
            Ds = [len(live[j][1]["y"]) for j in idxs]
            kw = dict(gamma=gamma, m_frac=m, eta=eta, mu=mu,
                      generator=generator,
                      theta=fused_theta(agg, theta, gamma), eval_fn=eval_fn)
            group = [live[j][1] for j in idxs]
            if self.mesh_shape is None:
                new_params, losses, acc = fedprox.local_round_plane(
                    params, loss_fn, group, **kw)
            else:
                new_params, losses, acc = \
                    shard_plane.local_round_plane_sharded(
                        params, loss_fn, group,
                        mesh=plane_mesh(self.mesh_shape), **kw)
            return new_params, weighted_mean(list(losses), Ds), acc
        results = [None] * len(live)
        for (gamma, m, _bucket), idxs in groups.items():
            out = fedprox.local_train_batched(
                params, loss_fn, [live[j][1] for j in idxs],
                gamma=gamma, m_frac=m, eta=eta, mu=mu, generator=generator)
            for j, r in zip(idxs, out):
                results[j] = r
        return self._aggregate_results(
            params, results, live, agg=agg, eta=eta, theta=theta,
            generator=generator, corrupt=corrupt, robust_agg=robust_agg,
            trim_frac=trim_frac)

    @staticmethod
    def _aggregate_results(params, results, live, *, agg, eta, theta,
                           generator, corrupt, robust_agg, trim_frac):
        """The round's corruptions, then the aggregation of the local
        results; returns ``(new_params, mean_loss, None)``."""
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

    With ``mesh_shape`` = (dpu, rows), the plane form runs sharded over
    that rank mesh (``sharding.plane.build_sharded_round_step``): each
    rank holds its (dpu, rows) block of the replica stack.  Allclose to
    the single-device step, the reference's contract.  The tree form
    ignores it.
    """
    use_plane: bool = True
    mesh_shape: Optional[tuple] = None   # (dpu, rows) rank split
    _cache: dict = dataclasses.field(default_factory=dict, repr=False)

    def build_step(self, micro_loss_fn, hyper: CEFLHyper):
        """The round step for ``micro_loss_fn(params, microbatch, mask)``
        in the batched convention of ``core.round_step`` (params with a
        leading DPU axis -> ``(n,)`` losses), for a caller that drives
        the rounds itself (``experiments.lm.run_lm``).  Nothing is
        compiled and nothing donated: the caller drops its reference to
        the old params when the step returns."""
        return build_cefl_round_step(micro_loss_fn, hyper)

    def _get_step(self, loss_fn, n_dpu, bucket, gamma_max, mu, eta):
        key = (loss_fn, n_dpu, bucket, gamma_max, mu, eta)
        if key not in self._cache:
            hyper = CEFLHyper(eta=eta, mu=mu, theta=1.0,
                              gamma_max=gamma_max, n_micro=1)
            if self.use_plane and self.mesh_shape is not None:
                self._cache[key] = shard_plane.build_sharded_round_step(
                    loss_fn, hyper, plane_mesh(self.mesh_shape))
            else:
                self._cache[key] = build_cefl_round_step(loss_fn, hyper)
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
        # SimExecutor's zero-padded (n, bucket, ...) stack per field, with
        # the step's n_micro = 1 axis
        batch = {name: stack.unsqueeze(1) for name, stack in
                 fedprox._stack_data([datasets[i] for i in layout.dpus],
                                     layout.sizes, device).items()}
        # real examples sit first, so folding the pad into the mini-batch
        # ratio makes the leading-example mask select ceil(m_i * D_i) of
        # them and none of the padding
        m_eff = np.array([ms[i] * D / layout.bucket
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


# ---------------------------------------------------- cohort sampling -----

def _gather_plan(plan: RoundPlan, cohort: np.ndarray, n_ue: int) -> RoundPlan:
    """Restrict a full-population plan to the cohort rows (the warm-start
    view handed to the solver, and the costing view of off-cadence
    rounds)."""
    idx = torch.as_tensor(cohort, dtype=torch.long)
    g, m = plan.gamma, plan.m
    return dataclasses.replace(
        plan, rho_nb=plan.rho_nb[idx], f_n=plan.f_n[idx],
        gamma=torch.cat([g[:n_ue][idx], g[n_ue:]]),
        m=torch.cat([m[:n_ue][idx], m[n_ue:]]),
        I_nb=plan.I_nb[idx], I_bn=plan.I_bn[:, idx])


def _scatter_plan(sub: RoundPlan, cohort: np.ndarray, net,
                  opts: EngineOptions) -> RoundPlan:
    """Embed a cohort plan back into a full-population RoundPlan.

    Non-cohort UEs sit the round out: zero offloading (they hold no round
    data anyway), idle CPU frequency ``f_min``, the default (gamma, m)
    settings, and rate-argmax one-hot associations, so every field still
    satisfies :meth:`RoundPlan.validate` at the full dims.
    """
    N, B, S = net.dims
    K = int(cohort.shape[0])
    rho_nb = np.zeros((N, B), np.float32)
    rho_nb[cohort] = sub.rho_nb.numpy()
    f_n = np.full(N, net.cfg.f_min, np.float32)
    f_n[cohort] = sub.f_n.numpy()
    gamma = np.full(N + S, float(opts.gamma_default), np.float32)
    sg = sub.gamma.numpy()
    gamma[:N][cohort] = sg[:K]
    gamma[N:] = sg[K:]
    m = np.full(N + S, float(opts.m_default), np.float32)
    sm = sub.m.numpy()
    m[:N][cohort] = sm[:K]
    m[N:] = sm[K:]
    I_nb = np.eye(B, dtype=np.float32)[
        np.argmax(np.asarray(net.R_nb), axis=1)]
    I_nb[cohort] = sub.I_nb.numpy()
    I_bn = np.zeros((B, N), np.float32)
    I_bn[np.argmax(np.asarray(net.R_bn), axis=0), np.arange(N)] = 1.0
    I_bn[:, cohort] = sub.I_bn.numpy()
    return dataclasses.replace(
        sub, rho_nb=torch.from_numpy(rho_nb), f_n=torch.from_numpy(f_n),
        gamma=torch.from_numpy(gamma), m=torch.from_numpy(m),
        I_nb=torch.from_numpy(I_nb), I_bn=torch.from_numpy(I_bn))


# ----------------------------------------------------------- engine -----

def _rng_state_dict(rng: np.random.RandomState) -> dict:
    """A numpy ``RandomState`` state as array/scalar leaves (MT19937)."""
    kind, keys, pos, has_gauss, cached = rng.get_state()
    if kind != "MT19937":
        raise ValueError(f"unexpected RandomState kind {kind!r}")
    return {"keys": np.asarray(keys), "pos": int(pos),
            "has_gauss": int(has_gauss), "cached": float(cached)}


def _rng_from_state_dict(d: dict) -> np.random.RandomState:
    rng = np.random.RandomState()
    rng.set_state(("MT19937", np.asarray(d["keys"], np.uint32),
                   int(d["pos"]), int(d["has_gauss"]), float(d["cached"])))
    return rng


@dataclasses.dataclass
class LoopState:
    """The full mutable state of one orchestration run between rounds:
    the host ``RandomState``, the device ``torch.Generator`` of the
    mini-batch draws, the parameter plane and the run's accounting, so a
    run can be advanced one round at a time, checkpointed mid-run
    (:meth:`state_dict`) and resumed bit-exactly.  ``loss_fn`` /
    ``eval_fn`` are behavior, not state."""
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

    def state_dict(self) -> dict:
        """Array/scalar leaves of the loop state (reports excluded: the
        metric trace serializes as JSON records at the experiments layer,
        ``repro_torch.experiments.runstate``).  ``generator`` is the
        ``torch.Generator`` state, whose form is the device type's
        (``device_type``); the plane is copied to the CPU."""
        plane = as_plane(self.params)
        plan = {} if self.plan is None else \
            {k: v.numpy() for k, v in self.plan.to_w().items()}
        return {
            "t": int(self.t),
            "cum_E": float(self.cum_E), "cum_D": float(self.cum_D),
            "prev_agg": -1 if self.prev_agg is None else int(self.prev_agg),
            "last_acc": float(self.last_acc),
            "stopped": int(self.stopped),
            "rng": _rng_state_dict(self.rng),
            "generator": self.generator.get_state(),
            "device_type": self.generator.device.type,
            "params_plane": plane.data.detach().to("cpu", copy=True),
            "plan": plan,
        }

    def load_state_dict(self, d: dict) -> None:
        """Restore :meth:`state_dict`'s leaves.  A state resumes on the
        device type that wrote it (a generator's state has that device's
        form): another device type raises, naming both."""
        here = self.generator.device.type
        if d["device_type"] != here:
            raise ValueError(
                f"the loop state was written on device type "
                f"{d['device_type']!r} and cannot resume on {here!r}: a "
                f"checkpoint resumes on the device type that wrote it")
        self.t = int(d["t"])
        self.cum_E = float(d["cum_E"])
        self.cum_D = float(d["cum_D"])
        self.prev_agg = None if int(d["prev_agg"]) < 0 else \
            int(d["prev_agg"])
        self.last_acc = float(d["last_acc"])
        self.stopped = bool(int(d["stopped"]))
        self.rng = _rng_from_state_dict(d["rng"])
        self.generator.set_state(torch.as_tensor(d["generator"]))
        plane = as_plane(self.params)
        data = d["params_plane"]
        if not isinstance(data, torch.Tensor):      # numpy: copied
            data = torch.from_numpy(np.array(data, dtype=np.float32))
        self.params = ParamPlane(data=data.to(plane.data.device),
                                 spec=plane.spec)
        self.plan = RoundPlan.from_w(
            {k: np.array(v) for k, v in d["plan"].items()}) \
            if d["plan"] else None


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
    t0: float = 0.0                # time.perf_counter() at begin_round
    span: object = None            # the open engine.round span's token
    # --- per-round client sampling (EngineOptions.cohort_size) ---
    cohort: Optional[np.ndarray] = None   # sorted drawn UE indices, or None
    sub_net: object = None                # topology.subnetwork view
    sub_plan: Optional[RoundPlan] = None  # the cohort-dims plan (costing)


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
        default, sharded over ``opts.mesh_shape`` when it is set) or
        :class:`MeshExecutor`.  ``callbacks`` get each
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
        self.executor = executor if executor is not None else \
            SimExecutor(mesh_shape=self.opts.mesh_shape)
        self.callbacks: List[RoundCallback] = list(callbacks)
        self.validate_plans = validate_plans
        self.consts = consts
        self.ow = ow
        keep_host_heap()

    def on_round_end(self, callback: RoundCallback) -> RoundCallback:
        """Register a callback (usable as a decorator).  Returning True
        from a callback stops the run after the current round."""
        self.callbacks.append(callback)
        return callback

    def decide(self, net_t, D_bar, t: int,
               prev_plan: Optional[RoundPlan], *, consts=None) -> RoundPlan:
        """The strategy's plan for round ``t``.  ``D_bar`` reaches the
        strategy as a CPU tensor; ``cefl`` moves it to the engine's device
        (``ctx.device``) and solves there.  ``consts`` overrides the
        engine's MLConstants for this call: the cohort path hands in
        constants gathered to the cohort's per-DPU rows."""
        ctx = DecisionContext(round=t,
                              consts=self.consts if consts is None
                              else consts,
                              ow=self.ow, opts=self.opts,
                              prev_plan=prev_plan, device=self.device)
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

    def _cohort_consts(self, n_ue: int, cohort: np.ndarray):
        """MLConstants with the per-DPU arrays gathered to the cohort's
        (K + S) rows (scalar / mis-sized fields pass through)."""
        c = self.consts

        def gather(a):
            a = np.asarray(a)
            if a.ndim == 0 or a.shape[0] < n_ue:
                return a
            return np.concatenate([a[:n_ue][cohort], a[n_ue:]])

        return dataclasses.replace(c, theta_i=gather(c.theta_i),
                                   sigma_i=gather(c.sigma_i))

    def begin_round(self, state: LoopState, online_datasets) -> StagedRound:
        """Host side of round ``state.t``: scenario tick, cohort draw,
        plan decision, offloading realization.  Mutates ``state`` (rng,
        plan).  Opens the round's ``engine.round`` span, which
        :meth:`finish_round` closes."""
        t0 = time.perf_counter()
        token = tracing.begin("engine.round", round=state.t)
        try:
            staged = self._begin_round(state, online_datasets)
        except BaseException:
            tracing.end(token)
            raise
        staged.t0, staged.span = t0, token
        return staged

    def _begin_round(self, state: LoopState, online_datasets) -> StagedRound:
        opts = self.opts
        t = state.t
        with tracing.span("scenario.step"):
            net_t, data_per_ue, events = self.scenario.step(
                t, online_datasets, state.rng)
        N = len(data_per_ue)
        cohort = sub_net = sub_plan = None
        if opts.cohort_size is not None and opts.cohort_size < N:
            # per-round client sampling: K UEs drawn uniformly without
            # replacement; the rest observe no round data, so the
            # executors' live-DPU filter drops them before any device
            # work and the solver sees only the (K, B, S) subproblem.
            # The rng draw happens ONLY on this branch, so cohort-off
            # runs keep their seeded traces bit-identical.
            if opts.distributed_solver:
                raise ValueError(
                    "cohort_size is incompatible with distributed_solver: "
                    "the cohort subnetwork has no consensus graph")
            cohort = np.sort(state.rng.choice(N, int(opts.cohort_size),
                                              replace=False))
            mask = np.zeros(N, bool)
            mask[cohort] = True
            data_per_ue = [d if mask[n] else
                           {k: np.asarray(v)[:0] for k, v in d.items()}
                           for n, d in enumerate(data_per_ue)]
            sub_net = subnetwork(net_t, cohort)
        D_bar = np.array([len(d["y"]) for d in data_per_ue], float)
        if state.plan is None or t % opts.reoptimize_every == 0:
            if cohort is None:
                state.plan = self.decide(net_t, D_bar, t,
                                         prev_plan=state.plan)
            else:
                # gather -> solve the K-UE subproblem -> scatter
                sub_prev = None if state.plan is None else \
                    _gather_plan(state.plan, cohort, N)
                sub_plan = self.decide(
                    sub_net, D_bar[cohort], t, prev_plan=sub_prev,
                    consts=self._cohort_consts(N, cohort))
                state.plan = _scatter_plan(sub_plan, cohort, net_t, opts)
                if self.validate_plans:
                    state.plan.validate(net_t)
        elif cohort is not None:
            sub_plan = _gather_plan(state.plan, cohort, N)
        with tracing.span("engine.offload"):
            ue_data, dc_data = realize_offloading(state.rng, data_per_ue,
                                                  state.plan, net_t)
        return StagedRound(t=t, net_t=net_t, D_bar=D_bar, plan=state.plan,
                           datasets=ue_data + dc_data, n_dc=len(dc_data),
                           events=events, cohort=cohort,
                           sub_net=sub_net, sub_plan=sub_plan)

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
        report, callbacks.  Closes the round's ``engine.round`` span and
        advances ``state.t``."""
        plan = staged.plan
        scale = tuple(staged.events.compute_scale)
        if staged.cohort is not None:
            # cohort round: charge the K-UE subproblem, not all N UEs'
            # model-upload paths (non-cohort UEs transmit nothing)
            w = staged.sub_plan.to_w()
            cost_net = staged.sub_net
            cost_D = staged.D_bar[staged.cohort]
            if scale:
                scale = tuple(np.asarray(scale)[staged.cohort])
        else:
            w = plan.to_w()
            cost_net = staged.net_t
            cost_D = staged.D_bar
        if scale:
            # stragglers: the plan's idealized f_n vs the realized rate,
            # charged through the Sec. II-E cost model (compute delay ~
            # 1/f_n, compute energy ~ f_n^2)
            w["f_n"] = w["f_n"] * torch.as_tensor(scale,
                                                  dtype=torch.float32)
        costs = network_costs(w, cost_net, cost_D)
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
        wall = time.perf_counter() - staged.t0
        tracing.end(staged.span)
        report = RoundReport(
            round=staged.t, acc=float(acc), loss=mean_loss,
            energy=E, delay=Dl, cum_energy=state.cum_E,
            cum_delay=state.cum_D,
            aggregator=plan.aggregator,
            dc_points=tuple(0 if d is None else len(d["y"])
                            for d in dc_data),
            gamma_mean=float(gammas.mean()), m_mean=float(ms.mean()),
            plan=plan, wall_time=wall,
            handovers=tuple(staged.events.handovers),
            aggregator_moved=(state.prev_agg is not None
                              and plan.aggregator != state.prev_agg),
            active_ues=int(staged.events.active_ues))
        if self.opts.sanitize:
            # deferred import: the analysis package is a debug aid, not
            # part of the engine's import-time surface
            from repro_torch.analysis.sanitize import check_finite
            check_finite(state.params, f"params after round {staged.t}")
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
        """Drive an initialized LoopState to completion.

        The reference runs this loop under a ``jax.random`` key-reuse
        detector when ``opts.sanitize`` is set.  The port has no
        counterpart: its draws come from one ``torch.Generator`` a run
        (``state.generator``), which advances on every draw and has no
        key to consume twice.  ``finish_round`` keeps the sanitizer's
        NaN/Inf check."""
        while state.t < self.opts.rounds and not state.stopped:
            staged = self.begin_round(state, online_datasets)
            mean_loss, acc = self.execute_round(state, staged)
            self.finish_round(state, staged, mean_loss, acc)
        return RunResult(reports=state.reports, params=as_tree(state.params))

