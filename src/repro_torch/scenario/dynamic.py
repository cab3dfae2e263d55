"""DynamicScenario: the full per-round world evolution (paper Sec. III).
Counterpart of ``repro.scenario.dynamic``: numpy, drawing the same numbers
from the engine's ``RandomState`` in the same order, so both packages
evolve identical worlds.

Each global round, in a fixed order (so the run is a pure function of the
engine seed):

  1. drift schedules transform the per-UE round data (label rotation,
     arrival bursts, UE join/leave),
  2. the mobility model advances UE positions on the 2-D field,
  3. UE<->BS channel gains are re-derived from the new distances
     (path loss x squared-Rayleigh fading) and pushed through the
     eq. 12-13 Shannon model into fresh ``R_nb`` / ``R_bn``,
  4. UE-BS serving associations are re-evaluated with a handover
     hysteresis margin on the mean (path-loss-only) channel; handovers
     update ``subnet_of_ue`` and the consensus-graph UE rows,
  5. the DC server mesh churns: each DC-DC link is independently in
     outage with ``mesh_outage_p`` (rate x ``mesh_outage_factor``, edge
     dropped from the consensus graph, ring connectivity preserved), and
     the wired rates get the usual lognormal congestion jitter.

The evolved network is a plain ``Network`` with identical cfg and dims.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.network.topology import Network, pathloss_gain, shannon_rate
from repro_torch.scenario.base import ScenarioEvents
from repro_torch.scenario.mobility import (FieldLayout, MobilityModel,
                                           layout_from_network)


def _components(adj: np.ndarray):
    """Connected components of a symmetric 0/1 adjacency matrix, as lists
    of node indices in ascending order (deterministic)."""
    n = adj.shape[0]
    seen = np.zeros(n, bool)
    comps = []
    for start in range(n):
        if seen[start]:
            continue
        stack, members = [start], []
        seen[start] = True
        while stack:
            u = stack.pop()
            members.append(u)
            for v in np.nonzero(adj[u])[0]:
                if not seen[v]:
                    seen[v] = True
                    stack.append(int(v))
        comps.append(sorted(members))
    return comps


@dataclasses.dataclass
class DynamicScenario:
    """Mobility + network evolution + drift schedules, composed.

    ``mobility=None`` keeps the radio plane static (legacy lognormal
    jitter) while drift schedules still run — the ``label_shift`` /
    pure-data presets.
    """
    mobility: Optional[MobilityModel] = None
    schedules: Sequence = ()
    area: float = 2000.0
    dt: float = 60.0                   # seconds of motion per global round
    handover_margin_db: float = 2.0
    mesh_outage_p: float = 0.0
    mesh_outage_factor: float = 1e-3
    wired_jitter: float = 0.1
    radio_jitter: Optional[float] = None   # static-radio (mobility=None)
                                           # jitter; None -> the engine's
                                           # EngineOptions.rate_jitter

    def __post_init__(self):
        self._net0: Optional[Network] = None
        self._layout: Optional[FieldLayout] = None
        self._serving: Optional[np.ndarray] = None
        self._radio_jitter = 0.15

    # ------------------------------------------------------------ bind --

    def bind(self, net, opts):
        self._net0 = net
        # resolved fresh on every bind: the configured value stays None,
        # so rebinding to different EngineOptions tracks their rate_jitter
        self._radio_jitter = self.radio_jitter if self.radio_jitter \
            is not None else getattr(opts, "rate_jitter", 0.15)
        self._layout = None
        self._serving = None
        for sch in self.schedules:
            if hasattr(sch, "reset"):
                sch.reset(net.cfg.num_ue)

    # ------------------------------------------------------------ state --

    @property
    def serving_bs(self) -> Optional[np.ndarray]:
        """(N,) index of each UE's current serving BS (None until round 0;
        the association trace the determinism tests pin)."""
        return self._serving

    def _ensure_initialized(self, rng):
        # spatial state exists only when mobility drives the radio plane;
        # with mobility=None the base network's rates/associations stand
        if self.mobility is None or self._layout is not None:
            return
        net = self._net0
        self._layout = layout_from_network(net, rng, self.area)
        self.mobility.init(rng, self._layout.ue_pos, self.area)
        d = self._distances()
        self._serving = np.argmax(pathloss_gain(d), axis=1)

    def _distances(self) -> np.ndarray:
        lay = self._layout
        return np.linalg.norm(
            lay.ue_pos[:, None, :] - lay.bs_pos[None, :, :], axis=-1)

    # ------------------------------------------- full-state resume ------

    def state_dict(self) -> dict:
        """Spatial + association + schedule state for mid-run resume
        (``repro_torch.experiments.runstate``).  The engine rng is NOT
        here: it lives on the engine's LoopState; restoring both
        reproduces the remaining rounds bit-exactly."""
        out = {"initialized": int(self._layout is not None)}
        if self._layout is not None:
            lay = self._layout
            out["layout"] = {"area": float(lay.area),
                             "dc_pos": np.asarray(lay.dc_pos),
                             "bs_pos": np.asarray(lay.bs_pos),
                             "ue_pos": np.asarray(lay.ue_pos)}
            out["serving"] = np.asarray(self._serving)
        if self.mobility is not None:
            out["mobility"] = self.mobility.state_dict()
        out["schedules"] = {
            str(i): sch.state_dict()
            for i, sch in enumerate(self.schedules)
            if hasattr(sch, "state_dict")}
        return out

    def load_state_dict(self, d: dict) -> None:
        if int(d["initialized"]):
            lay = d["layout"]
            self._layout = FieldLayout(
                area=float(lay["area"]), dc_pos=np.asarray(lay["dc_pos"]),
                bs_pos=np.asarray(lay["bs_pos"]),
                ue_pos=np.asarray(lay["ue_pos"]))
            self._serving = np.asarray(d["serving"])
        else:
            self._layout = None
            self._serving = None
        if self.mobility is not None and "mobility" in d:
            self.mobility.load_state_dict(d["mobility"])
        for i, sch in enumerate(self.schedules):
            if hasattr(sch, "load_state_dict") and str(i) in d["schedules"]:
                sch.load_state_dict(d["schedules"][str(i)])

    # ------------------------------------------------------------- step --

    def step(self, t, online_datasets, rng):
        net = self._net0
        N, B, S = net.dims
        self._ensure_initialized(rng)

        # 1. data: advance every online stream, then compose the drift
        # schedules in UE order (offline UEs still step — deterministic
        # rejoin trajectories)
        for sch in self.schedules:
            if hasattr(sch, "begin_round"):
                sch.begin_round(t, N, rng)
        data = []
        for ue, ds in enumerate(online_datasets):
            d = ds.step()
            for sch in self.schedules:
                d = sch.apply(t, ue, d, rng)
            data.append(d)
        joined, left = (), ()
        for sch in self.schedules:
            if hasattr(sch, "events"):
                j, l_ = sch.events()
                joined, left = joined + tuple(j), left + tuple(l_)

        # adversary channels (scenario/adversary.py): update corruptions
        # for the executor, multiplicative per-UE compute-rate scaling
        # for the cost model
        corrupted = ()
        for sch in self.schedules:
            if hasattr(sch, "corrupted"):
                corrupted = corrupted + tuple(sch.corrupted(t))
        scale = None
        for sch in self.schedules:
            if hasattr(sch, "compute_scale"):
                s = np.asarray(sch.compute_scale(t, N), float)
                scale = s if scale is None else scale * s

        # 2.-4. radio plane
        if self.mobility is not None:
            self._layout.ue_pos = self.mobility.step(
                t, rng, self._layout.ue_pos, self.area, self.dt)
            d = self._distances()
            mean_gain = pathloss_gain(d)
            fade_up = rng.rayleigh(1.0, (N, B)) ** 2
            fade_dn = rng.rayleigh(1.0, (B, N)) ** 2
            cfg = net.cfg
            R_nb = shannon_rate(cfg.bandwidth_hz, cfg.ue_tx_power,
                                mean_gain * fade_up, cfg.noise_density)
            R_bn = shannon_rate(cfg.bandwidth_hz, cfg.bs_tx_power,
                                mean_gain.T * fade_dn, cfg.noise_density)
            handovers, subnet_of_ue = self._handover(mean_gain)
        else:
            jit = np.exp(rng.normal(0.0, self._radio_jitter,
                                    net.R_nb.shape))
            R_nb = net.R_nb * jit
            R_bn = net.R_bn * np.exp(rng.normal(0.0, self._radio_jitter,
                                                net.R_bn.shape))
            handovers, subnet_of_ue = (), np.asarray(net.subnet_of_ue)

        # 5. wired plane: congestion jitter + mesh link churn
        wjit = lambda x: x * np.exp(  # noqa: E731
            rng.normal(0.0, self.wired_jitter, x.shape))
        R_ss = wjit(np.asarray(net.R_ss, float).copy())
        R_sb = wjit(np.asarray(net.R_sb, float).copy())
        outage = np.zeros((S, S), bool)
        if self.mesh_outage_p > 0.0 and S > 1:
            up = np.triu(rng.uniform(0.0, 1.0, (S, S))
                         < self.mesh_outage_p, 1)
            outage = up | up.T
            R_ss = np.where(outage, R_ss * self.mesh_outage_factor, R_ss)
        adjacency = self._rebuild_adjacency(subnet_of_ue, outage)
        mesh_down = tuple((int(i), int(j)) for i, j in
                          zip(*np.nonzero(np.triu(outage, 1))))

        net_t = dataclasses.replace(
            net, R_nb=R_nb, R_bn=R_bn, R_ss=R_ss, R_sb=R_sb,
            subnet_of_ue=subnet_of_ue, adjacency=adjacency)
        active = sum(1 for d in data if len(d["y"]))
        events = ScenarioEvents(
            round=t, handovers=handovers, joined=joined, left=left,
            mesh_down=mesh_down, active_ues=active,
            corrupted=tuple(sorted(corrupted)),
            compute_scale=() if scale is None
            else tuple(float(x) for x in scale))
        return net_t, data, events

    # -------------------------------------------------------- internals --

    def _handover(self, mean_gain) -> Tuple[tuple, np.ndarray]:
        """Hysteresis handover on the mean channel: switch serving BS only
        when the best candidate beats the current one by the margin."""
        net = self._net0
        N = mean_gain.shape[0]
        margin = 10.0 ** (self.handover_margin_db / 10.0)
        best = np.argmax(mean_gain, axis=1)
        cur_gain = mean_gain[np.arange(N), self._serving]
        switch = mean_gain[np.arange(N), best] > cur_gain * margin
        switch &= best != self._serving
        handovers = tuple(
            (int(n), int(self._serving[n]), int(best[n]))
            for n in np.nonzero(switch)[0])
        self._serving = np.where(switch, best, self._serving)
        subnet_of_ue = np.asarray(net.subnet_of_bs)[self._serving]
        return handovers, subnet_of_ue

    def _rebuild_adjacency(self, subnet_of_ue, outage) -> np.ndarray:
        """Consensus graph tracking the physical evolution: each UE's BS
        edge follows its serving BS (mobility scenarios only — with a
        static radio plane the base graph stands), and DC-DC edges drop
        during outages with the surviving components re-linked so the
        mesh stays connected (App. G-C guarantees)."""
        net = self._net0
        N, B, S = net.dims
        A = np.array(net.adjacency, dtype=int, copy=True)
        if self.mobility is not None and self._serving is not None:
            A[:N, N:N + B] = 0
            A[N:N + B, :N] = 0
            for n in range(N):
                b = N + int(self._serving[n])
                A[n, b] = A[b, n] = 1
        if outage.any():
            dc = slice(N + B, N + B + S)
            A_dc = A[dc, dc] & ~outage.astype(int)
            np.fill_diagonal(A_dc, 0)
            # repair connectivity: chain the connected components together
            # (degree >= 1 alone is not enough — the mesh can split into
            # pairs), so consensus (Alg. 3) always has a connected graph
            comp = _components(A_dc)
            reps = [members[0] for members in comp]
            for r1, r2 in zip(reps, reps[1:]):
                A_dc[r1, r2] = A_dc[r2, r1] = 1
            A[dc, dc] = A_dc
        return A
