"""Three-tier edge network (paper Sec. II-A, Fig. 2): UEs, BSs, DCs.
Counterpart of ``repro.network.topology``: numpy, drawing the same numbers
from the same seeds, so both packages build identical networks.

Includes the wireless channel model (eqs. 12-13), wired capacities (14-15),
and the synthetic testbed generator reproducing App. F-D: per-link normal
distributions (each DC anchors 2 BSs + 4 UEs; high intra- / low
inter-subnetwork rates), then every link rate is an i.i.d. draw.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class NetworkConfig:
    num_ue: int = 20
    num_bs: int = 10
    num_dc: int = 5
    # radio (eq. 12-13)
    bandwidth_hz: float = 20e6           # V_{n,b}
    noise_density: float = 4e-21         # N0 (W/Hz)  (~ -174 dBm/Hz)
    ue_tx_power: float = 0.2             # W
    bs_tx_power: float = 10.0            # W
    # wired
    dc_capacity_gbps: tuple = (40.0, 50.0)     # R_s^max range
    bs_dc_capacity_gbps: tuple = (3.0, 4.0)    # R_{b,s}^max range
    dc_dc_gbps: tuple = (5.0, 10.0)
    # payloads (Table III's beta_M / beta_D labels are swapped; this is
    # the physical reading: one 28x28x8bit image, a ~1.25M-param model)
    beta_data: float = 6272.0            # bits per datapoint
    beta_model: float = 4e7              # bits per model payload
    # UE compute (eqs. 26-27), re-based to physical magnitudes
    f_min: float = 1e5                   # Hz
    f_max: float = 2.3e9
    cycles_per_point: float = 1e7        # c_n (cycles per datapoint-pass)
    alpha_eff: float = 1e-26             # chip effective capacitance
    # DC compute (eqs. 28-29)
    machines_per_dc: int = 700           # M_s
    dc_point_capacity: float = 5e6       # C_s points/s per machine
    dc_peak_power: float = 200.0         # \bar P_s (W)
    idle_fraction: float = 0.4           # 1 - rho
    # wired link powers
    bs_dc_link_power: float = 5.0        # P_{b,s} W
    dc_dc_link_power: float = 5.0        # P_{s,s'} W
    seed: int = 0


@dataclasses.dataclass
class Network:
    """Realized network with per-link rate distributions and draws."""
    cfg: NetworkConfig
    # rate means (bit/s)
    R_nb: np.ndarray      # (N, B) uplink UE->BS
    R_bn: np.ndarray      # (B, N) downlink BS->UE (broadcast rate per pair)
    R_bs_max: np.ndarray  # (B, S)
    R_s_max: np.ndarray   # (S,)
    R_ss: np.ndarray      # (S, S) DC<->DC
    R_sb: np.ndarray      # (S, B) DC->BS (model broadcast path)
    subnet_of_bs: np.ndarray  # (B,) DC index
    subnet_of_ue: np.ndarray  # (N,) DC index
    adjacency: np.ndarray     # (N+B+S, N+B+S) consensus graph H

    @property
    def dims(self):
        return self.cfg.num_ue, self.cfg.num_bs, self.cfg.num_dc

    def node_count(self):
        return self.cfg.num_ue + self.cfg.num_bs + self.cfg.num_dc

    def resample_rates(self, rng: np.random.RandomState, jitter: float = 0.1):
        """Per-round congestion: multiplicative lognormal jitter (App. F-D
        style resampling from measured distributions)."""
        def jit(x):
            return x * np.exp(rng.normal(0, jitter, x.shape))
        return dataclasses.replace(
            self, R_nb=jit(self.R_nb), R_bn=jit(self.R_bn),
            R_ss=jit(self.R_ss), R_sb=jit(self.R_sb))


def shannon_rate(bw_hz, tx_power, gain, noise_density):
    """eq. (12)/(13)."""
    noise = noise_density * bw_hz
    return bw_hz * np.log2(1.0 + tx_power * gain / noise)


def pathloss_gain(d_m):
    """3GPP urban macro path loss 128.1 + 37.6 log10(d_km) as a linear
    power gain (distances in meters, clamped to >= 1 m)."""
    d_km = np.maximum(np.asarray(d_m, float), 1.0) / 1000.0
    return 10.0 ** (-(128.1 + 37.6 * np.log10(d_km)) / 10.0)


def subnetwork(net: Network, ue_idx) -> Network:
    """The network restricted to the UE subset ``ue_idx`` (BSs/DCs kept).

    The cohort-sampling view: per-round client sampling solves the
    orchestration problem over the K drawn UEs only, so every UE-indexed
    rate matrix is gathered to the cohort rows.  The consensus graph is
    dropped (a UE-subset of H is not a valid consensus topology; cohort
    runs use the centralized solver).
    """
    ue_idx = np.asarray(ue_idx, int)
    cfg = dataclasses.replace(net.cfg, num_ue=int(ue_idx.shape[0]))
    return dataclasses.replace(
        net, cfg=cfg, R_nb=net.R_nb[ue_idx], R_bn=net.R_bn[:, ue_idx],
        subnet_of_ue=net.subnet_of_ue[ue_idx],
        adjacency=np.zeros((0, 0), dtype=int))


def make_network(cfg: NetworkConfig = NetworkConfig(),
                 edge_prob: float = 0.3, *,
                 consensus: bool = True) -> Network:
    """Synthetic 5G/CBRS-testbed-like network (App. F-D).

    ``consensus=False`` skips the O(V^2) consensus graph and draws the
    channel gains vectorized.  The two modes draw from the rng in
    different orders, so a seeded topology is reproducible only within
    one mode.
    """
    rng = np.random.RandomState(cfg.seed)
    N, B, S = cfg.num_ue, cfg.num_bs, cfg.num_dc
    bs_per_dc = max(1, B // S)
    ue_per_dc = max(1, N // S)
    subnet_of_bs = np.minimum(np.arange(B) // bs_per_dc, S - 1)
    subnet_of_ue = np.minimum(np.arange(N) // ue_per_dc, S - 1)

    # channel gains: intra-subnet strong, inter-subnet weak (path loss)
    if consensus:
        gain = np.zeros((N, B))
        for n in range(N):
            for b in range(B):
                same = subnet_of_ue[n] == subnet_of_bs[b]
                d = rng.uniform(50, 200) if same else rng.uniform(400, 1200)
                gain[n, b] = pathloss_gain(d) * rng.rayleigh(1.0) ** 2
    else:
        same = subnet_of_ue[:, None] == subnet_of_bs[None, :]
        d = np.where(same, rng.uniform(50, 200, (N, B)),
                     rng.uniform(400, 1200, (N, B)))
        gain = pathloss_gain(d) * rng.rayleigh(1.0, (N, B)) ** 2
    R_nb = shannon_rate(cfg.bandwidth_hz, cfg.ue_tx_power, gain,
                        cfg.noise_density)
    R_bn = shannon_rate(cfg.bandwidth_hz, cfg.bs_tx_power, gain.T,
                        cfg.noise_density)

    def urange(lo_hi, shape):
        return rng.uniform(lo_hi[0], lo_hi[1], shape) * 1e9

    R_bs_max = urange(cfg.bs_dc_capacity_gbps, (B, S))
    # intra-subnet wired links are faster
    for b in range(B):
        R_bs_max[b, subnet_of_bs[b]] *= 2.0
    R_s_max = urange(cfg.dc_capacity_gbps, (S,))
    R_ss = urange(cfg.dc_dc_gbps, (S, S))
    np.fill_diagonal(R_ss, np.inf)
    R_sb = R_bs_max.T * rng.uniform(1.0, 1.5, (S, B))

    # consensus communication graph H (App. G-C): random edges, p=0.3,
    # plus connectivity guarantees (UE>=1 BS, BS>=1 DC, DC>=1 DC)
    if not consensus:
        return Network(cfg=cfg, R_nb=R_nb, R_bn=R_bn, R_bs_max=R_bs_max,
                       R_s_max=R_s_max, R_ss=R_ss, R_sb=R_sb,
                       subnet_of_bs=subnet_of_bs, subnet_of_ue=subnet_of_ue,
                       adjacency=np.zeros((0, 0), dtype=int))
    V = N + B + S
    A = np.zeros((V, V), dtype=int)

    def add(i, j):
        A[i, j] = A[j, i] = 1
    for n in range(N):
        for b in range(B):
            if rng.rand() < edge_prob:
                add(n, N + b)
        # D2D edges among UEs in the same subnet
        for n2 in range(n + 1, N):
            if subnet_of_ue[n] == subnet_of_ue[n2] and rng.rand() < edge_prob:
                add(n, n2)
    for b in range(B):
        for s in range(S):
            if rng.rand() < edge_prob:
                add(N + b, N + B + s)
    for s in range(S):
        for s2 in range(s + 1, S):
            if rng.rand() < edge_prob:
                add(N + B + s, N + B + s2)
    # connectivity guarantees
    for n in range(N):
        if not A[n, N:N + B].any():
            add(n, N + int(np.argmax(R_nb[n])))
    for b in range(B):
        if not A[N + b, N + B:].any():
            add(N + b, N + B + int(subnet_of_bs[b]))
    for s in range(S):
        others = [s2 for s2 in range(S) if s2 != s]
        if not any(A[N + B + s, N + B + s2] for s2 in others):
            add(N + B + s, N + B + ((s + 1) % S))
    return Network(cfg=cfg, R_nb=R_nb, R_bn=R_bn, R_bs_max=R_bs_max,
                   R_s_max=R_s_max, R_ss=R_ss, R_sb=R_sb,
                   subnet_of_bs=subnet_of_bs, subnet_of_ue=subnet_of_ue,
                   adjacency=A)
