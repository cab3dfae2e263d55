"""Baseline aggregator-selection strategies (paper Sec. VI-B2).
Counterpart of ``repro.solver.greedy``:

  * datapoint greedy — pick the DC whose subnetwork holds the most datapoints
  * data-rate greedy — pick the DC with the best average end-to-end UE->DC
    rate (eq. 100)
  * fixed — always the same DC

Each returns a full decision dict of float32 CPU tensors: the
non-aggregation variables come from a shared heuristic (offload
proportionally to uplink rate; best-rate BS associations), so comparisons
isolate the aggregator choice.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.network.costs import as_f32, network_costs
from repro_torch.solver import variables as V


def heuristic_base(net, D_bar, offload_frac: float = 0.5) -> Dict:
    """Non-aggregation decisions shared by all greedy baselines.  The
    shares are computed in float64 and stored as float32, as the JAX
    package does: the offloading floors of ``realize_offloading`` read
    these exact float32 values."""
    N, B, S = net.dims
    w = V.init_w(net, D_bar)
    up = np.asarray(net.R_nb)
    rho_nb = offload_frac * up / up.sum(axis=1, keepdims=True)
    rho_bs = np.asarray(net.R_bs_max) / np.asarray(
        net.R_bs_max).sum(axis=1, keepdims=True)
    w["rho_nb"] = as_f32(rho_nb)
    w["rho_bs"] = as_f32(rho_bs)
    w["I_nb"] = V.one_hot(torch.argmax(as_f32(up), dim=1), B)
    w["I_bn"] = V.one_hot(torch.argmax(as_f32(net.R_bn), dim=0), B).T
    w["R_bs"] = as_f32(net.R_bs_max) * 0.9
    return V.project(w, net)


def _with_aggregator(w, net, D_bar, s_idx: int) -> Dict:
    S = net.cfg.num_dc
    w = dict(w)
    w["I_s"] = V.one_hot(s_idx, S)
    c = network_costs(w, net, D_bar)
    w["delta_A"] = c["delta_A_req"]
    w["delta_R"] = c["delta_R_req"]
    return w


def subnet_datapoints(net, D_bar) -> np.ndarray:
    """Datapoints per DC subnetwork (UEs assigned by subnet_of_ue)."""
    return np.bincount(np.asarray(net.subnet_of_ue),
                       weights=np.asarray(D_bar, np.float64),
                       minlength=net.cfg.num_dc)


def e2e_rate(net) -> np.ndarray:
    """eq. (100): R^{E2E}_{n,s} = max_b 1/(1/R_nb + 1/R_bs_max)."""
    inv = 1.0 / np.asarray(net.R_nb)[:, :, None] \
        + 1.0 / np.asarray(net.R_bs_max)[None, :, :]
    return (1.0 / inv).max(axis=1)          # (N, S)


def datapoint_greedy(net, D_bar, base=None) -> Dict:
    base = base if base is not None else heuristic_base(net, D_bar)
    s = int(np.argmax(subnet_datapoints(net, D_bar)))
    return _with_aggregator(base, net, D_bar, s)


def rate_greedy(net, D_bar, base=None) -> Dict:
    base = base if base is not None else heuristic_base(net, D_bar)
    s = int(np.argmax(e2e_rate(net).mean(axis=0)))
    return _with_aggregator(base, net, D_bar, s)


def fixed_aggregator(net, D_bar, s_idx: int, base=None) -> Dict:
    base = base if base is not None else heuristic_base(net, D_bar)
    return _with_aggregator(base, net, D_bar, s_idx)
