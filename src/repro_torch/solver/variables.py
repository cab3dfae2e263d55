"""Decision-variable dict for problem P: the feasible start, the projection
onto the per-node convex sets (boxes / simplexes, eqs. 45-49, 54-62,
66-68) and the rounding of the relaxed indicators.  Counterpart of those
functions of ``repro.solver.variables``, on float32 CPU tensors."""
from __future__ import annotations

import itertools
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.network.costs import as_f32


def init_w(net, D_bar, rng=None) -> Dict:
    """Feasible start: keep all data local, uniform BS->DC dispersion,
    aggregator = DC 0, mid-range compute settings."""
    del D_bar, rng
    N, B, S = net.dims
    cfg = net.cfg
    return {
        "rho_nb": torch.zeros((N, B)) + 0.02,
        "rho_bs": torch.ones((B, S)) / S,
        "f_n": torch.full((N,), 0.5 * (cfg.f_min + cfg.f_max)),
        "z_s": torch.full((S,), 0.5 * cfg.dc_point_capacity),
        "gamma": torch.full((N + S,), 2.0),
        "m": torch.full((N + S,), 0.5),
        "I_s": torch.ones((S,)) / S,
        "I_nb": torch.ones((N, B)) / B,
        "I_bn": torch.ones((B, N)) / B,
        "R_bs": as_f32(np.asarray(net.R_bs_max) * 0.5),
        "delta_A": torch.tensor(50.0),
        "delta_R": torch.tensor(5.0),
    }


def _running_sum_f32(u):
    """Running sum along dim 1, one float32 addition at a time: the
    rounding of the JAX package's ``jnp.cumsum``.  ``torch.cumsum`` on
    the CPU accumulates float32 in float64 and rounds differently, and a
    last-bit change in rho_bs can move an offloading floor."""
    return torch.stack(list(itertools.accumulate(u.unbind(1))), dim=1)


def _project_simplex(v, z=1.0):
    """Euclidean projection of rows of v onto {x >= 0, sum x = z}."""
    orig = v.shape
    v2 = v.reshape(-1, orig[-1])
    u = torch.flip(torch.sort(v2, dim=1).values, dims=(1,))
    css = _running_sum_f32(u) - z
    ind = torch.arange(1, orig[-1] + 1, dtype=v.dtype)
    cond = u - css / ind > 0
    rho = torch.sum(cond, dim=1)
    theta = css[torch.arange(v2.shape[0]), rho - 1] / rho
    return torch.clamp(v2 - theta[:, None], min=0.0).reshape(orig)


def _project_simplex_ineq(v, z=1.0):
    """Projection onto {x >= 0, sum x <= z}."""
    clipped = torch.clamp(v, min=0.0)
    over = torch.sum(clipped, dim=-1, keepdim=True) > z
    proj = _project_simplex(v, z)
    return torch.where(over, proj, clipped)


def project(w: Dict, net, gamma_cap: float = 20.0) -> Dict:
    cfg = net.cfg
    out = dict(w)
    out["rho_nb"] = _project_simplex_ineq(w["rho_nb"])          # (45),(55)
    out["rho_bs"] = _project_simplex(w["rho_bs"])               # (46),(56)
    out["I_s"] = _project_simplex(w["I_s"])                     # (47),(67)
    out["I_nb"] = _project_simplex(w["I_nb"])                   # (48),(68)
    out["I_bn"] = _project_simplex(w["I_bn"].T).T               # (49),(68)
    out["f_n"] = torch.clamp(w["f_n"], cfg.f_min, cfg.f_max)    # (57)
    out["z_s"] = torch.clamp(w["z_s"], 1e3, cfg.dc_point_capacity)  # (54)
    out["gamma"] = torch.clamp(w["gamma"], 0.5, gamma_cap)      # (59)
    out["m"] = torch.clamp(w["m"], 1e-3, 1.0)                   # (58)
    R = torch.minimum(torch.clamp(w["R_bs"], min=0.0),
                      as_f32(net.R_bs_max))                       # (14)
    tot = torch.sum(R, dim=0)
    scale = torch.clamp(as_f32(net.R_s_max) / (tot + 1e-9), max=1.0)
    out["R_bs"] = R * scale[None, :]                            # (15)
    out["delta_A"] = torch.clamp(w["delta_A"], min=0.0)         # (60)
    out["delta_R"] = torch.clamp(w["delta_R"], min=0.0)
    return out


def one_hot(idx, n) -> torch.Tensor:
    return F.one_hot(torch.as_tensor(idx), n).to(torch.float32)


def round_indicators(w: Dict) -> Dict:
    """Map relaxed indicators to feasible binaries (argmax rounding),
    satisfying (47)-(49) and (61)-(62)."""
    out = dict(w)
    S = w["I_s"].shape[0]
    out["I_s"] = one_hot(torch.argmax(w["I_s"]), S)
    out["I_nb"] = one_hot(torch.argmax(w["I_nb"], dim=1),
                           w["I_nb"].shape[1])
    out["I_bn"] = one_hot(torch.argmax(w["I_bn"], dim=0),
                           w["I_bn"].shape[0]).T
    return out
