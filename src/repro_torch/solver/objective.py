"""Objective of problem P (paper eq. 44): ML-performance bound (term a,
replaced by the Corollary-1 / eq.-33-style bound with tau ~ delta^A+delta^R)
+ delay (term b) + weighted energies (terms c-e), in differentiable float32
torch ops on the device of their inputs.  Counterpart of
``repro.solver.objective``."""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.network import costs as C


@dataclasses.dataclass(frozen=True)
class ObjectiveWeights:
    xi1: float = 1.0          # ML performance weight
    xi2: float = 1e-2         # delay weight
    xi3: float = 1e-3         # energy weight
    xi3_sub: tuple = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0)   # xi_{3,1..6}
    eta: float = 1e-2
    mu: float = 0.01
    theta: float = 1.0
    T: int = 50
    drift: float = 0.3        # Delta_i (Table III default)


def a_stats(gamma, eta, mu):
    """(||a||_1, ||a||_2^2, a_{-1}) of a_l = (1-eta*mu)^(gamma-1-l) for a
    relaxed (tensor) gamma; counterpart of ``a_stats_jnp``."""
    r = 1.0 - eta * mu
    g = torch.clamp(gamma, min=0.5)
    if abs(r - 1.0) < 1e-12:
        return g, g, torch.ones_like(g)
    a1 = (1.0 - r ** g) / (1.0 - r)
    a2 = (1.0 - r ** (2 * g)) / (1.0 - r ** 2)
    return a1, a2, torch.ones_like(g)


def ml_bound(w: Dict, net, D_bar, consts, ow: ObjectiveWeights):
    """Differentiable eq.-25/33 bound as a function of the decision vars.
    ``consts.theta_i`` / ``sigma_i``: numpy arrays or tensors on w's
    device."""
    N = net.cfg.num_ue
    dev = w["gamma"].device
    D_n, D_b, D_s = C.data_configuration(w, C.as_f32(D_bar))
    D_i = torch.cat([D_n, D_s])
    D_i = torch.clamp(D_i, min=1.0)
    D_tot = torch.sum(D_i)
    p_i = D_i / D_tot
    m_i = torch.clamp(w["m"], 1e-3, 1.0)
    gamma_i = torch.clamp(w["gamma"], min=0.5)
    eta, mu, theta, T = ow.eta, ow.mu, ow.theta, ow.T
    L = consts.L
    th = C.as_f32(consts.theta_i).to(dev)
    sg = C.as_f32(consts.sigma_i).to(dev)
    a1, a2, alast = a_stats(gamma_i, eta, mu)

    term_a = 4.0 * consts.F0_gap / (theta * eta * T)
    tau = w["delta_A"] + w["delta_R"]
    term_b = 4.0 * tau * ow.drift * (N + net.cfg.num_dc) / (theta * eta)
    noise = (p_i ** 2) * (1 - m_i) * (D_i - 1) * th ** 2 * sg ** 2 \
        / (m_i * D_i ** 2) * (a2 / a1 ** 2)
    term_c = 16.0 * eta * L * theta * torch.sum(noise)
    inner = (1 - m_i) * (D_i - 1) * th ** 2 * sg ** 2 * p_i * gamma_i \
        / (m_i * a1 * D_i ** 2) * (a2 - alast ** 2)
    term_e = 12.0 * eta ** 2 * L ** 2 * torch.sum(inner)
    het = torch.amax(gamma_i ** 2 * (a1 - alast) / a1)
    term_d = 12.0 * eta ** 2 * L ** 2 * consts.zeta2 * het
    return term_a + term_b + term_c + term_d + term_e


def objective(w: Dict, net, D_bar, consts, ow: ObjectiveWeights):
    """J(w): eq. (44) for one representative round."""
    costs = C.network_costs(w, net, D_bar)
    ml = ml_bound(w, net, D_bar, consts, ow)
    delay = w["delta_A"] + w["delta_R"]
    energy = C.round_energy(costs, ow.xi3_sub)
    return ow.xi1 * ml + ow.xi2 * delay + ow.xi3 * energy


def apply_required_deltas(w: Dict, net, D_bar, slack: float = 1.0) -> Dict:
    """Overwrite the delay budgets delta^A / delta^R with the realized path
    requirements (eqs. 34/40) times ``slack`` — the feasible-point
    construction shared by the solver and the baseline strategies."""
    c = C.network_costs(w, net, D_bar)
    w = dict(w)
    w["delta_A"] = c["delta_A_req"] * slack
    w["delta_R"] = c["delta_R_req"] * slack
    return w


def objective_breakdown(w, net, D_bar, consts, ow):
    costs = C.network_costs(w, net, D_bar)
    return {
        "ml": float(ml_bound(w, net, D_bar, consts, ow)),
        "delay": float(w["delta_A"] + w["delta_R"]),
        "delay_required": (float(costs["delta_A_req"]),
                           float(costs["delta_R_req"])),
        "energy": float(C.round_energy(costs, ow.xi3_sub)),
        "total": float(objective(w, net, D_bar, consts, ow)),
    }
