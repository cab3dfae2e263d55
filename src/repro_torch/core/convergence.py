"""Theorem 1 / Corollary 1: ML convergence bound evaluation (paper eqs. 25,
33), in numpy.  Counterpart of ``repro.core.convergence``.  The solver's
objective uses the eq.-33-style bound as term (a) of problem P, with
tau^t replaced by delta^A + delta^R (Sec. IV-1)."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class MLConstants:
    """Smoothness, per-DPU data variability and noise of problem P's bound,
    estimated by ``repro_torch.core.estimation`` (paper Algs. 4-7,
    App. H)."""
    L: float = 1.0            # smoothness
    theta_i: np.ndarray = None    # local data variability (per DPU)
    sigma_i: np.ndarray = None    # local sample std (per DPU)
    zeta1: float = 1.0
    zeta2: float = 0.0
    F0_gap: float = 1.0       # F(x^0) - F*


def a_norm_stats(gamma, eta, mu):
    """(||a||_1, ||a||_2^2, a_{-1}) for a_l = (1-eta*mu)^(gamma-1-l),
    vectorized over gamma (float arrays allowed for the relaxed solver)."""
    r = 1.0 - eta * mu
    gamma = np.maximum(np.asarray(gamma, dtype=np.float64), 1e-6)
    if abs(r - 1.0) < 1e-12:
        a1, a2, alast = gamma, gamma, np.ones_like(gamma)
    else:
        a1 = (1.0 - r ** gamma) / (1.0 - r)
        a2 = (1.0 - r ** (2 * gamma)) / (1.0 - r ** 2)
        alast = np.ones_like(gamma)  # a_{gamma-1} = r^0 = 1
    return a1, a2, alast


def theorem1_bound(*, consts: MLConstants, p_i, D_i, m_i, gamma_i,
                   tau_sum_drift: float, eta: float, theta: float,
                   T: int, mu: float = 0.01) -> dict:
    """Evaluate the five terms of eq. (25) for one representative round
    (time-invariant orchestration); returns each term + total.

    p_i, D_i, m_i, gamma_i: per-DPU arrays. tau_sum_drift: sum_t sum_i
    tau^t Delta_i^t (the drift penalty numerator)."""
    p_i = np.asarray(p_i, np.float64)
    D_i = np.maximum(np.asarray(D_i, np.float64), 1.0)
    m_i = np.clip(np.asarray(m_i, np.float64), 1e-6, 1.0)
    gamma_i = np.asarray(gamma_i, np.float64)
    L = consts.L
    th = np.asarray(consts.theta_i, np.float64)
    sg = np.asarray(consts.sigma_i, np.float64)
    a1, a2, alast = a_norm_stats(gamma_i, eta, mu)
    term_a = 4.0 * consts.F0_gap / (theta * eta * T)
    term_b = 4.0 * tau_sum_drift / (theta * eta * T)
    noise = (p_i ** 2) * (1 - m_i) * (D_i - 1) * (th ** 2) * (sg ** 2) \
        / (m_i * D_i ** 2) * (a2 / a1 ** 2)
    term_c = 16.0 * eta * L * theta * np.sum(noise)
    inner = (1 - m_i) * (D_i - 1) * (th ** 2) * (sg ** 2) * p_i * gamma_i \
        / (m_i * a1 * D_i ** 2) * (a2 - alast ** 2)
    term_e = 12.0 * (eta ** 2) * (L ** 2) * np.sum(inner)
    het = np.max((gamma_i ** 2) * (a1 - alast) / a1)
    term_d = 12.0 * (eta ** 2) * (L ** 2) * consts.zeta2 * het
    total = term_a + term_b + term_c + term_d + term_e
    return {"initial_gap": term_a, "drift": term_b, "sgd_noise": term_c,
            "heterogeneity": term_d, "local_divergence": term_e,
            "total": total}


def corollary_bound(*, consts: MLConstants, d: int, gamma_bar: float,
                    T: int, theta: float, tau_tilde: float,
                    m_min: float, gamma_max: float) -> float:
    """Eq. (33): the O(1/sqrt(T)) bound with eta = sqrt(d/(gamma_bar T))."""
    L = consts.L
    th_max = float(np.max(consts.theta_i))
    sg_max = float(np.max(consts.sigma_i))
    t1 = 4 * np.sqrt(gamma_bar) / (theta * np.sqrt(d * T)) * consts.F0_gap
    t2 = 4 * tau_tilde * np.sqrt(gamma_bar) / (theta * np.sqrt(d * T))
    t3 = 16 * L * theta * th_max * sg_max ** 2 / m_min * np.sqrt(
        d / (gamma_bar * T))
    t4 = 12 * L ** 2 * d * th_max * sg_max ** 2 * gamma_max / (
        gamma_bar * m_min * T)
    t5 = 12 * L ** 2 * consts.zeta2 * d * gamma_max ** 2 / (gamma_bar * T)
    return t1 + t2 + t3 + t4 + t5


def step_size_condition(gamma_i, eta, mu, L, zeta1) -> bool:
    """Theorem 1 hypothesis: 4 eta^2 L^2 max_i gamma^2(||a||_1-a_{-1})/||a||_1
    <= 1/(2 zeta1^2 + 1)."""
    a1, _, alast = a_norm_stats(gamma_i, eta, mu)
    lhs = 4 * eta ** 2 * L ** 2 * np.max(
        np.asarray(gamma_i, np.float64) ** 2 * (a1 - alast) / a1)
    return bool(lhs <= 1.0 / (2 * zeta1 ** 2 + 1))
