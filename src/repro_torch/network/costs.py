"""Delay / energy models (paper eqs. 16-40).  Counterpart of
``repro.network.costs``, in float32 torch ops that the SCA solver takes
gradients through.  Every tensor is made on the device of the inputs:
the engine's accounting passes numpy arrays and CPU tensors, the solver
a :class:`~repro_torch.solver.variables.NetView` and a decision dict on
its device.

Decision variables (dict w):
  rho_nb (N,B), rho_bs (B,S), f_n (N,), z_s (S,), gamma (N+S,), m (N+S,),
  I_s (S,), I_nb (N,B), I_bn (B,N), R_bs (B,S), delta_A (), delta_R ().
Context: Network topology + per-UE data sizes D_bar (N,).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

EPS = 1e-9


def as_f32(x) -> torch.Tensor:
    """A float32 tensor of ``x``: a tensor keeps its device, anything else
    (numpy arrays, Python numbers) lands on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device="cpu")


def data_configuration(w, D_bar):
    """eqs. (16)-(18)."""
    rho_nb, rho_bs = w["rho_nb"], w["rho_bs"]
    D_n = (1.0 - torch.sum(rho_nb, dim=1)) * D_bar          # kept at UEs
    D_b = torch.sum(rho_nb * D_bar[:, None], dim=0)          # (B,)
    D_s = torch.sum(rho_bs * D_b[:, None], dim=0)            # (S,)
    return D_n, D_b, D_s


def network_costs(w: Dict, net, D_bar) -> Dict:
    """All cost terms of Sec. II-E for decision w."""
    cfg = net.cfg
    N, B, S = net.dims
    R_nb = as_f32(net.R_nb)
    R_bn = as_f32(net.R_bn)
    R_ss = as_f32(net.R_ss)
    R_sb = as_f32(net.R_sb)
    D_bar = as_f32(D_bar)
    w = {k: as_f32(v) for k, v in w.items()}
    rho_nb, rho_bs = w["rho_nb"], w["rho_bs"]
    I_s, I_nb, I_bn = w["I_s"], w["I_nb"], w["I_bn"]
    R_bs = w["R_bs"]

    D_n, D_b, D_s = data_configuration(w, D_bar)

    # --- UE->BS transfers (eqs. 19-20)
    d_nb_D = cfg.beta_data * D_bar[:, None] * rho_nb / (R_nb + EPS)
    d_nb_M = cfg.beta_model / (R_nb + EPS)
    E_nb_D = d_nb_D * cfg.ue_tx_power
    E_nb_M = d_nb_M * cfg.ue_tx_power

    # --- BS->DC transfers (eqs. 21, 23)
    d_bs_D = cfg.beta_data * D_b[:, None] * rho_bs / (R_bs + EPS)
    d_bs_M = cfg.beta_model / (R_bs + EPS)
    E_bs_D = d_bs_D * cfg.bs_dc_link_power
    E_bs_M = d_bs_M * cfg.bs_dc_link_power

    # --- data collection delay at DCs (eq. 22)
    d_s_D = torch.amax(d_bs_D, dim=0) + torch.amax(d_nb_D)

    # --- DC<->DC (eq. 24)
    d_ss_M = cfg.beta_model / (R_ss + EPS)
    d_ss_M = d_ss_M * (1.0 - torch.eye(S, device=R_ss.device))
    E_ss_M = d_ss_M * cfg.dc_dc_link_power

    # --- processing (eqs. 26-29)
    gamma_n, gamma_s = w["gamma"][:N], w["gamma"][N:]
    m_n, m_s = w["m"][:N], w["m"][N:]
    d_n_P = cfg.cycles_per_point * gamma_n * m_n * D_n / (w["f_n"] + EPS)
    E_n_P = cfg.cycles_per_point * gamma_n * m_n * D_n \
        * w["f_n"] ** 2 * cfg.alpha_eff / 2.0
    d_s_P = gamma_s * m_s * D_s / (cfg.machines_per_dc * w["z_s"] + EPS)
    rho_pow = 1.0 - cfg.idle_fraction
    E_s_P = d_s_P * (rho_pow * (w["z_s"] / cfg.dc_point_capacity) ** 2
                     * cfg.dc_peak_power * cfg.machines_per_dc
                     + cfg.idle_fraction * cfg.dc_peak_power
                     * cfg.machines_per_dc)

    # --- aggregation path (eqs. 30-35); the BS->DC hop is two matvecs,
    # I_nb @ (d_bs_M @ I_s), never an (N, B, S) tensor
    d_n_A = torch.sum(d_nb_M * I_nb, dim=1) + I_nb @ (d_bs_M @ I_s)
    E_n_A = torch.sum(E_nb_M * I_nb, dim=1) + I_nb @ (E_bs_M @ I_s)
    d_s_A = torch.sum(d_ss_M * I_s[None, :], dim=1)
    E_s_A = torch.sum(E_ss_M * I_s[None, :], dim=1)
    delta_A_req = torch.maximum(torch.amax(d_n_A + d_n_P),
                                torch.amax(d_s_D + d_s_P + d_s_A))
    E_A = torch.sum(E_n_A) + torch.sum(E_s_A)

    # --- broadcast/reception path (eqs. 36-40)
    d_sb_M = cfg.beta_model / (R_sb + EPS)
    E_sb_M = d_sb_M * cfg.dc_dc_link_power
    d_b_R = torch.sum(d_sb_M * I_s[:, None], dim=0)
    E_b_R = torch.sum(E_sb_M * I_s[:, None], dim=0)
    d_bn_M = cfg.beta_model / (R_bn + EPS)
    d_b_B = torch.amax(d_bn_M * I_bn, dim=1)
    E_b_B = d_b_B * cfg.bs_tx_power
    d_s_R = torch.sum(d_ss_M.T * I_s[:, None], dim=0)
    E_s_R = torch.sum(E_ss_M.T * I_s[:, None], dim=0)
    delta_R_req = torch.maximum(torch.amax(d_b_R + d_b_B), torch.amax(d_s_R))
    E_R = torch.sum(E_b_R + E_b_B) + torch.sum(E_s_R)

    return {
        "D_n": D_n, "D_b": D_b, "D_s": D_s,
        "d_nb_D": d_nb_D, "d_bs_D": d_bs_D, "d_s_D": d_s_D,
        "E_nb_D": E_nb_D, "E_bs_D": E_bs_D,
        "d_n_P": d_n_P, "d_s_P": d_s_P, "E_n_P": E_n_P, "E_s_P": E_s_P,
        "d_n_A": d_n_A, "d_s_A": d_s_A, "delta_A_req": delta_A_req,
        "E_A": E_A,
        "d_b_R": d_b_R, "d_b_B": d_b_B, "d_s_R": d_s_R,
        "delta_R_req": delta_R_req, "E_R": E_R,
        "E_data": torch.sum(E_nb_D) + torch.sum(E_bs_D),
        "E_proc": torch.sum(E_n_P) + torch.sum(E_s_P),
    }


def round_delay(costs: Dict):
    """tau^t upper bound used in the objective: delta^A + delta^R."""
    return costs["delta_A_req"] + costs["delta_R_req"]


def round_energy(costs: Dict, xi3=(1.0,) * 6):
    """Total weighted energy (terms c,d,e of eq. 44)."""
    x1, x2, x3, x4, x5, x6 = xi3
    return (x1 * torch.sum(costs["E_nb_D"]) + x2 * torch.sum(costs["E_bs_D"])
            + x3 * torch.sum(costs["E_n_P"]) + x4 * torch.sum(costs["E_s_P"])
            + x5 * costs["E_A"] + x6 * costs["E_R"])
