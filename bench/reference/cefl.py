"""Plain reference of the CE-FL round at paper width (arXiv:2203.13950,
Secs. II-D, II-E): the per-round rate jitter and data offloading replayed
from the engine seed, the plan's feasibility (eqs. 55-62), the round's
delay and energy (eqs. 16-40, 44), and FedProx local training with the
eq.-10 accumulation and the eq.-11 aggregation of the 784-200-100-10 MLP.

NumPy and plain PyTorch only.  It imports neither the program nor JAX.
The mini-batch draws are re-derived from a ``torch.Generator`` seeded as
the engine seeds its own, in the engine's order: DPUs grouped by (gamma,
m, batch bucket) in first-seen order, one ``rand((gamma, D_i))`` per DPU,
argsorted per row.
"""
from __future__ import annotations

import numpy as np
import torch

EPS = 1e-9


# ------------------------------------------------ world and offloading --

def jitter_rates(rates: dict, rng: np.random.RandomState, jitter: float):
    """The round's rates: each link rate times a lognormal draw, in the
    order uplink, downlink, DC-DC, DC-BS."""
    out = dict(rates)
    for k in ("R_nb", "R_bn", "R_ss", "R_sb"):
        out[k] = rates[k] * np.exp(rng.normal(0, jitter, rates[k].shape))
    return out


def offload(rng: np.random.RandomState, ue_idx, rho_nb, rho_bs):
    """Split each UE's points (pool indices) by rho_nb, then each BS's
    pool by rho_bs.  Every UE keeps at least one point; BSs keep none, the
    remainder going to the DC of the largest share.  Returns one index
    array per DPU (UEs, then DCs)."""
    rho_nb = np.asarray(rho_nb, np.float32)
    rho_bs = np.asarray(rho_bs, np.float32)
    B, S = rho_bs.shape
    bs_pool = [[] for _ in range(B)]
    ue_keep = []
    for n, idx in enumerate(ue_idx):
        D = len(idx)
        if D == 0:
            ue_keep.append(idx)
            continue
        perm = rng.permutation(D)
        counts = np.floor(rho_nb[n] * D).astype(int)
        excess = counts.sum() - (D - 1)
        while excess > 0:
            j = int(np.argmax(counts))
            take = min(excess, counts[j])
            counts[j] -= take
            excess -= take
        start = 0
        for b in range(B):
            if counts[b]:
                bs_pool[b].append(idx[perm[start:start + counts[b]]])
            start += counts[b]
        ue_keep.append(idx[perm[start:]])
    dc = [[] for _ in range(S)]
    for b in range(B):
        if not bs_pool[b]:
            continue
        pool = np.concatenate(bs_pool[b])
        perm = rng.permutation(len(pool))
        counts = np.floor(rho_bs[b] * len(pool)).astype(int)
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
                dc[s].append(pool[perm[start:start + counts[s]]])
            start += counts[s]
    empty = np.zeros(0, dtype=np.int64)
    return ue_keep + [np.concatenate(p) if p else empty for p in dc]


def plan_violations(w: dict, dims, f_min: float, f_max: float,
                    atol: float = 1e-4) -> int:
    """How many of the plan's conditions fail: shapes, rho_nb >= 0 with
    rows summing to at most 1 (eq. 55), rho_bs rows on the simplex (eq.
    56), f_n in [f_min, f_max] (eq. 57), m in (0, 1] (eq. 58), gamma > 0
    (eq. 59), one-hot I_s, I_nb rows, I_bn columns (eqs. 61-62)."""
    N, B, S = dims
    w = {k: np.asarray(v, np.float64) for k, v in w.items()}
    shapes = {"rho_nb": (N, B), "rho_bs": (B, S), "f_n": (N,), "z_s": (S,),
              "gamma": (N + S,), "m": (N + S,), "I_s": (S,),
              "I_nb": (N, B), "I_bn": (B, N), "R_bs": (B, S)}
    bad = sum(w[k].shape != s for k, s in shapes.items())
    if bad:
        return bad

    def not_one_hot(x, axis):
        return (np.abs(x.sum(axis=axis) - 1).max() > atol
                or np.abs(x * (1 - x)).max() > atol)

    checks = [
        w["rho_nb"].min() < -atol,
        (w["rho_nb"].sum(axis=1) > 1 + atol).any(),
        w["rho_bs"].min() < -atol,
        np.abs(w["rho_bs"].sum(axis=1) - 1).max() > atol,
        w["f_n"].min() < f_min - atol or w["f_n"].max() > f_max + atol,
        (w["m"] <= 0).any() or (w["m"] > 1 + atol).any(),
        (w["gamma"] <= 0).any(),
        not_one_hot(w["I_s"], 0), not_one_hot(w["I_nb"], 1),
        not_one_hot(w["I_bn"], 0),
        not np.isfinite(np.concatenate([v.ravel() for v in w.values()])).all(),
    ]
    return int(sum(bool(c) for c in checks))


def round_costs(w: dict, rates: dict, D_bar, net: dict,
                dtype=torch.float64):
    """(energy, delay) of a round: eq. 44's energy terms with unit
    weights, and delta_A + delta_R, computed in ``dtype`` on the CPU."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64)).to(dtype)

    N, B, S = net["num_ue"], net["num_bs"], net["num_dc"]
    R_nb, R_bn, R_ss, R_sb = (t(rates[k]) for k in
                              ("R_nb", "R_bn", "R_ss", "R_sb"))
    D = t(D_bar)
    w = {k: t(v) for k, v in w.items()}
    rho_nb, rho_bs, I_s = w["rho_nb"], w["rho_bs"], w["I_s"]
    D_n = (1 - rho_nb.sum(1)) * D
    D_b = (rho_nb * D[:, None]).sum(0)
    D_s = (rho_bs * D_b[:, None]).sum(0)
    bD, bM = net["beta_data"], net["beta_model"]
    d_nb_D = bD * D[:, None] * rho_nb / (R_nb + EPS)
    d_nb_M = bM / (R_nb + EPS)
    d_bs_D = bD * D_b[:, None] * rho_bs / (w["R_bs"] + EPS)
    d_bs_M = bM / (w["R_bs"] + EPS)
    d_s_D = d_bs_D.amax(0) + d_nb_D.amax()
    off_diag = 1 - torch.eye(S, dtype=dtype)
    d_ss_M = bM / (R_ss + EPS) * off_diag
    g_n, g_s = w["gamma"][:N], w["gamma"][N:]
    m_n, m_s = w["m"][:N], w["m"][N:]
    work_n = net["cycles_per_point"] * g_n * m_n * D_n
    d_n_P = work_n / (w["f_n"] + EPS)
    E_n_P = work_n * w["f_n"] ** 2 * net["alpha_eff"] / 2
    M = net["machines_per_dc"]
    d_s_P = g_s * m_s * D_s / (M * w["z_s"] + EPS)
    peak, idle = net["dc_peak_power"], net["idle_fraction"]
    E_s_P = d_s_P * ((1 - idle) * (w["z_s"] / net["dc_point_capacity"]) ** 2
                     * peak * M + idle * peak * M)
    # aggregation: UE -> BS -> aggregator DC, DCs -> aggregator
    route = d_bs_M @ I_s
    d_n_A = (d_nb_M * w["I_nb"]).sum(1) + w["I_nb"] @ route
    E_n_A = (d_nb_M * net["ue_tx_power"] * w["I_nb"]).sum(1) \
        + w["I_nb"] @ (route * net["bs_dc_link_power"])
    d_s_A = (d_ss_M * I_s[None, :]).sum(1)
    E_A = E_n_A.sum() + (d_s_A * net["dc_dc_link_power"]).sum()
    delta_A = torch.maximum((d_n_A + d_n_P).amax(),
                            (d_s_D + d_s_P + d_s_A).amax())
    # broadcast: aggregator -> BSs -> UEs, aggregator -> DCs
    d_sb_M = bM / (R_sb + EPS)
    d_b_R = (d_sb_M * I_s[:, None]).sum(0)
    d_b_B = (bM / (R_bn + EPS) * w["I_bn"]).amax(1)
    d_s_R = (d_ss_M.T * I_s[:, None]).sum(0)
    delta_R = torch.maximum((d_b_R + d_b_B).amax(), d_s_R.amax())
    E_R = (d_b_R * net["dc_dc_link_power"]
           + d_b_B * net["bs_tx_power"]).sum() \
        + (d_s_R * net["dc_dc_link_power"]).sum()
    energy = (d_nb_D * net["ue_tx_power"]).sum() \
        + (d_bs_D * net["bs_dc_link_power"]).sum() \
        + E_n_P.sum() + E_s_P.sum() + E_A + E_R
    return float(energy), float(delta_A + delta_R)


# ------------------------------------------------------------ training --

def mlp_logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = x.reshape(x.shape[0], -1)
    n = len(p) // 2
    for i in range(n):
        h = h @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1:
            h = torch.relu(h)
    return h


def mlp_loss(p: dict, x, y) -> torch.Tensor:
    return torch.nn.functional.cross_entropy(mlp_logits(p, x), y.long())


def batch_size(D: int, m) -> int:
    return max(1, min(D, int(round(m * D)))) if D > 0 else 0


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def draw_batches(sizes, gammas, ms, generator, device):
    """Each live DPU's (gamma, batch) mini-batch indices, drawn in the
    engine's order.  ``ms`` are float32 per DPU: the grouping takes the
    float32 product, the drawn batch the float64 one, as the engine
    does."""
    groups = {}
    for i, D in enumerate(sizes):
        if D:
            key = (int(gammas[i]), float(ms[i]),
                   _bucket(batch_size(D, ms[i])))
            groups.setdefault(key, []).append(i)
    idx = {}
    for (gamma, m, _), members in groups.items():
        for i in members:
            keys = torch.rand((gamma, sizes[i]), generator=generator,
                              device=device)
            idx[i] = torch.argsort(keys, dim=1)[:, :batch_size(sizes[i], m)]
    return idx


def fedprox_round(p0: dict, data, gammas, ms, generator, *, eta: float,
                  mu: float, dtype=torch.float32, batch_keep: float = 1.0):
    """One CE-FL round from the global model ``p0``: every DPU holding
    data runs gamma_i proximal SGD steps on its drawn mini-batches,
    accumulating a_l grad (eq. 10); the models aggregate by eq. 11 with
    D_i weights and theta = sum_i w_i gamma_i.  ``data``: per DPU (x, y)
    device tensors (empty for none).  Returns (new model, D-weighted mean
    loss over every DPU's steps).  ``batch_keep`` < 1 keeps only the
    leading share of each mini-batch (a planted fault, for the tests)."""
    device = next(iter(p0.values())).device
    sizes = [int(y.shape[0]) for _, y in data]
    idx = draw_batches(sizes, gammas, ms, generator, device)
    base = {k: v.to(dtype) for k, v in p0.items()}
    D = np.array([sizes[i] for i in idx], np.float64)
    wts = D / D.sum()
    agg = {k: torch.zeros_like(v) for k, v in base.items()}
    theta, loss = 0.0, 0.0
    r = 1.0 - eta * mu
    for wi, (i, steps) in zip(wts, idx.items()):
        x, y = data[i]
        g_i = int(gammas[i])
        a = [r ** (g_i - 1 - k) for k in range(g_i)]
        p = dict(base)
        acc = {k: torch.zeros_like(v) for k, v in base.items()}
        losses = []
        for k in range(g_i):
            sel = steps[k][:max(1, int(len(steps[k]) * batch_keep))]
            leaves = {n: v.detach().requires_grad_(True) for n, v in p.items()}
            with torch.enable_grad():
                loss_k = mlp_loss(leaves, x[sel].to(dtype), y[sel])
                grads = torch.autograd.grad(loss_k, list(leaves.values()))
            losses.append(float(loss_k.detach()))
            for (n, v), g in zip(p.items(), grads):
                acc[n] = acc[n] + a[k] * g
            p = {n: v - eta * (g + mu * (v - base[n]))
                 for (n, v), g in zip(p.items(), grads)}
        for n in agg:
            agg[n] = agg[n] + wi * acc[n] / sum(a)
        theta += wi * g_i
        loss += wi * float(np.mean(losses))
    new = {n: base[n] - theta * eta * agg[n] for n in base}
    return new, loss
