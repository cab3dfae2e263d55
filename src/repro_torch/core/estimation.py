"""Monte-Carlo estimation of the ML constants (paper App. H, Algs. 4-6).
Counterpart of ``repro.core.estimation``:

  * Theta_i: local data variability (Assumption 2) — Alg. 4
  * L: smoothness (Assumption 1) — Alg. 5 (local max -> global max at s_est)
  * zeta1, zeta2: bounded dissimilarity (Assumption 3) — Alg. 6 via least
    squares on (sum p_i ||g_i||^2, ||sum p_i g_i||^2) pairs

Also the Alg.-7 post-processing (:func:`dynamic_update`, a running
max) and the Proposition-1 mini-batch variance bound
(:func:`sgd_variance_bound`).

All estimates are scaled by ``safety`` (paper uses 1.5x) before use.

Per-example gradients are ``torch.func.vmap(torch.func.grad(...))`` on the
device of the parameters.  The random probes (models, example subsets)
come from a :class:`Draws`, in the order the reference draws them, so a
test can hand in the reference's ``jax.random`` probes as arrays; the
port's own draws use a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch.core.convergence import MLConstants
from repro_torch.device import data_on


class Draws:
    """The estimation's random probes, from ``generator`` (on the device
    of the tensors it draws for)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def params_like(self, template: dict, scale: float) -> dict:
        """A model shaped like ``template``: standard normal times
        ``scale``, leaves in sorted key order."""
        return {k: torch.randn(template[k].shape, generator=self.generator,
                               device=template[k].device,
                               dtype=template[k].dtype) * scale
                for k in sorted(template)}

    def choice(self, D: int, n: int, device) -> torch.Tensor:
        """``n`` distinct indices of ``range(D)``."""
        return torch.randperm(D, generator=self.generator,
                              device=device)[:n]


def _flat(g: dict) -> torch.Tensor:
    return torch.cat([g[k].reshape(-1) for k in sorted(g)])


def estimate_theta(loss_fn: Callable, params_template, data: dict, *,
                   draws: Draws, iters: int = 10, sample: int = 32) -> float:
    """Alg. 4: Theta_i ~= max_j mean_{xi,xi'} ||grad f(x;xi)-grad f(x;xi')||
    / ||xi - xi'||  over random models x_j."""
    dev = next(iter(params_template.values())).device
    data = data_on(data, dev)
    D = data["y"].shape[0]
    n = min(sample, D)
    per_ex_grad = vmap(
        grad(lambda p, x, y: loss_fn(p, {"x": x[None], "y": y[None]})),
        in_dims=(None, 0, 0))
    best = 0.0
    for _ in range(iters):
        p = draws.params_like(params_template, 0.5)
        idx = draws.choice(D, n, dev)
        xs, ys = data["x"][idx], data["y"][idx]
        G = vmap(_flat)(per_ex_grad(p, xs, ys))           # (n, P)
        X = xs.reshape(n, -1).to(torch.float32)
        gd = torch.linalg.norm(G[:, None] - G[None, :], dim=-1)
        xd = torch.linalg.norm(X[:, None] - X[None, :], dim=-1)
        mask = xd > 1e-9
        ratio = torch.where(mask, gd / torch.clamp(xd, min=1e-9),
                            torch.zeros_like(gd))
        best = max(best, float(torch.mean(ratio)))  # Alg. 4 averages pairs
    return best


def estimate_L(loss_fn: Callable, params_template, data: dict, *,
               draws: Draws, iters: int = 10) -> float:
    """Alg. 5 local part: max_j ||grad F(x1)-grad F(x2)|| / ||x1-x2||."""
    dev = next(iter(params_template.values())).device
    data = data_on(data, dev)
    grad_fn = grad(lambda p: loss_fn(p, data))
    best = 0.0
    for _ in range(iters):
        p1 = draws.params_like(params_template, 0.5)
        p2 = draws.params_like(params_template, 0.5)
        g1, g2 = _flat(grad_fn(p1)), _flat(grad_fn(p2))
        dx = _flat(p1) - _flat(p2)
        best = max(best, float(torch.linalg.norm(g1 - g2) / torch.clamp(
            torch.linalg.norm(dx), min=1e-9)))
    return best


def estimate_zeta(loss_fn: Callable, params_template,
                  datasets: Sequence[dict], *, draws: Draws,
                  iters: int = 10):
    """Alg. 6: linear regression of sum p_i||g_i||^2 on ||sum p_i g_i||^2."""
    dev = next(iter(params_template.values())).device
    datasets = [data_on(d, dev) for d in datasets]
    D = np.array([d["y"].shape[0] for d in datasets], np.float64)
    p = D / D.sum()
    lhs, rhs = [], []
    for _ in range(iters):
        x = draws.params_like(params_template, 0.5)
        gs = [_flat(grad(lambda pp, d=d: loss_fn(pp, d))(x))
              for d in datasets]
        lhs.append(float(sum(pi * float(torch.sum(g * g))
                             for pi, g in zip(p, gs))))
        gbar = sum(pi * g for pi, g in zip(p, gs))
        rhs.append(float(torch.sum(gbar * gbar)))
    A = np.stack([np.array(rhs), np.ones(len(rhs))], axis=1)
    sol, *_ = np.linalg.lstsq(A, np.array(lhs), rcond=None)
    zeta1 = max(float(sol[0]), 1.0)                    # Assumption 3: >= 1
    zeta2 = max(float(sol[1]), 0.0)
    return zeta1, zeta2


def estimate_constants(loss_fn: Callable, params_template,
                       datasets: Sequence[dict], *, draws: Draws,
                       iters: int = 8, safety: float = 1.5,
                       f0_gap: float = 2.3) -> MLConstants:
    """One-shot pre-training estimation (App. H-1) across all DPUs, on
    the device of ``params_template``; ``datasets`` hold numpy arrays or
    tensors."""
    theta = np.array([
        estimate_theta(loss_fn, params_template, d, draws=draws, iters=iters)
        for d in datasets])
    L = max(estimate_L(loss_fn, params_template, d, draws=draws,
                       iters=iters) for d in datasets)
    z1, z2 = estimate_zeta(loss_fn, params_template, datasets, draws=draws,
                           iters=iters)
    # sigma_i^2 = sample variance of the data VECTORS (Prop. 1 pairs it with
    # Theta_i^2 ||xi - xi'||^2 terms): mean squared distance to the mean.
    sigma = []
    for d in datasets:
        flat = np.asarray(d["x"]).reshape(len(d["x"]), -1)
        sigma.append(np.sqrt(np.mean(np.sum(
            (flat - flat.mean(0, keepdims=True)) ** 2, axis=1))))
    sigma = np.array(sigma)
    return MLConstants(L=safety * L, theta_i=safety * theta,
                       sigma_i=sigma, zeta1=safety * z1, zeta2=safety * z2,
                       F0_gap=f0_gap)


def dynamic_update(old: MLConstants, new: MLConstants) -> MLConstants:
    """Alg. 7 post-processing: element-wise running max."""
    return MLConstants(
        L=max(old.L, new.L),
        theta_i=np.maximum(old.theta_i, new.theta_i),
        sigma_i=np.maximum(old.sigma_i, new.sigma_i),
        zeta1=max(old.zeta1, new.zeta1),
        zeta2=max(old.zeta2, new.zeta2),
        F0_gap=max(old.F0_gap, new.F0_gap))


def sgd_variance_bound(m_frac: float, D: int, sigma: float,
                       theta: float) -> float:
    """Proposition 1: E||grad_tilde F - grad F||^2 <=
    2 (1-m)(D-1)/(m D^2) * sigma^2 * Theta^2 (without-replacement)."""
    m = np.clip(m_frac, 1e-9, 1.0)
    return float(2 * (1 - m) * (D - 1) / (m * D ** 2) * sigma ** 2
                 * theta ** 2)
