"""Plain reference of the byzantine CE-FL round at paper width: the
``byzantine`` scenario's rate draws (radio links jittered as the static
world's, wired links by the scenario's own jitter), the sign-flip
adversary on the compromised UEs' accumulated gradients, and the
coordinate-wise trimmed mean that replaces eq. 11's weighted sum
(Yin et al. 2018), computed in float64.

NumPy and plain PyTorch only.  It imports neither the program nor JAX.
Local training is ``cefl.fedprox_round``'s: FedProx steps on the
mini-batches drawn in the engine's order, the eq.-10 accumulation
d_i = sum_l a_l grad / ||a||_1.  Then each compromised UE that holds data
reports -scale x d_i, the live DPUs' d_i are sorted coordinate by
coordinate, k = min(floor(n x trim_frac), (n - 1) // 2) are dropped at
each end, the rest averaged, and x <- x - theta x eta x mean with theta
the unweighted mean of the live DPUs' gamma (the D_i a compromised
client reports are not trusted).  ``defence=False`` aggregates by eq. 11
with D_i weights instead; ``flip=False`` leaves the adversary out.
"""
from __future__ import annotations

import numpy as np
import torch

from bench.reference.cefl import draw_batches, mlp_loss


def jitter_rates(rates: dict, rng: np.random.RandomState, radio: float,
                 wired: float) -> dict:
    """The round's rates: each link rate times a lognormal draw, in the
    order uplink, downlink (``radio``), DC-DC, DC-BS (``wired``)."""
    out = dict(rates)
    for k, s in (("R_nb", radio), ("R_bn", radio), ("R_ss", wired),
                 ("R_sb", wired)):
        out[k] = rates[k] * np.exp(rng.normal(0, s, rates[k].shape))
    return out


def compromised(n_ue: int, frac: float) -> tuple:
    """round(frac x n_ue) evenly spaced UEs."""
    k = int(round(frac * n_ue))
    if k <= 0:
        return ()
    return tuple(sorted({int(i) for i in np.round(
        np.linspace(0, n_ue - 1, num=min(k, n_ue))).astype(int)}))


def trim_count(n: int, trim_frac: float) -> int:
    return min(int(n * trim_frac), (n - 1) // 2)


def trimmed_mean(stack: torch.Tensor, k: int) -> torch.Tensor:
    """The coordinate-wise mean of stack (n, ...) after dropping the k
    smallest and the k largest values, in float64."""
    s = torch.sort(stack.double(), dim=0).values
    return s[k:stack.shape[0] - k].mean(dim=0)


def robust_round(p0: dict, data, gammas, ms, generator, *, eta: float,
                 mu: float, flipped: dict, trim_frac: float,
                 defence: bool = True, batch_keep: float = 1.0):
    """One byzantine CE-FL round from the global model ``p0``: local
    FedProx training as ``cefl.fedprox_round``, then ``flipped`` ({DPU:
    scale}) turns d_i into -scale x d_i, and the trimmed mean (or, with
    ``defence`` False, eq. 11) aggregates.  Returns (new model in
    float64, D-weighted mean loss)."""
    device = next(iter(p0.values())).device
    sizes = [int(y.shape[0]) for _, y in data]
    idx = draw_batches(sizes, gammas, ms, generator, device)
    base = {k: v.float() for k, v in p0.items()}
    r = 1.0 - eta * mu
    ds, gams, D, losses = [], [], [], []
    for i, steps in idx.items():
        x, y = data[i]
        g_i = int(gammas[i])
        a = [r ** (g_i - 1 - k) for k in range(g_i)]
        p = dict(base)
        acc = {k: torch.zeros_like(v) for k, v in base.items()}
        step_losses = []
        for k in range(g_i):
            sel = steps[k][:max(1, int(len(steps[k]) * batch_keep))]
            leaves = {n: v.detach().requires_grad_(True)
                      for n, v in p.items()}
            with torch.enable_grad():
                loss_k = mlp_loss(leaves, x[sel].float(), y[sel])
                grads = torch.autograd.grad(loss_k, list(leaves.values()))
            step_losses.append(float(loss_k.detach()))
            for (n, v), g in zip(p.items(), grads):
                acc[n] = acc[n] + a[k] * g
            p = {n: v - eta * (g + mu * (v - base[n]))
                 for (n, v), g in zip(p.items(), grads)}
        d_i = {n: acc[n].double() / sum(a) for n in acc}
        if i in flipped:
            d_i = {n: -flipped[i] * v for n, v in d_i.items()}
        ds.append(d_i)
        gams.append(g_i)
        D.append(float(sizes[i]))
        losses.append(float(np.mean(step_losses)))
    wts = np.array(D) / sum(D)
    loss = float(np.sum(wts * np.array(losses)))
    if defence:
        theta = float(np.mean(gams))
        k = trim_count(len(ds), trim_frac)
        agg = {n: trimmed_mean(torch.stack([d[n] for d in ds]), k)
               for n in base}
    else:
        theta = float(np.sum(wts * np.array(gams)))
        agg = {n: sum(w * d[n] for w, d in zip(wts, ds)) for n in base}
    new = {n: base[n].double() - theta * eta * agg[n] for n in base}
    return new, loss

