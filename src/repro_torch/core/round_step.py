"""The mesh-native CE-FL round: the paper's heterogeneous FedProx round
(eqs. 5-11) as ONE step over every live DPU at once.  Counterpart of
``repro.core.round_step``.

Every parameter carries a leading ``n_dpu`` axis.  Heterogeneity is
uniform control flow: all DPUs run to ``gamma_max`` local iterations, and
the per-DPU activity mask ``k < gamma_i`` and the FedNova coefficients
a_{i,l} = (1-eta*mu)^(gamma_i-1-l) zero out the inactive steps.  The round
ends with the eq.-11 weighted aggregation, applied to every replica row.

Batches arrive as ``(n_dpu, n_micro, mb, ...)``: every local iteration
accumulates the gradient over the n_micro microbatches, and the CE-FL
mini-batch ratio m_i is a leading-example mask ``arange(mb) < ceil(m_i *
mb)``.  Nothing is drawn, so the round is deterministic.

``loss_fn(params, batch, mask)`` follows the port's batched convention:
params whose leaves carry the leading n axis, a ``(n, mb, ...)`` batch and
an ``(n, mb)`` mask give ``(n,)`` losses (``models.classifier
.classifier_loss`` does).

Two forms, as in the JAX package:

* the plane form (params a :class:`ParamPlane` with ``(n, R, LANE)``
  data), the hot path: per local step one batched forward pass, one
  ``torch.autograd.grad`` of the summed losses and ONE ``fedprox_accum``
  launch over all n DPUs with the per-DPU anchor; then ONE
  ``nova_aggregate_stacked`` launch;
* the tree form (a dict tree with a leading n axis): plain torch per leaf,
  with ``grad_dtype`` accumulation and a ``tensordot`` eq. 11.  It has no
  kernel and is the plane form's oracle.

Coefficients are computed in f32 in the JAX package's closed forms
(``exp`` of a multiple of ``log(1 - eta*mu)``, not ``pow``), so that the
two packages agree to f32 rounding.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable

import torch

from repro_torch import tracing
from repro_torch.device import require_device
from repro_torch.kernels import ops
from repro_torch.kernels.plane import (ParamPlane, grad_plane_bytes,
                                      tree_from_paths, tree_paths)

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class CEFLHyper:
    eta: float = 1e-2          # local SGD step size
    mu: float = 0.01           # FedProx proximal coefficient
    theta: float = 1.0         # global scaling (vartheta in eq. 11)
    gamma_max: int = 1         # max local iterations (per-DPU gamma <= this)
    n_micro: int = 1           # microbatches per DPU batch
    grad_dtype: str = "float32"        # accumulated-gradient dtype (tree)


def _log_r(eta: float, mu: float, device) -> torch.Tensor:
    """log(1 - eta*mu), the Python number rounded to f32 first, as
    ``jnp.log`` of a Python float does."""
    return torch.log(torch.tensor(1.0 - eta * mu, dtype=F32, device=device))


def a_l1(gamma: torch.Tensor, eta: float, mu: float) -> torch.Tensor:
    """||a_i||_1 = sum_l (1-eta*mu)^(gamma-1-l) = (1 - r^gamma) / (1 - r),
    in f32 per DPU."""
    r = 1.0 - eta * mu
    g = gamma.to(F32)
    if abs(r - 1.0) < 1e-12:
        return g
    return (1.0 - torch.exp(g * _log_r(eta, mu, g.device))) / (1.0 - r)


def _a_k(gamma: torch.Tensor, k: int, eta: float, mu: float) -> torch.Tensor:
    """a_{i,k} = (1-eta*mu)^(gamma_i-1-k) per DPU (ones when eta*mu = 0,
    FedNova's proximal-free case)."""
    if eta * mu > 0:
        return torch.exp((gamma.to(F32) - 1.0 - k)
                         * _log_r(eta, mu, gamma.device))
    return torch.ones(gamma.shape, dtype=F32, device=gamma.device)


def _example_mask(m_frac: torch.Tensor, mb: int) -> torch.Tensor:
    """(n, mb) f32: the leading ceil(m_i * mb) examples of each DPU."""
    m = m_frac.to(F32)
    keep = torch.ceil(m * mb)
    return (torch.arange(mb, device=m.device)[None, :]
            < keep[:, None]).to(F32)


def _normalized(weight: torch.Tensor) -> torch.Tensor:
    w = weight.to(F32)
    return w / torch.sum(w)            # weight contract: absolute ok


def _per_dpu(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """An (n,) vector shaped to broadcast over a leaf with a leading n."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def build_cefl_round_step(loss_fn: Callable, hyper: CEFLHyper):
    """Returns ``round_step(params, batch, meta) -> (new_params,
    metrics)``.  ``params``: a :class:`ParamPlane` with ``(n, R, LANE)``
    data (the plane form, returns a ParamPlane) or a dict tree whose
    leaves carry a leading n axis (the tree form); ``batch`` leaves are
    ``(n, n_micro, mb, ...)``; ``meta`` = {'gamma': (n,) int, 'm_frac':
    (n,) f32, 'weight': (n,) f32 absolute D_i sizes, normalized inside the
    step}, on the params' device.  ``metrics['loss']`` is the unweighted
    DPU mean of the last local iteration's losses."""
    eta, mu, theta = hyper.eta, hyper.mu, hyper.theta
    gamma_max, n_micro = hyper.gamma_max, hyper.n_micro
    acc_dt = getattr(torch, hyper.grad_dtype)
    inv = 1.0 / n_micro
    calls = itertools.count()      # the round id of a traced plane step

    def micro_batches(batch):
        return [{name: x[:, j] for name, x in batch.items()}
                for j in range(n_micro)]

    def round_step_plane(plane: ParamPlane, batch, meta):
        """Per local step: one forward pass over the (n, mb) stack, one
        autograd.grad, one fedprox_accum launch; then d = acc / ||a||_1
        and one nova_aggregate_stacked launch.  Traced as ``round_step``
        with ``round_step.forward`` / ``round_step.backward`` spans; the
        backward counts ``grad_plane_bytes``, the bytes it wrote into
        gradient planes, and ``plane_bytes``, those of the plane it
        returned."""
        with tracing.span("round_step", round=next(calls)):
            return _round_step_plane(plane, batch, meta)

    def _round_step_plane(plane: ParamPlane, batch, meta):
        spec = plane.spec
        p0 = plane.data                        # (n, R, LANE), contiguous
        gamma = meta["gamma"]
        w = _normalized(meta["weight"])
        micros = micro_batches(batch)
        mask = _example_mask(meta["m_frac"],
                             next(iter(batch.values())).shape[2])

        def grad(p):
            """Mean loss and gradient over the n_micro microbatches,
            per DPU: (n,), (n, R, LANE).  The gradient sums into the
            first microbatch's plane."""
            loss_s = torch.zeros(p.shape[0], dtype=F32, device=p.device)
            g_acc = None
            for micro in micros:
                leaf = p.detach().requires_grad_(True)
                with torch.enable_grad():
                    with tracing.span("round_step.forward"):
                        losses = loss_fn(spec.unflatten_batched(leaf),
                                         micro, mask)
                    total = losses.sum()
                    with tracing.span("round_step.backward"):
                        written = grad_plane_bytes()
                        (gp,) = torch.autograd.grad(total, leaf)
                        tracing.count("grad_plane_bytes",
                                      grad_plane_bytes() - written)
                        tracing.count("plane_bytes",
                                      gp.numel() * gp.element_size())
                loss_s = loss_s + losses.detach()
                g_acc = gp if g_acc is None else g_acc.add_(gp)
            if n_micro > 1:
                g_acc.mul_(inv)
            return loss_s * inv, g_acc

        p, acc = p0, torch.zeros_like(p0)
        losses = None
        for k in range(gamma_max):
            losses, g = grad(p)
            active = (gamma > k).to(F32)
            p, acc = ops.fedprox_accum_plane(
                p, g.contiguous(), p0, acc, _a_k(gamma, k, eta, mu), active,
                eta, mu)
        d = acc / a_l1(gamma, eta, mu)[:, None, None]
        # eq. (11): the weighted reduction + update, every replica row
        new = ops.nova_aggregate_plane(p0, d, w, theta * eta)
        return plane.with_data(new), {"loss": torch.mean(losses)}

    def round_step_tree(params, batch, meta):
        """The same round on dict trees, per leaf, in plain torch."""
        gamma = meta["gamma"]
        w = _normalized(meta["weight"])
        micros = micro_batches(batch)
        mask = _example_mask(meta["m_frac"],
                             next(iter(batch.values())).shape[2])
        paths = [path for path, _ in tree_paths(params)]

        def grad(p):
            leaves = [x.detach().requires_grad_(True)
                      for _, x in tree_paths(p)]
            loss_s = torch.zeros(gamma.shape, dtype=F32, device=gamma.device)
            g_acc = [torch.zeros(x.shape, dtype=acc_dt, device=x.device)
                     for x in leaves]
            for micro in micros:
                with torch.enable_grad():
                    losses = loss_fn(tree_from_paths(paths, leaves), micro,
                                     mask)
                    gs = torch.autograd.grad(losses.sum(), leaves)
                loss_s = loss_s + losses.detach()
                g_acc = [a + g.to(acc_dt) for a, g in zip(g_acc, gs)]
            return loss_s * inv, [g * inv for g in g_acc]

        anchor = [x for _, x in tree_paths(params)]
        p = anchor
        acc = [torch.zeros(x.shape, dtype=acc_dt, device=x.device)
               for x in anchor]
        losses = None
        for k in range(gamma_max):
            losses, gs = grad(tree_from_paths(paths, p))
            active = (gamma > k).to(F32)
            coef = active * _a_k(gamma, k, eta, mu)
            step = active * eta
            p = [(pp.float() - _per_dpu(step, pp)
                  * (g.float() + mu * (pp.float() - x0.float()))
                  ).to(pp.dtype) for pp, g, x0 in zip(p, gs, anchor)]
            acc = [a + (_per_dpu(coef, a) * g.float()).to(acc_dt)
                   for a, g in zip(acc, gs)]
        norm = a_l1(gamma, eta, mu)
        out = []
        for x0, a in zip(anchor, acc):
            d = a / _per_dpu(norm, a).to(a.dtype)
            # eq. (11): the only cross-DPU reduction
            d_bar = torch.tensordot(w.to(d.dtype), d, dims=([0], [0]))
            out.append((x0.float() - theta * eta * d_bar.float()[None]
                        ).to(x0.dtype))
        return tree_from_paths(paths, out), {"loss": torch.mean(losses)}

    def round_step(params, batch, meta):
        if isinstance(params, ParamPlane):
            return round_step_plane(params, batch, meta)
        return round_step_tree(params, batch, meta)

    return round_step


def make_dpu_meta(n_dpu: int, *, gammas=None, m_fracs=None, weights=None,
                  device="cuda") -> dict:
    """The round step's ``meta`` on ``device``.  ``weights`` follow the
    absolute-size contract: pass D_i dataset sizes; the step normalizes
    once (normalized weights pass through unchanged)."""
    dev = require_device(device)
    gammas = gammas if gammas is not None else [1] * n_dpu
    m_fracs = m_fracs if m_fracs is not None else [1.0] * n_dpu
    weights = weights if weights is not None else [1.0 / n_dpu] * n_dpu
    return {"gamma": torch.as_tensor(gammas, dtype=torch.int32, device=dev),
            "m_frac": torch.as_tensor(m_fracs, dtype=F32, device=dev),
            "weight": torch.as_tensor(weights, dtype=F32, device=dev)}
