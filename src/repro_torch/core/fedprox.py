"""FedProx-style heterogeneous local training at a DPU (paper Sec. II-D).
Counterpart of the plane path of ``repro.core.fedprox``.

Implements eqs. (5)-(10): gamma_i local SGD steps on the proximal loss
g_i(x, x^t) = F_i(x) + (mu/2)||x - x^t||^2, with mini-batch ratio m_i, and
the FedNova-normalized accumulated gradient

    d_i = (1/||a_i||_1) sum_l a_{i,l} grad F_i(x^{t,l}),
    a_{i,l} = (1 - eta*mu)^(gamma_i - 1 - l).

Parameters live on the flat ``(G, R, LANE)`` parameter plane of a
homogeneous DPU group.  Each of the gamma local steps gathers the group's
mini-batches on the device, evaluates every DPU's loss in one batched
forward pass, takes the per-DPU gradients with ONE ``torch.autograd.grad``
of the summed losses (the losses are independent, so the gradient of the
sum w.r.t. the stacked plane is the stack of per-DPU gradients), and then
runs ONE launch of the ``fedprox_accum`` kernel, which does the proximal
update AND the eq.-10 accumulation for the whole group.

``loss_fn(params, batch, example_weights)`` takes params whose leaves carry
a leading DPU axis G, a batch of ``(G, B, ...)`` tensors and ``(G, B)``
weights, and returns ``(G,)`` losses (``models.classifier.classifier_loss``
does).

Mini-batches are drawn from a ``torch.Generator`` on the data's device,
one ``torch.rand((gamma, D_i))`` per DPU in group order; its draws differ
from the JAX package's ``jax.random`` streams.

Entry points: :func:`local_round_plane` (a fused single-group round) and
:func:`local_train_batched` (a group).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.kernels import ops
from repro_torch.kernels.plane import ParamPlane, as_plane


def a_coefficients(gamma: int, eta: float, mu: float) -> torch.Tensor:
    """a_{i,l} for l = 0..gamma-1 (eq. 8), f32 on the CPU."""
    ell = torch.arange(gamma, dtype=torch.float32)
    base = torch.tensor(1.0 - eta * mu, dtype=torch.float32)
    return torch.pow(base, (gamma - 1.0) - ell)


def a_norms(gamma: int, eta: float, mu: float):
    """(||a||_1, ||a||_2^2) of :func:`a_coefficients`, 0-d f32 tensors."""
    a = a_coefficients(gamma, eta, mu)
    return torch.sum(a), torch.sum(a * a)


@dataclasses.dataclass
class LocalResult:
    params: ParamPlane    # x_i^{(t, gamma_i)}
    d_i: ParamPlane       # normalized accumulated gradient
    num_examples: int     # D_i^{(t)}
    gamma: int
    sgd_flops: float      # processed examples * gamma (for cost models)
    loss: float = float("nan")   # mean mini-batch loss over the gamma steps


def batch_size(num_examples: int, m_frac: float) -> int:
    """clamp(round(m_frac * D), 1, D) — the one mini-batch size rule
    (0 for a degenerate D == 0 dataset)."""
    if num_examples <= 0:
        return 0
    return max(1, min(num_examples, int(round(m_frac * num_examples))))


def _draw_steps(generator: torch.Generator, num_examples: int, bsz: int,
                steps: int, device) -> torch.Tensor:
    """``steps`` uniform without-replacement draws of ``bsz`` of
    ``num_examples`` indices: ONE ``torch.rand((steps, D))`` call on
    ``generator``, argsorted per row.  Returns ``(steps, bsz)`` int64."""
    keys = torch.rand((steps, num_examples), generator=generator,
                      device=device)
    return torch.argsort(keys, dim=1)[:, :bsz]


def step_means(losses: torch.Tensor) -> np.ndarray:
    """Per-DPU mean over the gamma steps of a ``(gamma, G)`` loss stack
    (one host sync), each column reduced on its own, so a DPU's mean does
    not depend on how many DPUs share its group."""
    host = losses.cpu().numpy()
    return np.array([host[:, j].mean() for j in range(host.shape[1])],
                    dtype=host.dtype)


def _bucket(n: int) -> int:
    """Round batch sizes up to a power of two, so DPUs with nearby batch
    sizes share one group (and one kernel launch per step)."""
    b = 1
    while b < n:
        b *= 2
    return b


def _num_examples(d) -> int:
    return int(d["y"].shape[0])


# ------------------------------------------------- plane hot path -----

def _plane_train_core(loss_fn: Callable, spec, rows=None):
    """The full gamma-step local-training loop of a DPU group on
    parameter planes.  The dict view ``loss_fn`` needs is a set of slices
    of the plane, so autograd hands back the gradient as a plane; the
    per-step mini-batch gather happens on the device from one stacked
    ``(G, Db, ...)`` data tree and ``(gamma, G, bucket)`` index arrays.

    ``rows`` (the sharded round's, ``repro_torch.sharding.plane``): the
    stack is a block of plane rows; ``rows.full`` gathers it to the whole
    plane for the loss and ``rows.own`` cuts the gradient back to the
    block."""

    def run(p_stack, anchor, data_stack, idx, weights, a, eta, mu):
        """p_stack: (G, R, LANE), contiguous; anchor: (R, LANE) shared;
        ``data_stack`` leaves (G, Db, ...); idx: (gamma, G, bucket) int;
        weights (gamma, G, bucket); a: (gamma,) FedNova coefficients.
        Returns (p, acc, losses) with losses (gamma, G)."""
        G = p_stack.shape[0]
        dev = p_stack.device
        ones = torch.ones((G,), dtype=torch.float32, device=dev)
        dpus = torch.arange(G, device=dev)[:, None]
        a = torch.as_tensor(a, dtype=torch.float32, device=dev)
        p = p_stack
        acc = torch.zeros_like(p_stack)
        losses = []
        with tracing.span("executor.train"):
            for k in range(idx.shape[0]):
                batch_k = {name: xd[dpus, idx[k]]
                           for name, xd in data_stack.items()}
                full = p if rows is None else rows.full(p)
                leaf = full.detach().requires_grad_(True)
                with torch.enable_grad():
                    loss_k = loss_fn(spec.unflatten_batched(leaf), batch_k,
                                     weights[k])
                    (g,) = torch.autograd.grad(loss_k.sum(), leaf)
                if rows is not None:
                    g = rows.own(g)
                p, acc = ops.fedprox_accum_plane(
                    p, g.contiguous(), anchor, acc, a[k] * ones, ones, eta,
                    mu)
                losses.append(loss_k.detach())
        return p, acc, torch.stack(losses)

    return run


def _aggregate_group(anchor, acc, a, w_abs, theta_eta):
    """The fused round's eq. 10 + eq. 11 on the device: d = acc/||a||_1,
    the absolute weights ``w_abs`` normalized once, and one
    ``nova_aggregate`` launch at the global model ``anchor``."""
    a = torch.as_tensor(a, dtype=torch.float32, device=acc.device)
    d = acc / torch.sum(a)
    w_abs = torch.as_tensor(w_abs, dtype=torch.float32, device=acc.device)
    w = w_abs / torch.sum(w_abs)              # the single normalization
    return ops.nova_aggregate_plane(anchor, d, w, theta_eta)


def _plane_round_fn(loss_fn: Callable, spec, eval_fn=None):
    """A whole homogeneous-group round: the gamma-step training loop, the
    eq.-10 normalization d = acc/||a||_1, the eq.-11 aggregation at the
    global model and, when ``eval_fn`` is given, the eval forward pass on
    the aggregated model.  Takes the same ten staged arguments as the JAX
    package's ``_plane_round_fn`` and returns (new_plane_data, losses,
    acc_or_())."""
    run = _plane_train_core(loss_fn, spec)

    def round_run(p_stack, anchor, data_stack, idx, weights, a, eta, mu,
                  w_abs, theta_eta):
        _p, acc, losses = run(p_stack, anchor, data_stack, idx, weights, a,
                              eta, mu)
        new = _aggregate_group(anchor, acc, a, w_abs, theta_eta)
        if eval_fn is None:
            return new, losses, ()
        with torch.no_grad():
            return new, losses, eval_fn(spec.unflatten(new))

    return round_run


def _stack_data(datasets, Ds, device) -> dict:
    """A group's round data copied into one zero-padded ``(G, Db, ...)``
    stack per field on ``device`` (Db a power of two).  Counts the bytes
    of the host arrays copied as ``h2d_bytes`` (tracing)."""
    G = len(datasets)
    Db = _bucket(max(Ds))
    data_stack = {}
    nbytes = 0
    for name in datasets[0]:
        first = torch.as_tensor(datasets[0][name])
        stack = torch.zeros((G, Db) + tuple(first.shape[1:]),
                            dtype=first.dtype, device=device)
        for j, d in enumerate(datasets):
            src = torch.as_tensor(d[name])
            if src.device.type == "cpu":
                nbytes += src.nbytes
            stack[j, :Ds[j]].copy_(src)
        data_stack[name] = stack
    tracing.count("h2d_bytes", nbytes)
    return data_stack


def _draw_indices(generator, Ds, bucket, gamma, m_frac, device):
    """``(gamma, G, bucket)`` mini-batch index/weight arrays of a group:
    each DPU's gamma draws come from ``generator`` (on ``device``), one
    call per DPU in group order; padded slots gather example 0 with
    weight 0.  The draws depend on their order and shapes only, so DPUs
    drawn one at a time from the same generator get the same indices."""
    G = len(Ds)
    idx = torch.zeros((gamma, G, bucket), dtype=torch.int64, device=device)
    wts = torch.zeros((gamma, G, bucket), dtype=torch.float32, device=device)
    for j in range(G):
        bsz = batch_size(Ds[j], m_frac)
        idx[:, j, :bsz] = _draw_steps(generator, Ds[j], bsz, gamma, device)
        wts[:, j, :bsz] = 1.0
    return idx, wts


def _stage_group_batches(datasets, generator, Ds, bucket, gamma, m_frac,
                         device):
    """Stage a group's round data on ``device``: the zero-padded data
    stack (:func:`_stack_data`) and the mini-batch index/weight arrays
    (:func:`_draw_indices`).  Traced as ``executor.stage``."""
    with tracing.span("executor.stage"):
        idx, wts = _draw_indices(generator, Ds, bucket, gamma, m_frac,
                                 device)
        return _stack_data(datasets, Ds, device), idx, wts


def _group_layout(datasets, m_frac):
    Ds = [_num_examples(d) for d in datasets]
    bszs = [batch_size(D, m_frac) for D in Ds]
    bucket = _bucket(max(bszs))
    if any(_bucket(b) != bucket for b in bszs):
        raise ValueError("grouping must put same-bucket DPUs together")
    return Ds, bucket


def local_round_plane(params, loss_fn: Callable, datasets, *, gamma: int,
                      m_frac: float, eta: float, mu: float,
                      generator: torch.Generator, theta: float,
                      eval_fn=None):
    """One FUSED CE-FL round for a homogeneous-(gamma, m) DPU group: the
    training loop, eq. 10, the eq.-11 aggregation at ``theta`` and
    (optionally) the eval pass, with no host round-trip in between.
    Semantically equal to ``local_train_batched`` +
    ``aggregation.aggregate`` + ``eval_fn``.

    Returns ``(new_plane, per_dpu_mean_losses, acc)``: the losses are a
    host ``(G,)`` array (mean over the gamma steps, :func:`step_means`)
    and ``acc`` is None unless ``eval_fn`` was given."""
    plane = as_plane(params)
    dev = plane.data.device
    G = len(datasets)
    Ds, bucket = _group_layout(datasets, m_frac)
    p0 = plane.broadcast(G).data.contiguous()
    a = a_coefficients(gamma, eta, mu)
    data_stack, idx, weights = _stage_group_batches(
        datasets, generator, Ds, bucket, gamma, m_frac, dev)
    run = _plane_round_fn(loss_fn, plane.spec, eval_fn)
    new_data, losses, acc = run(
        p0, plane.data, data_stack, idx, weights, a, eta, mu,
        torch.tensor(Ds, dtype=torch.float32), theta * eta)
    return (plane.with_data(new_data), step_means(losses),
            None if eval_fn is None else float(acc))


def _empty_result(params, gamma: int) -> LocalResult:
    """A D == 0 DPU trains nothing: params unchanged, d_i = 0, nan loss."""
    plane = as_plane(params)
    return LocalResult(params=plane,
                       d_i=plane.with_data(torch.zeros_like(plane.data)),
                       num_examples=0, gamma=gamma, sgd_flops=0.0)


def local_train_batched(params, loss_fn: Callable, datasets, *, gamma: int,
                        m_frac: float, eta: float, mu: float,
                        generator: torch.Generator):
    """Local training for a homogeneous-(gamma, m) group of DPUs, all
    starting from the same global ``params``: one batched loss/grad plus
    one ``fedprox_accum`` launch per local step for the whole group.
    Returns one plane-backed :class:`LocalResult` per DPU.

    ``datasets``: per-DPU dicts of arrays or tensors with leading dim
    D_i (sizes may differ, but every DPU's mini-batch must land in the
    same power-of-two bucket, which the caller guarantees by grouping)."""
    live = [j for j, d in enumerate(datasets) if _num_examples(d) > 0]
    if len(live) < len(datasets):
        out = [_empty_result(params, gamma) for _ in datasets]
        if live:
            sub = local_train_batched(
                params, loss_fn, [datasets[j] for j in live], gamma=gamma,
                m_frac=m_frac, eta=eta, mu=mu, generator=generator)
            for j, r in zip(live, sub):
                out[j] = r
        return out
    plane = as_plane(params)
    G = len(datasets)
    Ds, bucket = _group_layout(datasets, m_frac)
    data_stack, idx, weights = _stage_group_batches(
        datasets, generator, Ds, bucket, gamma, m_frac, plane.data.device)
    a = a_coefficients(gamma, eta, mu)
    p_stack, acc, losses = _plane_train_core(loss_fn, plane.spec)(
        plane.broadcast(G).data.contiguous(), plane.data, data_stack, idx,
        weights, a, eta, mu)
    d_stack = acc / float(torch.sum(a))             # eq. 10
    mean_loss = step_means(losses)
    return [LocalResult(
        params=ParamPlane(data=p_stack[j], spec=plane.spec),
        d_i=ParamPlane(data=d_stack[j], spec=plane.spec),
        num_examples=Ds[j], gamma=gamma,
        sgd_flops=float(gamma) * m_frac * Ds[j],
        loss=float(mean_loss[j])) for j in range(G)]


def verify_accumulation_identity(params0, result: LocalResult, *, eta, mu):
    """Check eq. (9): (x^t - x^{t,gamma})/eta = ||a||_1 d_i = sum_l a_l
    grad F(x^{t,l}).  The proximal pull is the (1 - eta*mu) factor of
    a_l, so it holds for any mu.  Returns the max abs deviation over the
    plane (its zero padding deviates by 0) — used by tests."""
    diff = (as_plane(params0).data - result.params.data) / eta
    a1 = float(torch.sum(a_coefficients(result.gamma, eta, mu)))
    return float((diff - result.d_i.data * a1).abs().max())
