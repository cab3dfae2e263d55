"""The sharded parameter plane on a ``('dpu', 'rows')`` process mesh: the
multi-rank form of the fused CE-FL round.  Counterpart of
``repro.sharding.plane``.

Mesh axes (``sharding/mesh.py``):

* ``'dpu'``: data parallelism over the leading DPU axis of a ``(G, R,
  LANE)`` stack and its mini-batch index / weight arrays: each rank
  trains its own slice of the DPU group (eqs. 5-10), and the eq.-11
  aggregation combines the ranks' ``d_i`` blocks.
* ``'rows'``: FSDP-style sharding of the ``(R, LANE)`` master plane:
  parameters stay row-sharded, the whole plane is all-gathered for each
  local step's loss and gradient, and each rank keeps its own row block
  of the gradient and of the accumulator.

A dim whose size the axis does not divide is replicated instead
(``plane_axes``): a ragged DPU group trains whole on every rank of the
'dpu' axis.

Every rank calls the entry points with the same global tensors (as a JAX
caller holds global arrays), cuts its own block, runs the hand-written
kernels on it (``ops.fedprox_accum_plane``, ``ops.nova_aggregate_plane``
and its stacked form, ``ops.robust_aggregate_plane``: the tensor's device
decides the dispatch, as everywhere) and gathers the result, which every
rank then holds in full.  A rank outside the mesh runs the single-device
op instead.

The eq.-11 reduction has two modes.  ``reduce="exact"`` (the default)
all-gathers the ``d_i`` stack and the weights over 'dpu' and runs the SAME
reduction on every rank's rows: the same kernel, the same DPU order, so
the result is bitwise the single-device one.  ``reduce="psum"`` reduces
each rank's own DPUs (the kernel's weighted sum at x = 0, theta_eta = -1)
and combines the partials with ONE all-reduce over 'dpu', then applies
the update (the kernel over the one summed plane): float addition
reorders, so it is allclose, not bitwise.

Bitwise contract.  The 'rows' axis and the three ops are bitwise for any
split: the kernels are elementwise in the rows, and the gathers move
data.  The 'dpu' split of the fused round is bitwise wherever the per-DPU
gradients do not depend on how many DPUs one batched loss carries: the
classifier's ``torch.bmm`` runs over the rank's DPUs, and a BLAS may pick
its algorithm by the batch count (ROADMAP queue 3).  The collective
counts of the reference's jaxpr contracts hold: ``"exact"`` issues
all-gathers and no all-reduce, ``"psum"`` exactly one all-reduce for
eq. 11 (``mesh.COLLECTIVES``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import fedprox
from repro_torch.core.round_step import (CEFLHyper, _a_k, _example_mask,
                                         _normalized, a_l1,
                                         build_cefl_round_step)
from repro_torch.kernels import ops
from repro_torch.kernels.plane import as_plane
from repro_torch.sharding.mesh import DPU_AXIS, PlaneMesh, plane_axes

F32 = torch.float32
REDUCE_MODES = ("exact", "psum")

# sharded rounds run, counted where they run: "fused" (the fused round,
# local_round_plane_sharded) and "mesh" (the sharded mesh round step)
ROUNDS = {"fused": 0, "mesh": 0}


def reset_rounds() -> None:
    for k in ROUNDS:
        ROUNDS[k] = 0


def _check_reduce(reduce: str) -> None:
    if reduce not in REDUCE_MODES:
        raise ValueError(f"unknown reduce mode {reduce!r}; known: "
                         f"{REDUCE_MODES}")


def _unshard_stack(mesh: PlaneMesh, t, g_ax, r_ax):
    """A ``(G_loc, R_loc, LANE)`` block gathered to the whole stack."""
    return mesh.gather(mesh.gather(t, r_ax, dim=1), g_ax, dim=0)


def _eq11(mesh: PlaneMesh, g_ax, x, d, w, theta_eta, reduce: str):
    """eq. 11 on this rank's rows ``x`` (R_loc, LANE), from its DPUs'
    ``d`` (G_loc, R_loc, LANE) and their normalized weights ``w``.  The
    psum mode needs a 'dpu' axis that splits; on one that does not, both
    modes are the one local reduction."""
    if reduce == "psum" and g_ax is not None and mesh.size(g_ax) > 1:
        # the kernel's weighted sum alone: 0 - (-1) * sum_i w_i d_i
        part = ops.nova_aggregate_plane(torch.zeros_like(x), d, w, -1.0)
        total = mesh.all_reduce(part, DPU_AXIS)
        one = torch.ones((1,), dtype=F32, device=x.device)
        return ops.nova_aggregate_plane(x, total.unsqueeze(0), one,
                                        theta_eta)
    d = mesh.gather(d, g_ax, dim=0)
    w = mesh.gather(w, g_ax, dim=0)
    return ops.nova_aggregate_plane(x, d, w, theta_eta)


# ------------------------------------------------- sharded plane ops -----

def fedprox_accum_plane_sharded(x, g, anchor, acc, coef, active, eta, mu, *,
                                mesh: PlaneMesh):
    """Sharded batched proximal step + eq.-10 accumulation on ``(G, R,
    LANE)`` stacks (``anchor`` shared ``(R, LANE)`` or per DPU): one
    ``fedprox_accum`` launch on this rank's block.  Elementwise, so any
    split is bitwise.  Returns the whole ``(x_new, acc_new)``."""
    coef = torch.as_tensor(coef, dtype=F32, device=x.device)
    active = torch.as_tensor(active, dtype=F32, device=x.device)
    if not mesh.member:
        return ops.fedprox_accum_plane(x, g, anchor, acc, coef, active, eta,
                                       mu)
    G, R = x.shape[0], x.shape[1]
    g_ax, r_ax = plane_axes(mesh, G, R)
    gs, rs = mesh.block(g_ax, G), mesh.block(r_ax, R)
    an = anchor[gs, rs] if anchor.dim() == 3 else anchor[rs]
    # plane blocks start at whole rows; per-DPU vectors are copied, as the
    # kernels take 16-byte aligned tensors
    xo, ao = ops.fedprox_accum_plane(
        x[gs, rs].contiguous(), g[gs, rs].contiguous(), an.contiguous(),
        acc[gs, rs].contiguous(), coef[gs].clone(), active[gs].clone(),
        eta, mu)
    return (_unshard_stack(mesh, xo, g_ax, r_ax),
            _unshard_stack(mesh, ao, g_ax, r_ax))


def nova_aggregate_plane_sharded(x, d_stack, weights, theta_eta, *,
                                 mesh: PlaneMesh, reduce: str = "exact"):
    """Sharded eq. 11 on an ``(R, LANE)`` plane, ``weights`` normalized.
    ``reduce="exact"`` is bitwise the single-device op; ``"psum"`` is
    allclose (module docstring)."""
    _check_reduce(reduce)
    w = torch.as_tensor(weights, dtype=F32, device=x.device)
    if not mesh.member:
        return ops.nova_aggregate_plane(x, d_stack, w, theta_eta)
    g_ax, r_ax = plane_axes(mesh, d_stack.shape[0], x.shape[0])
    gs, rs = mesh.block(g_ax, d_stack.shape[0]), mesh.block(r_ax,
                                                            x.shape[0])
    new = _eq11(mesh, g_ax, x[rs].contiguous(),
                d_stack[gs, rs].contiguous(), w[gs].clone(), theta_eta,
                reduce)
    return mesh.gather(new, r_ax, dim=0)


def robust_aggregate_plane_sharded(x, d_stack, theta_eta, *,
                                   mesh: PlaneMesh,
                                   mode: str = "trimmed_mean",
                                   trim_frac: float = 0.1):
    """Sharded byzantine-robust eq. 11: the coordinate-wise sort needs
    every DPU, so the ``d_i`` stack is all-gathered over 'dpu' and the
    ``robust_aggregate`` kernel reduces this rank's rows.  Bitwise the
    single-device op."""
    if not mesh.member:
        return ops.robust_aggregate_plane(x, d_stack, theta_eta, mode=mode,
                                          trim_frac=trim_frac)
    G, R = d_stack.shape[0], x.shape[0]
    g_ax, r_ax = plane_axes(mesh, G, R)
    gs, rs = mesh.block(g_ax, G), mesh.block(r_ax, R)
    d = mesh.gather(d_stack[gs, rs].contiguous(), g_ax, dim=0)
    out = ops.robust_aggregate_plane(x[rs].contiguous(), d, theta_eta,
                                     mode=mode, trim_frac=trim_frac)
    return mesh.gather(out, r_ax, dim=0)


# ------------------------------------------------ sharded fused round -----

class _Rows:
    """The 'rows' side of a local step: the row block gathered to the
    whole plane for the loss and gradient, the gradient cut back to the
    block."""

    def __init__(self, mesh: PlaneMesh, r_ax, rs: slice):
        self.mesh, self.r_ax, self.rs = mesh, r_ax, rs

    def full(self, p):
        return self.mesh.gather(p, self.r_ax, dim=1)

    def own(self, g):
        return g if self.r_ax is None else g[:, self.rs].contiguous()


def _sharded_round_fn(loss_fn: Callable, spec, mesh: PlaneMesh,
                      eval_fn=None, reduce: str = "exact"):
    """The sharded twin of ``fedprox._plane_round_fn``: the same ten
    staged arguments (global, every rank the same), the same return
    ``(new_plane_data, losses, acc_or_())``.  Each rank trains its 'dpu'
    slice of the group on its 'rows' block (one ``fedprox_accum`` launch
    a local step), then eq. 10, eq. 11 in ``reduce`` mode, the gather of
    the aggregate's rows, and the eval pass on the whole new plane."""
    _check_reduce(reduce)
    if not mesh.member:
        return fedprox._plane_round_fn(loss_fn, spec, eval_fn)

    def round_run(p_stack, anchor, data_stack, idx, weights, a, eta, mu,
                  w_abs, theta_eta):
        G = p_stack.shape[0]
        g_ax, r_ax = plane_axes(mesh, G, spec.rows)
        gs, rs = mesh.block(g_ax, G), mesh.block(r_ax, spec.rows)
        dev = p_stack.device
        run = fedprox._plane_train_core(loss_fn, spec,
                                        rows=_Rows(mesh, r_ax, rs))
        a = torch.as_tensor(a, dtype=F32, device=dev)
        anchor_l = anchor[rs].contiguous()
        _p, acc, losses = run(
            p_stack[gs, rs].contiguous(), anchor_l,
            {k: v[gs] for k, v in data_stack.items()}, idx[:, gs],
            weights[:, gs], a, eta, mu)
        losses = mesh.gather(losses, g_ax, dim=1)
        d = acc / torch.sum(a)
        wabs = torch.as_tensor(w_abs, dtype=F32, device=dev)
        w = wabs / torch.sum(wabs)              # the single normalization
        new = mesh.gather(_eq11(mesh, g_ax, anchor_l, d, w[gs].clone(),
                                theta_eta, reduce), r_ax, dim=0)
        if eval_fn is None:
            return new, losses, ()
        with torch.no_grad():
            return new, losses, eval_fn(spec.unflatten(new))

    return round_run


def local_round_plane_sharded(params, loss_fn: Callable, datasets, *,
                              gamma: int, m_frac: float, eta: float,
                              mu: float, generator: torch.Generator,
                              theta: float, mesh: PlaneMesh, eval_fn=None,
                              reduce: str = "exact"):
    """The sharded twin of :func:`fedprox.local_round_plane`: the same
    staging on every rank (the same draws from the same ``generator``
    state), the same return ``(new_plane, per_dpu_mean_losses, acc)``;
    ``reduce="exact"`` gives the single-device round's bits wherever the
    module docstring's contract holds.  Counts one ``ROUNDS["fused"]``."""
    _check_reduce(reduce)
    plane = as_plane(params)
    dev = plane.data.device
    G = len(datasets)
    Ds, bucket = fedprox._group_layout(datasets, m_frac)
    p0 = plane.broadcast(G).data
    a = fedprox.a_coefficients(gamma, eta, mu)
    data_stack, idx, weights = fedprox._stage_group_batches(
        datasets, generator, Ds, bucket, gamma, m_frac, dev)
    run = _sharded_round_fn(loss_fn, plane.spec, mesh, eval_fn, reduce)
    new_data, losses, acc = run(
        p0, plane.data, data_stack, idx, weights, a, eta, mu,
        torch.tensor(Ds, dtype=F32), theta * eta)
    ROUNDS["fused"] += 1
    return (plane.with_data(new_data), fedprox.step_means(losses),
            None if eval_fn is None else float(acc))


# -------------------------------------------------- sharded mesh round ---

def build_sharded_round_step(loss_fn: Callable, hyper: CEFLHyper,
                             mesh: PlaneMesh):
    """The plane form of ``core.round_step.build_cefl_round_step`` with
    the ``(n, R, LANE)`` replica stack split over ``mesh``: each rank
    holds its (dpu, rows) block; per local step the rows are all-gathered
    for the loss and gradient and ONE ``fedprox_accum`` launch (per-DPU
    anchor) updates the block; then d = acc / ||a||_1 is all-gathered over
    'dpu' and ONE ``nova_aggregate_stacked`` launch updates every replica
    of this rank's rows (the aggregate is replicated over 'dpu', as the
    fused round's is).  Returns ``round_step(plane, batch, meta) ->
    (new_plane, metrics)`` with the plane form's contract; every rank gets
    the whole stack.  Allclose to the single-device step (the reference's
    contract); counts one ``ROUNDS["mesh"]`` a call."""
    eta, mu, theta = hyper.eta, hyper.mu, hyper.theta
    gamma_max, n_micro = hyper.gamma_max, hyper.n_micro
    inv = 1.0 / n_micro
    if not mesh.member:
        return build_cefl_round_step(loss_fn, hyper)

    def round_step(plane, batch, meta):
        spec = plane.spec
        n, R = plane.data.shape[:2]
        g_ax, r_ax = plane_axes(mesh, n, R)
        gs, rs = mesh.block(g_ax, n), mesh.block(r_ax, R)
        rows = _Rows(mesh, r_ax, rs)
        p0 = plane.data[gs, rs].contiguous()
        gamma = meta["gamma"][gs]
        w = _normalized(meta["weight"])
        micros = [{name: x[gs, j] for name, x in batch.items()}
                  for j in range(n_micro)]
        mask = _example_mask(meta["m_frac"][gs],
                             next(iter(batch.values())).shape[2])

        def grad(p):
            loss_s = torch.zeros(p.shape[0], dtype=F32, device=p.device)
            g_acc = torch.zeros_like(p)
            for micro in micros:
                leaf = rows.full(p).detach().requires_grad_(True)
                with torch.enable_grad():
                    losses = loss_fn(spec.unflatten_batched(leaf), micro,
                                     mask)
                    (gp,) = torch.autograd.grad(losses.sum(), leaf)
                loss_s = loss_s + losses.detach()
                g_acc = g_acc + rows.own(gp)
            return loss_s * inv, g_acc * inv

        p, acc = p0, torch.zeros_like(p0)
        losses = None
        for k in range(gamma_max):
            losses, g = grad(p)
            active = (gamma > k).to(F32)
            p, acc = ops.fedprox_accum_plane(
                p, g.contiguous(), p0, acc, _a_k(gamma, k, eta, mu), active,
                eta, mu)
        d = mesh.gather(acc / a_l1(gamma, eta, mu)[:, None, None], g_ax,
                        dim=0)
        new = ops.nova_aggregate_plane(plane.data[:, rs].contiguous(), d, w,
                                       theta * eta)
        losses = mesh.gather(losses, g_ax, dim=0)
        ROUNDS["mesh"] += 1
        return (plane.with_data(mesh.gather(new, r_ax, dim=1)),
                {"loss": torch.mean(losses)})

    return round_step
