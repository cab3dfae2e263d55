"""Algorithm 2 (PD CE-FL): the distributed primal-dual solution of the
convexified surrogate problem P_{w^l} (eqs. 86-98).  Counterpart of
``repro.solver.primal_dual``.

The proximal surrogate (eqs. 82-85) has an isotropic quadratic around w^l,
so each node's partial-Lagrangian minimization (93) has the closed form

    w_d* = Proj_{D_d} [ w^l - (grad_d J + sum_c Lambda_d[c] grad_d C_c)
                               / (lambda1 + L_C * sum_c Lambda_d[c]) ]

followed by the eq.-(96) local dual ascent and Algorithm-3 consensus.

The decision dict is solved as one flat (P,) vector (``WSpec``), in eager
torch on the device of the inputs.  ``jax.grad`` becomes
``torch.func.grad``; the constraint vector is never differentiated into a
Jacobian: a dual row enters through one ``torch.func.vjp`` product (vmapped
over the V nodes in the distributed form), and the linearized constraints
of eqs. 84-85 through ``torch.func.jvp`` (vmapped over the nodes' masked
diffs).
"""
from __future__ import annotations

import dataclasses
import warnings

import torch
from torch.func import grad, jvp, vjp, vmap

from repro_torch.solver import constraints as K
from repro_torch.solver import variables as V
from repro_torch.solver.consensus import consensus_scan
from repro_torch.solver.objective import ObjectiveWeights, objective


@dataclasses.dataclass(frozen=True)
class PDHyper:
    """Hyper-parameters of Algorithm 2."""
    lambda1: float = 10.0       # proximal weight (eq. 83)
    L_C: float = 10.0           # constraint Lipschitz constant (eq. 85)
    kappa: float = 0.5          # dual step (eq. 96)
    max_iters: int = 8          # primal-dual alternations
    consensus_rounds: int = 30  # J (Alg. 3)
    tol: float = 1e-4


def _load_jvp_decompositions() -> None:
    """``torch.func.jvp`` imports torch's jvp decompositions on its first
    call, and that import runs the deprecated ``torch.jit.script``.  Import
    them here once with that one warning silenced, so the solver itself
    raises no warning."""
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message=".torch.jit.script. is deprecated",
            category=DeprecationWarning)
        import torch._decomp.decompositions_for_jvp  # noqa: F401


def make_surrogate(spec: V.WSpec, hyper: PDHyper, ow: ObjectiveWeights,
                   consts_scalars, *, distributed: bool,
                   gamma_cap: float = 20.0):
    """The Algorithm-2 body for fixed (dims, hyper, ow).

    ``consts_scalars``: (L, zeta1, zeta2, F0_gap), the scalar MLConstants
    fields; the per-DPU theta_i / sigma_i arrays are arguments.

    Returns ``fn(w_l, Lambda, net, D_bar, theta_i, sigma_i, scale_flat,
    W_cons) -> (w_hat, Lambda', pd_iters, max_violation)`` on NORMALIZED
    flat vectors; every tensor argument lives on one device, and so do
    the results (``pd_iters`` a 0-dim int32 tensor).
    """
    from repro_torch.core.convergence import MLConstants  # local: avoids cycle
    _load_jvp_decompositions()
    L_s, zeta1_s, zeta2_s, f0_s = consts_scalars
    lam1, L_C, kappa = hyper.lambda1, hyper.L_C, hyper.kappa
    # C0 is spread over the FULL node count (the per-node decomposition of
    # eq. 84), in the centralized variant too, as in the reference
    N_d, B_d, S_d = spec.dims
    V_nodes = N_d + B_d + S_d

    def fn(w_l, Lambda, net, D_bar, theta_i, sigma_i, scale_flat, W_cons):
        dev = w_l.device
        cscale = K.constraint_scale(spec.dims, device=dev)
        consts = MLConstants(L=L_s, theta_i=theta_i, sigma_i=sigma_i,
                             zeta1=zeta1_s, zeta2=zeta2_s, F0_gap=f0_s)

        def phys(x):
            return spec.unflatten(x * scale_flat)

        def obj_flat(x):
            return objective(phys(x), net, D_bar, consts, ow)

        def con_flat(x):
            return K.constraint_vector(phys(x), net, D_bar) * cscale

        def proj_flat(x):
            return spec.flatten(
                V.project(phys(x), net, gamma_cap=gamma_cap)) / scale_flat

        def con_lin(t):
            return jvp(con_flat, (w_l,), (t,))[1]

        gJ = grad(obj_flat)(w_l)
        C0, con_vjp = vjp(con_flat, w_l)

        def candidate(lmb):
            """Closed-form minimizer of a node's surrogate Lagrangian (93):
            Lambda_d @ JC by one vjp."""
            denom = lam1 + L_C * torch.sum(lmb)
            g = gJ + con_vjp(lmb)[0]
            return proj_flat(w_l - g / denom)

        def pd_iteration(Lambda):
            if distributed:
                cands = vmap(candidate)(Lambda)                  # (V, P)
                w_hat = proj_flat(V.ownership_merge(cands, spec.dims))
                d = w_hat - w_l
                # per-node masked diffs, masks built inside the vmap;
                # squared norms by one index_add over the owner index
                lin = vmap(lambda v: con_lin(d * V.owner_mask(v, spec.dims)))(
                    torch.arange(V_nodes, device=dev))           # (V, nC)
                sq = 0.5 * L_C * V.node_sq_norms(d, spec.dims)
                ctilde = C0 / V_nodes + lin + sq[:, None]        # (84)-(85)
                new_L = Lambda + kappa * ctilde                  # (96)
                new_L = consensus_scan(new_L, W_cons,
                                       hyper.consensus_rounds)   # Alg. 3
            else:
                w_hat = candidate(Lambda[0])
                diff = w_hat - w_l
                ctilde = C0 / V_nodes + con_lin(diff) \
                    + 0.5 * L_C * torch.sum(diff * diff)
                new_L = Lambda + kappa * ctilde[None]            # (94)
            return w_hat, torch.clamp(new_L, min=0.0)

        # The reference's while-loop runs while it < max_iters and the
        # duals moved by >= tol.  Here all max_iters iterations run and
        # the carry freezes once that test fails: the same iterates and
        # the same count, with no host sync inside the loop (so the loop
        # is capturable as one CUDA graph), at the price of the frozen
        # iterations' arithmetic.
        Lambda = Lambda.to(torch.float32)
        w_hat = w_l
        iters = torch.zeros((), dtype=torch.int32, device=dev)
        delta = torch.full((), float("inf"), device=dev)
        for _ in range(hyper.max_iters):
            live = delta >= hyper.tol
            w_new, L_new = pd_iteration(Lambda)
            d_new = torch.max(torch.abs(L_new - Lambda))
            w_hat = torch.where(live, w_new, w_hat)
            Lambda = torch.where(live, L_new, Lambda)
            delta = torch.where(live, d_new, delta)
            iters = iters + live.to(torch.int32)
        return w_hat, Lambda, iters, torch.max(con_flat(w_hat))

    return fn
