"""Plain reference of CE-FL training of a Mamba-2 language model
(arXiv:2405.21060): the forward pass and the mean next-token loss, its
gradient by autograd, FedProx local steps with the eq.-10 accumulation,
and the eq.-11 aggregation over the DPU replicas.

Plain PyTorch, float32.  It imports neither the program nor JAX.  The SSD
is the quadratic (masked attention) form over the whole sequence, with
the decay's segment sums taken by a masked cumulative sum, so it shares
no chunking with the program's chunked scan.  Norms scale by (1 + w), as
the program's layers are parameterised.  Rows go through in blocks, so a
large batch fits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1 + w)


def _segsum(a):
    """a (..., S) -> (..., S, S): sum of a[j+1..t] at [t, j] for t >= j,
    -inf above the diagonal."""
    S = a.shape[-1]
    x = a[..., None, :].expand(*a.shape, S).transpose(-1, -2)  # x[t, j]=a[t]
    x = x.masked_fill(~torch.tril(torch.ones(S, S, dtype=torch.bool,
                                             device=a.device), -1), 0)
    seg = torch.cumsum(x, dim=-2)
    return seg.masked_fill(~torch.tril(torch.ones(S, S, dtype=torch.bool,
                                                  device=a.device)),
                           -torch.inf)


def mixer(p: dict, h, m: dict):
    """One Mamba-2 mixer on normed inputs h (b, S, d)."""
    b, S, _ = h.shape
    d_inner = m["expand"] * m["d_model"]
    N, P = m["d_state"], m["headdim"]
    H = d_inner // P
    proj = h @ p["w_in"]
    z, xBC, dt = proj.split([d_inner, d_inner + 2 * N, H], dim=-1)
    W = p["conv_w"].shape[0]
    xBC = F.conv1d(xBC.transpose(1, 2), p["conv_w"].T.unsqueeze(1),
                   p["conv_b"], padding=W - 1, groups=xBC.shape[-1])
    xBC = F.silu(xBC[..., :S].transpose(1, 2))
    x, Bm, Cm = xBC.split([d_inner, N, N], dim=-1)
    x = x.reshape(b, S, H, P)
    dt = F.softplus(dt + p["dt_bias"])                         # (b, S, H)
    A = -torch.exp(p["a_log"])                                 # (H,)
    L = torch.exp(_segsum((dt * A).transpose(1, 2)))           # (b, H, S, S)
    M = (Cm @ Bm.transpose(1, 2))[:, None] * L \
        * dt.transpose(1, 2)[:, :, None, :]
    y = torch.einsum("bhtj,bjhp->bthp", M, x) + p["d_skip"][:, None] * x
    y = y.reshape(b, S, d_inner) * F.silu(z)
    return _rms(y, p["norm"], m["norm_eps"]) @ p["w_out"]


def nll_sum(params: dict, tokens, labels, m: dict):
    """Summed next-token negative log-likelihood of rows (b, S)."""
    x = params["embed"][tokens.long()]
    blk = params["blocks"]["layer_0"]
    for i in range(m["n_layer"]):
        mp = {k: v[i] for k, v in blk["mamba"].items()}
        x = x + mixer(mp, _rms(x, blk["ln1"][i], m["norm_eps"]), m)
    x = _rms(x, params["final_norm"], m["norm_eps"])
    logits = x @ params["embed"].T
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long(), reduction="sum")


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _rebuild(names, values):
    out = {}
    for n, v in zip(names, values):
        node = out
        *path, last = n.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def loss_and_grad(params: dict, tokens, labels, m: dict, rows: int):
    """Mean next-token loss over rows (b, S) and its gradient, the rows
    taken ``rows`` at a time."""
    names, values = zip(*_leaves(params))
    leaves = [v.detach().requires_grad_(True) for v in values]
    tree = _rebuild(names, leaves)
    total = float(tokens.numel())
    loss, grads = 0.0, [torch.zeros_like(v) for v in values]
    for r in range(0, tokens.shape[0], rows):
        with torch.enable_grad():
            part = nll_sum(tree, tokens[r:r + rows], labels[r:r + rows], m) \
                / total
            gs = torch.autograd.grad(part, leaves)
        loss += float(part.detach())
        grads = [a + g for a, g in zip(grads, gs)]
    return loss, _rebuild(names, grads)


def cefl_round(p0: dict, batch: dict, m: dict, *, gamma: int, eta: float,
               mu: float, rows: int, batch_keep: float = 1.0):
    """One CE-FL round over n DPUs (``batch`` leaves (n, 1, mb, S)): each
    DPU runs gamma proximal SGD steps from p0, accumulating a_l grad (eq.
    10), and eq. 11 with equal weights and theta = gamma (every DPU runs
    gamma steps) updates every replica alike.  Returns (the new model,
    the DPU mean of the last step's loss).  ``batch_keep`` < 1 keeps the
    leading share of each DPU's rows (a planted fault, for the tests)."""
    names, base = zip(*_leaves(p0))
    n = batch["tokens"].shape[0]
    r = 1.0 - eta * mu
    a = [r ** (gamma - 1 - k) for k in range(gamma)]
    agg = [torch.zeros_like(v) for v in base]
    last = []
    for i in range(n):
        tok, lab = batch["tokens"][i, 0], batch["labels"][i, 0]
        keep = max(1, int(tok.shape[0] * batch_keep))
        tok, lab = tok[:keep], lab[:keep]
        p = list(base)
        acc = [torch.zeros_like(v) for v in base]
        for k in range(gamma):
            loss, g = loss_and_grad(_rebuild(names, p), tok, lab, m, rows)
            g = [x for _, x in _leaves(g)]
            acc = [c + a[k] * x for c, x in zip(acc, g)]
            p = [v - eta * (x + mu * (v - b0))
                 for v, x, b0 in zip(p, g, base)]
        last.append(loss)
        agg = [s + c / (sum(a) * n) for s, c in zip(agg, acc)]
    new = [b0 - gamma * eta * s for b0, s in zip(base, agg)]
    return _rebuild(names, new), sum(last) / n
