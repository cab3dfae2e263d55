"""The paper's FL workload model (Sec. VI / App. G): an MLP image classifier
on flattened pixels.  Counterpart of ``repro.models.classifier``.

Parameters are a dict ``{"w0", "b0", "w1", "b1", ...}`` of tensors.  Every
function also takes a *batched* dict whose leaves carry a leading DPU axis
G (``w_i: (G, din, dout)``), with inputs ``(G, B, ...)``: the forward pass
then runs as one ``torch.bmm`` per layer for the whole DPU group, and the
loss returns one value per DPU.  That batch axis is what ``jax.vmap``
gives the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.cefl_paper import ClassifierConfig
from repro_torch.device import require_device


def init_classifier_params(generator: torch.Generator, cfg: ClassifierConfig,
                           device="cuda"):
    """He-normal weights and zero biases, drawn from ``generator`` (whose
    device must be ``device``).  The draws differ from ``jax.random``'s;
    use :func:`params_from_numpy` to start from the JAX package's."""
    dev = require_device(device)
    dtype = getattr(torch, cfg.dtype)
    dims = [int(np.prod(cfg.input_shape))] + list(cfg.hidden) \
        + [cfg.num_classes]
    params = {}
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        w = torch.randn((din, dout), generator=generator, device=dev)
        params[f"w{i}"] = (w * float(np.sqrt(2.0 / din))).to(dtype)
        params[f"b{i}"] = torch.zeros((dout,), dtype=dtype, device=dev)
    return params


def params_from_numpy(tree, device="cuda"):
    """A dict of numpy arrays (e.g. the JAX package's initial params) as a
    dict of tensors on ``device``.  The arrays are copied, so read-only
    inputs are fine."""
    dev = require_device(device)
    return {k: torch.from_numpy(np.array(v)).to(dev) for k, v in tree.items()}


def classifier_logits(params, x):
    """x: (B, *input_shape) for (din, dout) weights, or (G, B,
    *input_shape) for (G, din, dout) weights (one model per DPU)."""
    batched = params["w0"].dim() == 3
    h = x.reshape(x.shape[0], x.shape[1], -1) if batched \
        else x.reshape(x.shape[0], -1)
    n = len(params) // 2
    for i in range(n):
        w, b = params[f"w{i}"], params[f"b{i}"]
        if batched:
            h = torch.bmm(h, w) + b.unsqueeze(1)
        else:
            h = h @ w + b
        if i < n - 1:
            h = torch.relu(h)
    return h


def classifier_loss(params, batch, example_weights=None):
    """Mean cross-entropy; ``example_weights``: (B,) or (G, B) 0/1
    mini-batch mask.  Returns a scalar, or (G,) for batched params."""
    logits = classifier_logits(params, batch["x"]).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["y"].long().unsqueeze(-1))[..., 0]
    nll = logz - gold
    if example_weights is not None:
        w = example_weights.float()
        return torch.sum(nll * w, dim=-1) / torch.clamp(
            torch.sum(w, dim=-1), min=1.0)
    return torch.mean(nll, dim=-1)


def classifier_accuracy(params, x, y):
    pred = torch.argmax(classifier_logits(params, x), dim=-1)
    return torch.mean((pred == y).float())
