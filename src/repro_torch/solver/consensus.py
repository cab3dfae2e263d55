"""Algorithm 3: iterative decentralized consensus on the dual variables over
the communication graph H (Sec. V), with Xiao-Boyd constant edge weights
W_dd' = z, W_dd = 1 - z * degree(d), z < 1 / max_degree.  Counterpart of
``repro.solver.consensus``.
"""
from __future__ import annotations

import numpy as np
import torch


def _normalize_adjacency(adjacency: np.ndarray) -> np.ndarray:
    """Undirected simple-graph view of an adjacency matrix: symmetrized
    (an edge in either direction counts) and self-loop free, so the
    Xiao-Boyd weights stay doubly stochastic."""
    A = (np.asarray(adjacency, dtype=np.float64) != 0).astype(np.float64)
    A = np.maximum(A, A.T)
    np.fill_diagonal(A, 0.0)
    return A


def consensus_weights(adjacency: np.ndarray, z_hat: float = 1e-3):
    """Doubly-stochastic weight matrix per the paper's construction."""
    A = _normalize_adjacency(adjacency)
    V = A.shape[0]
    deg = A.sum(axis=1)
    z = min(1.0 / V, 1.0 / (deg.max() + 1.0)) - z_hat
    z = max(z, 1e-6)
    W = z * A
    np.fill_diagonal(W, 1.0 - z * deg)
    return W


def consensus_rounds(values: np.ndarray, W: np.ndarray, J: int):
    """values: (V, ...) per-node copies; J averaging rounds (eq. 99)."""
    out = np.asarray(values, dtype=np.float64)
    flat = out.reshape(out.shape[0], -1)
    for _ in range(J):
        flat = W @ flat
    return flat.reshape(out.shape)


def consensus_scan(values: torch.Tensor, W: torch.Tensor, J: int):
    """:func:`consensus_rounds` on tensors: J successive products with the
    weight matrix (the JAX package's ``lax.scan``), never
    ``torch.linalg.matrix_power``, which rounds differently."""
    flat = values.reshape(values.shape[0], -1)
    for _ in range(J):
        flat = W @ flat
    return flat.reshape(values.shape)



def consensus_error(values) -> float:
    """Max deviation from the global average over nodes (diagnostic);
    ``values`` (V, ...) per-node copies, numpy or a tensor."""
    flat = torch.as_tensor(values)
    flat = flat.reshape(flat.shape[0], -1)
    return float((flat - flat.mean(dim=0, keepdim=True)).abs().max())
