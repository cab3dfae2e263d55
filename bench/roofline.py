"""Frozen operation and byte counts of the measured work, and the
published peaks they are held against.

Peaks: NVIDIA H100 SXM data sheet, dense rates: 67 TFLOP/s in float32
outside the tensor cores (the configurations run float32 with TF32 off),
3.35 TB/s of HBM.  Each kernel's bytes count every input read once and
every output written once, at the launch's recorded shape.
"""
from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
LANE = 1024


def fedprox_accum_bytes(G: int, R: int, anchor_stacked: bool,
                        elem_bytes: int = 4) -> float:
    """x, g, acc read and x, acc written per DPU; the anchor read once
    per DPU when stacked, once in all when shared.  (The (G,) coef and
    active vectors are below a rounding of this.)"""
    planes = 5 * G + (G if anchor_stacked else 1)
    return float(elem_bytes * R * LANE * planes)


def nova_aggregate_bytes(n: int, R: int, replicas: int,
                         elem_bytes: int = 4) -> float:
    """eq. 11: the n d_i planes and the x replicas read, the replicas
    written: ``4·R·1024·(n+2)`` for one plane, ``12·n·R·1024`` for an n
    replica stack."""
    return float(elem_bytes * R * LANE * (n + 2 * replicas))


def bound_seconds(nbytes: float, flops: float = 0.0) -> float:
    """The least time the chip could take: bytes over bandwidth or
    operations over the float32 peak, whichever is larger."""
    return max(nbytes / PEAK_HBM_BYTES, flops / PEAK_F32_FLOPS)


def launch_bound_seconds(launch: dict) -> float:
    """The bound of one recorded launch of a hand-written kernel."""
    if launch["kernel"] == "fedprox_accum":
        return bound_seconds(fedprox_accum_bytes(
            launch["G"], launch["R"], launch["anchor_stacked"],
            launch["elem_bytes"]))
    return bound_seconds(nova_aggregate_bytes(
        launch["n"], launch["R"], launch["replicas"], launch["elem_bytes"]))


def mlp_train_flops(dims, examples: float) -> float:
    """Forward and backward of the MLP ``dims`` over ``examples``: 2 per
    multiply-add forward, twice that backward (input and weight
    gradients)."""
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return 6.0 * macs * examples


def mamba2_forward_flops_per_token(m: dict, seq: int) -> float:
    """The matmul operations of one token through the mamba2 LM forward,
    at the configuration's widths and SSD chunk: the in and out
    projections, the SSD's four chunk products (C·B^T, the intra-chunk
    product with x, the chunk states, the inter-chunk read-out), the tied
    LM head.  Elementwise work, the depthwise conv and the norms are not
    counted."""
    d, V, L = m["d_model"], m["vocab_size"], m["n_layer"]
    d_inner = m["expand"] * d
    H = d_inner // m["headdim"]
    P, N, G = m["headdim"], m["d_state"], m["ngroups"]
    Q = min(m["chunk_size"], seq)
    d_in = 2 * d_inner + 2 * G * N + H
    per_layer = 2 * d * d_in + 2 * d_inner * d       # in, out projections
    per_layer += 2 * Q * N * G                        # C·B^T (per token)
    per_layer += 2 * Q * H * P                        # scores · x
    per_layer += 2 * H * P * N                        # chunk states
    per_layer += 2 * H * P * N                        # C · h
    return float(L * per_layer + 2 * d * V)


def mamba2_train_flops(m: dict, seq: int, tokens: float) -> float:
    """Model operations of training on ``tokens``: three times the
    forward, no recompute counted."""
    return 3.0 * mamba2_forward_flops_per_token(m, seq) * tokens


def kernel_share(data, kernel: str, symbol: str):
    """A hand-written kernel's share of its roofline over the traced
    window, in %: the bound time of every recorded launch of wrapper
    ``kernel`` over the device time of the records named ``symbol``.
    None where the window holds none, or where the records are not all
    this wrapper's launches."""
    launches = [x for x in data.launches if x["kernel"] == kernel]
    records = data.kernel_records(symbol)
    if not launches or len(records) != len(launches):
        return None
    device_s = sum(e - s for _, s, e in records)
    return 100.0 * sum(launch_bound_seconds(x) for x in launches) / device_s
