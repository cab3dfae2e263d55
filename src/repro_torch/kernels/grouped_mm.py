"""Grouped matrix products over expert segments: the drop-free MoE's
expert products (``models/moe.dropless_forward``), forward and backward.

Rows arrive sorted by expert; ``offsets`` (E + 1,) int64 on the device
gives each expert's segment, ``offsets[e] .. offsets[e + 1]``, and rows
past ``offsets[E]`` (pairs no held expert takes) are left at zero.  The
segment sizes are never read on the host: the kernels find their tiles
from bounds they load themselves.

* :func:`grouped_mm` — ``out[r] = a[rows[r]] @ w[e]`` for each row r of
  segment e (``rows`` None: ``a[r]``), out (P, N).  Used for the forward
  products and for the input gradients (``w`` transposed).
* :func:`grouped_wgrad` — ``dw[e] = a[rows[seg e]]^T @ g[seg e]``, dw
  (E, K, N): the weight gradients.
* :class:`GroupedMM` ties them into autograd; with ``rows`` the input
  gradient comes back to a's rows through ``inv`` (each of a's rows' k
  pair positions), a gather and a sum in a fixed order, so it is
  deterministic.

On a CUDA tensor each launches its CUDA kernel (``csrc/grouped_mm.cu``:
float32 FMAs, no TF32, 128 x 128 register-tiled output tiles; built on
first use, never at import); on a CPU tensor its plain version, a loop
over the experts.  No TPU kernel is replaced: the JAX package's MoE is
capacity dispatch by dense one-hot products.  Bound on the H100: the
float32 FMA rate (67 TFLOP/s) at the cells' shapes, 2·P·K·N operations
against one read of the segment rows and the experts' weights.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import tracing
from repro_torch.kernels import cuda

# (span token, offsets) of each launch while tracing records: the
# launch's pair count (offsets[-1]) is read once after the round
# (``models.moe.flush_counts``) and set on its ``moe.grouped`` span
PENDING: list = []
# launches of each kernel, counted by the wrappers
LAUNCHES = {"grouped_mm": 0, "grouped_mm_wgrad": 0}

_MM_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
    + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
_WGRAD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 \
    + [ctypes.c_int64] * 2 + [ctypes.c_void_p]


def _check(a, w_or_g, offsets, rows):
    """The kernels take float32 operands and int64 indices, on one
    device; the plain version any one floating dtype."""
    if a.dtype != w_or_g.dtype or (a.is_cuda and a.dtype != torch.float32):
        raise TypeError(f"grouped products take float32 on the card, not "
                        f"{a.dtype} and {w_or_g.dtype}")
    if offsets.dtype != torch.int64 or offsets.dim() != 1:
        raise TypeError("offsets must be a 1-D int64 tensor")
    if rows is not None and (rows.dtype != torch.int64 or rows.dim() != 1):
        raise TypeError("rows must be a 1-D int64 tensor")
    tensors = [a, w_or_g, offsets] + ([rows] if rows is not None else [])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {devices}")


def _traced_launch(kind: str, offsets, **shape):
    """A ``moe.grouped`` span around one launch, its shape as attributes;
    its pair count is set after the round (:data:`PENDING`)."""
    token = tracing.begin("moe.grouped")
    if token is not None:
        tracing.annotate(token, "kind", kind)
        for k, v in shape.items():
            tracing.annotate(token, k, v)
        PENDING.append((token, offsets))
    return token


def _unit_last(t):
    """t with its last axis along memory (the kernels' only stride rule)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _segment(a, rows, s, t):
    return a[rows[s:t]] if rows is not None else a[s:t]


def grouped_mm_plain(a, w, o, rows=None):
    """The plain version of :func:`grouped_mm`, one product an expert,
    the segment bounds ``o`` a host list: the CPU's path, and on a card
    the yardstick ``chip_smoke.py`` times."""
    out = a.new_zeros((rows.numel() if rows is not None else a.shape[0],
                       w.shape[2]))
    for e in range(len(o) - 1):
        if o[e + 1] > o[e]:
            out[o[e]:o[e + 1]] = _segment(a, rows, o[e], o[e + 1]) @ w[e]
    return out


def grouped_wgrad_plain(a, g, o, rows=None):
    """The plain version of :func:`grouped_wgrad` (``o`` as in
    :func:`grouped_mm_plain`)."""
    dw = a.new_zeros((len(o) - 1, a.shape[1], g.shape[1]))
    for e in range(len(o) - 1):
        if o[e + 1] > o[e]:
            dw[e] = _segment(a, rows, o[e], o[e + 1]).T @ g[o[e]:o[e + 1]]
    return dw


def grouped_mm(a, w, offsets, rows=None, written=None):
    """out (P, N): row r of expert e's segment is ``a[rows[r]] @ w[e]``
    (``a[r]`` without ``rows``); rows past ``offsets[-1]`` are zero.
    a (T, K) f32; w (E, K, N) f32; offsets (E + 1,) int64; rows (P,)
    int64.  P is ``rows``' length, else a's rows.  ``written``: None, or
    an int64 scalar on a's device that gains the number of rows the
    product wrote (the kernel counts them itself)."""
    _check(a, w, offsets, rows)
    E, K, N = w.shape
    P = rows.numel() if rows is not None else a.shape[0]
    if a.shape[1] != K or offsets.numel() != E + 1:
        raise ValueError(f"shapes a {tuple(a.shape)}, w {tuple(w.shape)}, "
                         f"offsets {tuple(offsets.shape)} do not agree")
    if written is not None and (written.dtype != torch.int64
                                or written.numel() != 1
                                or written.device != a.device):
        raise TypeError("written must be one int64 element on a's device")
    if a.device.type == "cpu":
        o = offsets.tolist()
        if written is not None:
            written += o[-1] - o[0]
        return grouped_mm_plain(a, w, o, rows)
    out = a.new_zeros((P, N))
    a, w, offsets = _unit_last(a), _unit_last(w), offsets.contiguous()
    rows = rows.contiguous() if rows is not None else None
    token = _traced_launch("mm", offsets, experts=E, K=K, N=N, rows=P)
    with torch.cuda.device(a.device):
        fn = cuda.entry("grouped_mm", "grouped_mm_f32", _MM_ARGTYPES)
        err = fn(a.data_ptr(), rows.data_ptr() if rows is not None else None,
                 w.data_ptr(), out.data_ptr(), offsets.data_ptr(),
                 written.data_ptr() if written is not None else None,
                 E, K, N, P, a.stride(0), w.stride(0), w.stride(1),
                 torch.cuda.current_stream(a.device).cuda_stream)
    cuda.check("grouped_mm", err)
    LAUNCHES["grouped_mm"] += 1
    tracing.end(token)
    return out


def grouped_wgrad(a, g, offsets, rows=None):
    """dw (E, K, N): ``a[rows[seg e]]^T @ g[seg e]`` (``a[seg e]``
    without ``rows``), zeros for an empty segment.  a (T, K) f32; g (P,
    N) f32."""
    _check(a, g, offsets, rows)
    E = offsets.numel() - 1
    K, N = a.shape[1], g.shape[1]
    if a.device.type == "cpu":
        return grouped_wgrad_plain(a, g, offsets.tolist(), rows)
    a, g, offsets = _unit_last(a), _unit_last(g), offsets.contiguous()
    rows = rows.contiguous() if rows is not None else None
    dw = a.new_empty((E, K, N))
    token = _traced_launch("wgrad", offsets, experts=E, K=K, N=N,
                           rows=g.shape[0])
    with torch.cuda.device(a.device):
        fn = cuda.entry("grouped_mm", "grouped_wgrad_f32", _WGRAD_ARGTYPES)
        err = fn(a.data_ptr(), rows.data_ptr() if rows is not None else None,
                 g.data_ptr(), dw.data_ptr(), offsets.data_ptr(), E, K, N,
                 a.stride(0), g.stride(0),
                 torch.cuda.current_stream(a.device).cuda_stream)
    cuda.check("grouped_mm", err)
    LAUNCHES["grouped_mm_wgrad"] += 1
    tracing.end(token)
    return dw


class GroupedMM(torch.autograd.Function):
    """``grouped_mm`` under autograd.  With ``rows`` (P,) the product
    reads a's rows through it, and ``inv`` (T, k) gives, for each of a's
    T rows, the positions of its k pairs among the P: the input gradient
    is the sum of those k rows of the pair gradient, taken in the order
    of ``inv`` (rows no expert took are zero).  ``written`` counts the
    forward's rows (:func:`grouped_mm`)."""

    @staticmethod
    def forward(ctx, a, w, offsets, rows, inv, written):
        ctx.save_for_backward(a, w, offsets, rows, inv)
        return grouped_mm(a, w, offsets, rows, written)

    @staticmethod
    def backward(ctx, dout):
        a, w, offsets, rows, inv = ctx.saved_tensors
        dout = dout.contiguous()
        da = dw = None
        if ctx.needs_input_grad[0]:
            # w^T copied once: the kernel reads its N axis along memory
            dpairs = grouped_mm(dout, w.transpose(1, 2).contiguous(),
                                offsets)
            da = dpairs if rows is None else \
                dpairs[inv.reshape(-1)].view(inv.shape + (-1,)).sum(1)
        if ctx.needs_input_grad[1]:
            dw = grouped_wgrad(a, dout, offsets, rows)
        return da, dw, None, None, None, None


def grouped_matmul(a, w, offsets, rows=None, inv=None, written=None):
    """:func:`grouped_mm` with gradients to ``a`` and ``w``."""
    return GroupedMM.apply(a, w, offsets, rows, inv, written)
