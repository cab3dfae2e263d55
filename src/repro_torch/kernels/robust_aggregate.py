"""CUDA wrapper of the ``robust_aggregate`` kernel
(``csrc/robust_aggregate.cu``), the port of
``repro.kernels.robust_aggregate.robust_aggregate_2d``:

    x_new = x - theta_eta * reduce(d_stack)

with ``reduce`` the coordinate-wise k-trimmed mean or median over the DPU
axis (unweighted).  Its plain version, same signature, is
:func:`robust_aggregate_ref` (defined in ``ref.py``, re-exported here).
Dispatch between the two, by the tensors' device, lives in ``ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.fedprox_update import _check_plane
from repro_torch.kernels.plane import LANE
from repro_torch.kernels.ref import robust_aggregate_ref  # noqa: F401

_SYMBOL = {torch.float32: "robust_aggregate_f32",
           torch.bfloat16: "robust_aggregate_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]
NMAX = (8, 16, 32, 64)   # the register network's compile-time sizes
# Stacks of up to NETWORK_MAX DPUs take the register network, larger ones
# the radix select: the crossover measured on the card (PERF.md)
NETWORK_MAX = 64


def sorted_range(n: int, k: int, median: bool):
    """The sorted positions [lo, hi) the reduce averages: the middle one
    (odd n) or two (even n) for the median, [k, n - k) for the k-trimmed
    mean."""
    if median:
        return (n // 2, n // 2 + 1) if n % 2 else (n // 2 - 1, n // 2 + 1)
    if not 0 <= 2 * k < n:
        raise ValueError(f"trim k={k} needs 0 <= 2k < n={n}")
    return k, n - k


def robust_aggregate(x, d_stack, theta_eta, *, k: int = 0,
                     median: bool = False):
    """Launch the kernel on CUDA tensors.  x: (R, 1024), f32 or bf16;
    d_stack: (n, R, 1024) of x's dtype, n >= 1; ``k`` (trimmed mean) and
    ``median`` as in :func:`robust_aggregate_ref`; theta_eta: a Python
    number.  Stacks of up to NETWORK_MAX DPUs take the register network,
    larger ones the radix select.  Returns x_new."""
    return _launch(x, d_stack, theta_eta, k, median, NETWORK_MAX)


def _launch(x, d_stack, theta_eta, k: int, median: bool, network_max: int):
    """:func:`robust_aggregate` with the hand-over point as an argument:
    stacks of more than ``network_max`` DPUs (at most 64) take the radix
    select.  The crossover measurement times both at n <= 64 through it."""
    if x.dtype not in _SYMBOL:
        raise TypeError(f"robust_aggregate takes float32 or bfloat16, "
                        f"not {x.dtype}")
    if x.dim() != 2 or x.shape[1] != LANE or x.shape[0] % 8:
        raise ValueError(f"x must be (R, {LANE}) with R % 8 == 0, "
                         f"got {tuple(x.shape)}")
    R = x.shape[0]
    if d_stack.dim() != 3 or tuple(d_stack.shape[1:]) != (R, LANE):
        raise ValueError(f"d_stack must be (n, {R}, {LANE}), "
                         f"got {tuple(d_stack.shape)}")
    n = d_stack.shape[0]
    if n < 1:
        raise ValueError("d_stack holds no DPU")
    lo, hi = sorted_range(n, k, median)
    _check_plane("x", x, x.device, x.dtype)
    _check_plane("d_stack", d_stack, x.device, x.dtype)
    if x.device.type != "cuda":
        raise ValueError(f"robust_aggregate launches on CUDA tensors; x is "
                         f"on {x.device} (CPU tensors take "
                         "robust_aggregate_ref)")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        fn = cuda.entry("robust_aggregate", _SYMBOL[x.dtype], _ARGTYPES)
        err = fn(x.data_ptr(), d_stack.data_ptr(), out.data_ptr(),
                 R * LANE, n, lo, hi, float(theta_eta), int(network_max),
                 torch.cuda.current_stream(x.device).cuda_stream)
    cuda.check("robust_aggregate", err)
    cuda.LAUNCHES["robust_aggregate"] += 1
    return out
