"""CUDA wrappers of the eq.-11 kernel ``csrc/nova_aggregate.cu``, the port
of ``repro.kernels.nova_aggregate``:

    x_new = x - theta_eta * sum_i w_i d_i      (w already normalized)

* ``nova_aggregate`` (from ``nova_aggregate_2d``): x is one (R, 1024)
  plane; the kernel runs with one replica.
* ``nova_aggregate_stacked`` (from ``nova_aggregate_stacked_2d``): x is an
  (n, R, 1024) stack of per-DPU replicas, and every replica receives the
  same update; the kernel runs with n replicas.

Each wrapper keeps its own shape checks and launch counter.

Their plain version, same signature, is :func:`nova_aggregate_ref`
(defined in ``ref.py``, re-exported here; it broadcasts over a 3-D x).
Dispatch between kernel and plain version, by the tensors' device, lives
in ``ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.fedprox_update import _check_plane
from repro_torch.kernels.plane import LANE
from repro_torch.kernels.ref import nova_aggregate_ref  # noqa: F401

_SYMBOL = {torch.float32: "nova_aggregate_f32",
           torch.bfloat16: "nova_aggregate_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_float,
                                     ctypes.c_void_p]
MAX_DPUS = 12288     # the weights sit in 48 KB of shared memory per block


def _check_stack(x, d_stack, weights, n, R):
    if d_stack.dim() != 3 or tuple(d_stack.shape[1:]) != (R, LANE):
        raise ValueError(f"d_stack must be (n, {R}, {LANE}), "
                         f"got {tuple(d_stack.shape)}")
    if not 1 <= n <= MAX_DPUS:
        raise ValueError(f"nova_aggregate takes 1..{MAX_DPUS} DPUs, got {n}")
    _check_plane("x", x, x.device, x.dtype)
    _check_plane("d_stack", d_stack, x.device, x.dtype)
    _check_plane("weights", weights, x.device, torch.float32)
    if tuple(weights.shape) != (n,):
        raise ValueError(f"weights must be ({n},), got "
                         f"{tuple(weights.shape)}")


def _launch(x, d_stack, weights, theta_eta, n, replicas):
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        fn = cuda.entry("nova_aggregate", _SYMBOL[x.dtype], _ARGTYPES)
        err = fn(x.data_ptr(), d_stack.data_ptr(), weights.data_ptr(),
                 out.data_ptr(), x.shape[-2] * LANE, n, replicas,
                 float(theta_eta),
                 torch.cuda.current_stream(x.device).cuda_stream)
    cuda.check("nova_aggregate", err)
    return out


def nova_aggregate(x, d_stack, weights, theta_eta):
    """Launch the kernel on CUDA tensors.  x: (R, 1024), f32 or bf16;
    d_stack: (n, R, 1024) of x's dtype; weights: (n,) f32, normalized;
    theta_eta: a Python number.  Returns x_new."""
    if x.device.type != "cuda":
        raise ValueError(f"nova_aggregate launches on CUDA tensors; x is on "
                         f"{x.device} (CPU tensors take nova_aggregate_ref)")
    if x.dtype not in _SYMBOL:
        raise TypeError(f"nova_aggregate takes float32 or bfloat16, "
                        f"not {x.dtype}")
    if x.dim() != 2 or x.shape[1] != LANE or x.shape[0] % 8:
        raise ValueError(f"x must be (R, {LANE}) with R % 8 == 0, "
                         f"got {tuple(x.shape)}")
    R = x.shape[0]
    n = d_stack.shape[0] if d_stack.dim() == 3 else -1
    _check_stack(x, d_stack, weights, n, R)
    out = _launch(x, d_stack, weights, theta_eta, n, 1)
    cuda.LAUNCHES["nova_aggregate"] += 1
    return out


def nova_aggregate_stacked(x, d_stack, weights, theta_eta):
    """Launch the kernel on CUDA tensors.  x, d_stack: (n, R, 1024), f32 or
    bf16, one dtype; weights: (n,) f32, normalized; theta_eta: a Python
    number.  Returns the (n, R, 1024) stack of updated replicas."""
    if x.dtype not in _SYMBOL:
        raise TypeError(f"nova_aggregate_stacked takes float32 or bfloat16, "
                        f"not {x.dtype}")
    if x.dim() != 3 or x.shape[2] != LANE or x.shape[1] % 8:
        raise ValueError(f"x must be (n, R, {LANE}) with R % 8 == 0, "
                         f"got {tuple(x.shape)}")
    n, R, _ = x.shape
    if tuple(d_stack.shape) != tuple(x.shape):
        raise ValueError(f"d_stack must have x's shape {tuple(x.shape)}, "
                         f"got {tuple(d_stack.shape)}")
    _check_stack(x, d_stack, weights, n, R)
    if x.device.type != "cuda":
        raise ValueError(f"nova_aggregate_stacked launches on CUDA tensors; "
                         f"x is on {x.device} (CPU tensors take "
                         "nova_aggregate_ref)")
    out = _launch(x, d_stack, weights, theta_eta, n, n)
    cuda.LAUNCHES["nova_aggregate_stacked"] += 1
    return out
