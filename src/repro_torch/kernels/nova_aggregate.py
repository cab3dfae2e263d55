"""CUDA wrapper of the ``nova_aggregate`` kernel (``csrc/nova_aggregate.cu``),
the port of ``repro.kernels.nova_aggregate.nova_aggregate_2d``:

    x_new = x - theta_eta * sum_i w_i d_i      (w already normalized)

Its plain version, same signature, is :func:`nova_aggregate_ref` (defined
in ``ref.py``, re-exported here).  Dispatch between the two, by the
tensors' device, lives in ``ops.py``.
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
                                     ctypes.c_float, ctypes.c_void_p]
MAX_DPUS = 12288     # the weights sit in 48 KB of shared memory per block


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
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        fn = cuda.entry("nova_aggregate", _SYMBOL[x.dtype], _ARGTYPES)
        err = fn(x.data_ptr(), d_stack.data_ptr(), weights.data_ptr(),
                 out.data_ptr(), R * LANE, n, float(theta_eta),
                 torch.cuda.current_stream(x.device).cuda_stream)
    cuda.check("nova_aggregate", err)
    cuda.LAUNCHES["nova_aggregate"] += 1
    return out
