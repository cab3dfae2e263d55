"""CUDA wrapper of the ``fedprox_accum`` kernel (``csrc/fedprox_accum.cu``),
the port of ``repro.kernels.fedprox_update.fedprox_accum_2d``:

    x_new   = x - active * eta * (g + mu * (x - anchor))
    acc_new = acc + active * coef * g

Its plain version, same signature, is :func:`fedprox_accum_ref` (defined
in ``ref.py``, re-exported here).  Dispatch between the two, by the
tensors' device, lives in ``ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.plane import LANE
from repro_torch.kernels.ref import fedprox_accum_ref  # noqa: F401

_SYMBOL = {torch.float32: "fedprox_accum_f32",
           torch.bfloat16: "fedprox_accum_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int, ctypes.c_float,
                                     ctypes.c_float, ctypes.c_void_p]


def _check_plane(name: str, t: torch.Tensor, device, dtype) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (materialise "
                         "broadcast views first)")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def fedprox_accum(x, g, anchor, acc, coef, active, eta, mu):
    """Launch the kernel on CUDA tensors.  x, g, acc: (G, R, 1024), f32 or
    bf16, one dtype; anchor: (R, 1024) or (G, R, 1024) of that dtype;
    coef, active: (G,) f32; eta, mu: Python numbers.  Returns
    (x_new, acc_new)."""
    if x.device.type != "cuda":
        raise ValueError(f"fedprox_accum launches on CUDA tensors; x is on "
                         f"{x.device} (CPU tensors take fedprox_accum_ref)")
    if x.dtype not in _SYMBOL:
        raise TypeError(f"fedprox_accum takes float32 or bfloat16, "
                        f"not {x.dtype}")
    if x.dim() != 3 or x.shape[2] != LANE or x.shape[1] % 8:
        raise ValueError(f"x must be (G, R, {LANE}) with R % 8 == 0, "
                         f"got {tuple(x.shape)}")
    G, R, _ = x.shape
    if tuple(g.shape) != tuple(x.shape) or tuple(acc.shape) != tuple(x.shape):
        raise ValueError("g and acc must have x's shape")
    if tuple(anchor.shape) not in ((R, LANE), (G, R, LANE)):
        raise ValueError(f"anchor must be ({R}, {LANE}) or ({G}, {R}, "
                         f"{LANE}), got {tuple(anchor.shape)}")
    for name, t in (("x", x), ("g", g), ("anchor", anchor), ("acc", acc)):
        _check_plane(name, t, x.device, x.dtype)
    for name, t in (("coef", coef), ("active", active)):
        _check_plane(name, t, x.device, torch.float32)
        if tuple(t.shape) != (G,):
            raise ValueError(f"{name} must be ({G},), got {tuple(t.shape)}")
    x_out = torch.empty_like(x)
    acc_out = torch.empty_like(acc)
    with torch.cuda.device(x.device):
        fn = cuda.entry("fedprox_accum", _SYMBOL[x.dtype], _ARGTYPES)
        err = fn(x.data_ptr(), g.data_ptr(), anchor.data_ptr(),
                 acc.data_ptr(), coef.data_ptr(), active.data_ptr(),
                 x_out.data_ptr(), acc_out.data_ptr(), x.numel(), R * LANE,
                 int(anchor.dim() == 3), float(eta), float(mu),
                 torch.cuda.current_stream(x.device).cuda_stream)
    cuda.check("fedprox_accum", err)
    cuda.LAUNCHES["fedprox_accum"] += 1
    return x_out, acc_out
