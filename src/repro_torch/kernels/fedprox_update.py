"""CUDA wrappers of the FedProx kernels, the ports of
``repro.kernels.fedprox_update``:

* ``fedprox_accum`` (``csrc/fedprox_accum.cu``, from ``fedprox_accum_2d``):

      x_new   = x - active * eta * (g + mu * (x - anchor))
      acc_new = acc + active * coef * g

* ``fedprox_update`` (``csrc/fedprox_update.cu``, from
  ``fedprox_update_2d``):

      x_new = x - eta * (g + mu * (x - anchor))

Their plain versions, same signatures, are :func:`fedprox_accum_ref` and
:func:`fedprox_update_ref` (defined in ``ref.py``, re-exported here).
Dispatch between kernel and plain version, by the tensors' device, lives
in ``ops.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.plane import LANE
from repro_torch.kernels.ref import (fedprox_accum_ref,  # noqa: F401
                                     fedprox_update_ref)

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


_UPDATE_SYMBOL = {torch.float32: "fedprox_update_f32",
                  torch.bfloat16: "fedprox_update_bf16"}
_UPDATE_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64, ctypes.c_float,
                                            ctypes.c_float, ctypes.c_void_p]


def fedprox_update(x, g, anchor, eta, mu):
    """Launch the kernel on CUDA tensors.  x, g, anchor: (R, 1024), one
    dtype, f32 or bf16; eta, mu: Python numbers.  Returns x_new."""
    if x.dtype not in _UPDATE_SYMBOL:
        raise TypeError(f"fedprox_update takes float32 or bfloat16, "
                        f"not {x.dtype}")
    if x.dim() != 2 or x.shape[1] != LANE or x.shape[0] % 8:
        raise ValueError(f"x must be (R, {LANE}) with R % 8 == 0, "
                         f"got {tuple(x.shape)}")
    for name, t in (("x", x), ("g", g), ("anchor", anchor)):
        if tuple(t.shape) != tuple(x.shape):
            raise ValueError(f"{name} must have x's shape {tuple(x.shape)}, "
                             f"got {tuple(t.shape)}")
        _check_plane(name, t, x.device, x.dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fedprox_update launches on CUDA tensors; x is on "
                         f"{x.device} (CPU tensors take fedprox_update_ref)")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        fn = cuda.entry("fedprox_update", _UPDATE_SYMBOL[x.dtype],
                        _UPDATE_ARGTYPES)
        err = fn(x.data_ptr(), g.data_ptr(), anchor.data_ptr(),
                 out.data_ptr(), x.numel(), float(eta), float(mu),
                 torch.cuda.current_stream(x.device).cuda_stream)
    cuda.check("fedprox_update", err)
    cuda.LAUNCHES["fedprox_update"] += 1
    return out
