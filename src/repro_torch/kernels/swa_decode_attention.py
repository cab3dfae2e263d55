"""CUDA wrapper of the ``swa_decode_attention`` kernel
(``csrc/swa_decode_attention.cu``), the port of
``repro.kernels.swa_decode_attention.swa_decode_attention``: single-token
GQA decode attention of q (B, Hq, D) over the positions < cache_len of a
(B, S, Hkv, D) KV cache, read in place.

Its plain version, same signature, is :func:`swa_decode_attention_ref`
(defined in ``ref.py``, re-exported here).  Dispatch between the two, by
the tensors' device, lives in ``ops.py``.
"""
from __future__ import annotations

import ctypes
import operator

import numpy as np
import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ref import swa_decode_attention_ref  # noqa: F401

_SYMBOL = {torch.float32: "swa_decode_attention_f32",
           torch.bfloat16: "swa_decode_attention_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float,
                                                          ctypes.c_void_p]
HEAD_DIMS = (32, 64, 128)
G_MAX = 16          # query heads per KV head the kernel holds
TILE = 64           # rows per tile of the bf16 kernel (two of the f32's)
GROUP = 8           # partials the kernel merges at once
MAX_SPLITS = GROUP * GROUP   # two levels of merges
BLOCKS_PER_SM = 3   # resident blocks per SM: the splits fill one wave

# (device index, stream) -> the tickets of calls on that stream: the
# kernel leaves them at zero, calls on one stream run one after the
# other, and calls on two streams never share them
_TICKETS = {}


def split_rows(cells: int, cache_len: int, sms: int):
    """(rows_per_split, n_split): the valid rows of each of the ``cells``
    (b, kv-head) cells cut into n_split <= MAX_SPLITS ranges of
    rows_per_split (a multiple of the kernel's tile, the last range
    shorter), as many as fit one wave of BLOCKS_PER_SM blocks on each of
    the ``sms`` SMs (a block waiting for a second wave would hold up its
    cell's merge), and at most GROUP (one merge) once GROUP per cell
    already give every SM a block."""
    tiles = -(-cache_len // TILE)
    want = min(MAX_SPLITS, max(1, BLOCKS_PER_SM * sms // cells))
    if cells * GROUP >= sms:
        want = min(want, GROUP)
    per = -(-tiles // want)                       # tiles per split
    return per * TILE, -(-tiles // per)


def scratch_floats(cells: int, n_split: int, G: int, D: int) -> int:
    """Floats of the kernel's scratch: a partial (m, l, acc) per split and,
    with more than one group of splits, per group."""
    groups = -(-n_split // GROUP)
    return cells * (n_split + (groups if groups > 1 else 0)) * G * (D + 2)


def _tickets(device, stream, cells: int):
    """A cell's ticket and its groups' (1 + GROUP per cell), zero."""
    key = (device.index, stream.cuda_stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < cells * (1 + GROUP):
        with torch.cuda.stream(stream):
            t = torch.zeros(max(cells, 64) * (1 + GROUP), dtype=torch.int32,
                            device=device)
        _TICKETS[key] = t
    return t


def _check(q, k_cache, v_cache, cache_len):
    if q.dtype not in _SYMBOL:
        raise TypeError(f"swa_decode_attention takes float32 or bfloat16, "
                        f"not {q.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"q must be (B, Hq, D) and the caches (B, S, Hkv, "
                         f"D); got {tuple(q.shape)}, {tuple(k_cache.shape)}")
    B, Hq, D = q.shape
    _, S, Hkv, Dk = k_cache.shape
    if tuple(v_cache.shape) != tuple(k_cache.shape) or k_cache.shape[0] != B \
            or Dk != D:
        raise ValueError(f"cache shapes {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {HEAD_DIMS}, got {D}")
    if Hq % Hkv or not 1 <= Hq // Hkv <= G_MAX:
        raise ValueError(f"Hq = {Hq} must be G * Hkv with Hkv = {Hkv} and "
                         f"1 <= G <= {G_MAX}")
    tensors = (("q", q), ("k_cache", k_cache), ("v_cache", v_cache))
    for name, t in tensors:
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; q is "
                             f"{q.dtype} on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    cache_len = operator.index(cache_len)
    if not 1 <= cache_len <= S:
        raise ValueError(f"cache_len must be in [1, {S}], got {cache_len}")
    if q.device.type != "cuda":
        raise ValueError(f"swa_decode_attention launches on CUDA tensors; "
                         f"q is on {q.device} (CPU tensors take "
                         "swa_decode_attention_ref)")
    for name, t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    return B, Hq, D, S, Hkv, cache_len


def swa_decode_attention(q, k_cache, v_cache, cache_len):
    """Launch the kernel on CUDA tensors.  q: (B, Hq, D); k_cache,
    v_cache: (B, S, Hkv, D), q's dtype (float32 or bfloat16), all
    contiguous; D in {32, 64, 128}; Hq = G * Hkv with G <= 16; cache_len:
    an int in [1, S].  Returns (B, Hq, D) in q's dtype."""
    B, Hq, D, S, Hkv, cache_len = _check(q, k_cache, v_cache, cache_len)
    G = Hq // Hkv
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    rows, n_split = split_rows(B * Hkv, cache_len, sms)
    out = torch.empty_like(q)
    scratch = torch.empty(scratch_floats(B * Hkv, n_split, G, D),
                          dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device)
    tickets = _tickets(q.device, stream, B * Hkv)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(D)))
    with torch.cuda.device(q.device):
        fn = cuda.entry("swa_decode_attention", _SYMBOL[q.dtype], _ARGTYPES)
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 out.data_ptr(), scratch.data_ptr(), tickets.data_ptr(), B,
                 S, Hkv, G, D, cache_len, rows, n_split, scale,
                 stream.cuda_stream)
    cuda.check("swa_decode_attention", err)
    cuda.LAUNCHES["swa_decode_attention"] += 1
    return out
