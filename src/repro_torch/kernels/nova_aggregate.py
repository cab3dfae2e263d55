"""CUDA wrappers of the eq.-11 kernel ``csrc/nova_aggregate.cu``, the port
of ``repro.kernels.nova_aggregate``:

    x_new = x - theta_eta * sum_i w_i d_i      (w already normalized)

* ``nova_aggregate`` (from ``nova_aggregate_2d``): x is one (R, 1024)
  plane; the kernel runs with one replica.
* ``nova_aggregate_stacked`` (from ``nova_aggregate_stacked_2d``): x is an
  (n, R, 1024) stack of per-DPU replicas, and every replica receives the
  same update; the kernel runs with n replicas.

Each wrapper keeps its own shape checks and launch counter.  Both launch
the one kernel with the plan of :func:`launch_plan`: tile, ring stages,
blocks and shared-memory bytes, pure Python so that the CPU tests check
it at every path shape.

Their plain version, same signature, is :func:`nova_aggregate_ref`
(defined in ``ref.py``, re-exported here; it broadcasts over a 3-D x).
Dispatch between kernel and plain version, by the tensors' device, lives
in ``ops.py``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.fedprox_update import _check_plane
from repro_torch.kernels.plane import LANE
from repro_torch.kernels.ref import nova_aggregate_ref  # noqa: F401

_SYMBOL = {torch.float32: "nova_aggregate_f32",
           torch.bfloat16: "nova_aggregate_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 4
             + [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_float]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])

# The kernel's limits and the card's (Hopper: 227 KB of shared memory a
# block, 228 KB an SM of which the system keeps 1 KB a block).
KCHUNK = 4096                 # weights staged in shared memory at once
WARP = 32
SMEM_BLOCK = 232_448
SMEM_SM = 233_472
SMEM_RESERVED = 1024
THREADS_SM = 2048
BLOCKS_SM = 32
# Tiles the plan takes, largest first: a row of the plane, a half, a
# quarter.  Each is a whole number of consumer warps in either dtype.
TILE_ELEMS = (LANE, LANE // 2, LANE // 4)
# The plan's three choices, measured on the H100 against their neighbours
# (``chip_smoke.py`` phase 4, ``nova_plan_sweep``; PERF.md): the largest
# tile that gives every SM TILES_PER_SM tiles, up to BLOCKS_PER_SM blocks
# an SM, and rings that together hold IN_FLIGHT bytes of copies for every
# SM of the card.
TILES_PER_SM = 2
BLOCKS_PER_SM = 4
IN_FLIGHT = 32 << 10

_SMS = {}             # device index -> SM count, read once


class Plan(NamedTuple):
    tile_elems: int   # elements of a tile (one bulk copy)
    stages: int       # ring stages S
    blocks: int       # the persistent grid
    smem_bytes: int   # dynamic shared memory of a block
    threads: int      # consumers (one 16-byte vector each) + a producer warp


def _align128(b: int) -> int:
    return -(-b // 128) * 128


def smem_bytes(n: int, stages: int, tile_bytes: int) -> int:
    """Dynamic shared memory of a block, laid out as the kernel does: 2 x
    stages mbarriers, the weight chunk, then the ring."""
    weights = _align128(16 * stages)
    ring = _align128(weights + 4 * min(n, KCHUNK))
    return ring + stages * tile_bytes


def launch_plan(n: int, replicas: int, R: int, elem_bytes: int, sms: int,
                tile_elems: int = None, blocks_per_sm: int = BLOCKS_PER_SM,
                in_flight: int = IN_FLIGHT) -> Plan:
    """The launch of ``csrc/nova_aggregate.cu`` for n DPUs and ``replicas``
    planes of (R, 1024) elements of ``elem_bytes`` bytes on a card of
    ``sms`` SMs.  Tile: the largest of ``TILE_ELEMS`` that gives every SM
    ``TILES_PER_SM`` tiles (the smallest otherwise).  Blocks: one wave of
    at most ``blocks_per_sm`` an SM (fewer where shared memory or threads
    run out), at most one a tile.  Stages: the grid's rings hold
    ``in_flight`` bytes for every SM, at least one stage a block and at
    most the n + replicas copies of a tile.  ``tile_elems`` fixes the tile
    instead (the keywords serve measurements of the choices)."""
    plane = R * LANE
    if tile_elems is None:
        tile_elems = next((t for t in TILE_ELEMS
                           if plane // t >= TILES_PER_SM * sms),
                          TILE_ELEMS[-1])
    tile_bytes = tile_elems * elem_bytes
    tiles = plane // tile_elems
    threads = tile_elems * elem_bytes // 16 + WARP
    per_sm = min(blocks_per_sm, THREADS_SM // threads, BLOCKS_SM)
    blocks = max(1, min(tiles, sms * per_sm))
    stages = min(n + replicas,
                 max(1, in_flight * sms // (blocks * tile_bytes)))
    smem = smem_bytes(n, stages, tile_bytes)
    if smem > SMEM_BLOCK:
        raise ValueError(f"{stages} stages of {tile_bytes} bytes need {smem} "
                         f"bytes of shared memory, above {SMEM_BLOCK}")
    fit = SMEM_SM // (smem + SMEM_RESERVED)
    blocks = min(blocks, sms * fit)
    return Plan(tile_elems, stages, blocks, smem, threads)


def sm_count(device) -> int:
    """The SM count of a CUDA device, read once per device."""
    idx = torch.device(device).index
    if idx is None:
        idx = torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _check_stack(x, d_stack, weights, n, R):
    if d_stack.dim() != 3 or tuple(d_stack.shape[1:]) != (R, LANE):
        raise ValueError(f"d_stack must be (n, {R}, {LANE}), "
                         f"got {tuple(d_stack.shape)}")
    if n < 1:
        raise ValueError("d_stack holds no DPU")
    _check_plane("x", x, x.device, x.dtype)
    _check_plane("d_stack", d_stack, x.device, x.dtype)
    _check_plane("weights", weights, x.device, torch.float32)
    if tuple(weights.shape) != (n,):
        raise ValueError(f"weights must be ({n},), got "
                         f"{tuple(weights.shape)}")


def _launch(x, d_stack, weights, theta_eta, n, replicas, plan=None):
    """One launch, with ``launch_plan``'s plan unless ``plan`` is given (a
    measurement of another plan; it counts no launch)."""
    R = x.shape[-2]
    if plan is None:
        plan = launch_plan(n, replicas, R, x.element_size(),
                           sm_count(x.device))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        fn = cuda.entry("nova_aggregate", _SYMBOL[x.dtype], _ARGTYPES)
        err = fn(x.data_ptr(), d_stack.data_ptr(), weights.data_ptr(),
                 out.data_ptr(), R * LANE, n, replicas, float(theta_eta),
                 plan.tile_elems, plan.stages, plan.blocks, plan.smem_bytes,
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
