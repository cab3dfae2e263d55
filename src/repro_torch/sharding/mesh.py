"""The ``('dpu', 'rows')`` process mesh of the sharded parameter plane, its
counted collectives, and a launcher for SPMD groups.

Counterpart of ``plane_mesh`` / ``plane_axes`` in ``repro.sharding.plane``:
a JAX ``Mesh`` of devices becomes a grid of ``torch.distributed`` ranks.
The mesh of shape ``(d, r)`` covers the first d*r ranks of the initialised
default group; rank ``i*r + j`` sits at coordinate ``(i, j)``.  Along
``'dpu'`` the ranks of one column form a sub-group, along ``'rows'`` the
ranks of one row.  A rank past d*r is outside the mesh: the sharded entry
points run their single-device op there, so every rank of the world ends
with the same result.

Backends.  The caller initialises the default group and picks its
backend: ``nccl`` when each rank owns a card, ``gloo`` when ranks share
one (NCCL refuses two ranks on one device; gloo takes CUDA tensors and
stages them through host memory).  Nothing here switches between them.

Collectives are counted in :data:`COLLECTIVES` by ``(kind, axis)``, where
they are issued and nowhere else, so a caller can hold a run to the
collective schedule the reference's jaxpr contracts state.  An axis of
size 1 issues none: its gather is the identity.
"""
from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from collections import Counter
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.kernels.plane import LANE
from repro_torch.sharding.specs import sanitize_spec

DPU_AXIS = "dpu"
ROW_AXIS = "rows"

COLLECTIVES: Counter = Counter()   # (kind, axis) -> calls issued


def reset_collectives() -> None:
    COLLECTIVES.clear()


def all_gather(x: torch.Tensor, group, *, dim: int, axis: str):
    """The members' ``x`` (equal shapes) concatenated along ``dim`` in
    member order: ``dist.all_gather``'s list form, which every backend
    takes for CUDA and CPU tensors."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    COLLECTIVES[("all_gather", axis)] += 1
    return torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, group, *, op: str, axis: str):
    """The members' ``x`` reduced elementwise (``op`` "sum" or "max"); a
    new tensor, ``x`` is left as it is."""
    out = x.clone()
    dist.all_reduce(out, op={"sum": dist.ReduceOp.SUM,
                             "max": dist.ReduceOp.MAX}[op], group=group)
    COLLECTIVES[("all_reduce", axis)] += 1
    return out


class PlaneMesh:
    """A ``(d, r)`` grid of ranks: this rank's coordinate (None outside
    the grid) and the sub-group it belongs to along each axis (None along
    an axis of size 1)."""

    def __init__(self, d: int, r: int, coord: Optional[Tuple[int, int]],
                 groups: dict):
        self.d, self.r = d, r
        self.coord = coord
        self._groups = groups

    @property
    def shape(self) -> dict:
        return {DPU_AXIS: self.d, ROW_AXIS: self.r}

    @property
    def member(self) -> bool:
        return self.coord is not None

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coord[0 if axis == DPU_AXIS else 1]

    def block(self, axis: Optional[str], n: int) -> slice:
        """This rank's block of a dim of length ``n`` split over ``axis``
        (the whole dim when ``axis`` is None)."""
        if axis is None:
            return slice(0, n)
        b = n // self.size(axis)
        i = self.index(axis)
        return slice(i * b, (i + 1) * b)

    def gather(self, x: torch.Tensor, axis: Optional[str], *, dim: int):
        """All-gather ``x`` over ``axis`` along ``dim`` (identity when the
        dim is not split: ``axis`` None or of size 1)."""
        if axis is None or self.size(axis) == 1:
            return x
        return all_gather(x, self._groups[axis], dim=dim, axis=axis)

    def all_reduce(self, x: torch.Tensor, axis: Optional[str], *,
                   op: str = "sum"):
        """All-reduce ``x`` over ``axis`` (identity when not split)."""
        if axis is None or self.size(axis) == 1:
            return x
        return all_reduce(x, self._groups[axis], op=op, axis=axis)


def mesh_dims(shape) -> Tuple[int, int]:
    """``shape`` as ``(d, r)``, checked against the default group: raises
    RuntimeError when no group is initialised and ValueError when d or r
    is < 1 or d*r exceeds the world.  ``None`` puts every rank on
    ``'dpu'``."""
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh_shape {shape} needs an initialised torch.distributed "
            "default group (torchrun, or init_process_group)")
    world = dist.get_world_size()
    if shape is None:
        shape = (world, 1)
    d, r = int(shape[0]), int(shape[1])
    if d < 1 or r < 1 or d * r > world:
        raise ValueError(f"mesh_shape {tuple(shape)} needs {d * r} ranks, "
                         f"the default group has {world}")
    return d, r


_MESHES: dict = {}     # (d, r) -> (default group, PlaneMesh)


def plane_mesh(shape=None) -> PlaneMesh:
    """The ``('dpu', 'rows')`` mesh of ``shape`` over the first d*r ranks
    of the default group, cached per shape (and per default group).
    Every rank of the default group must call it, in the same order:
    creating the sub-groups is collective."""
    d, r = mesh_dims(shape)
    world_group = dist.group.WORLD
    cached = _MESHES.get((d, r))
    if cached is not None and cached[0] is world_group:
        return cached[1]
    rank = dist.get_rank()
    coord = divmod(rank, r) if rank < d * r else None
    groups = {}
    if d > 1:
        for j in range(r):
            g = dist.new_group([i * r + j for i in range(d)])
            if coord is not None and coord[1] == j:
                groups[DPU_AXIS] = g
    if r > 1:
        for i in range(d):
            g = dist.new_group([i * r + j for j in range(r)])
            if coord is not None and coord[0] == i:
                groups[ROW_AXIS] = g
    mesh = PlaneMesh(d, r, coord, groups)
    _MESHES[(d, r)] = (world_group, mesh)
    return mesh


def plane_axes(mesh, n_lead: Optional[int], n_rows: int):
    """(dpu_axis or None, rows_axis or None) of an ``(n_lead, n_rows,
    LANE)`` stack (an ``(n_rows, LANE)`` plane when ``n_lead`` is None)
    after :func:`~repro_torch.sharding.specs.sanitize_spec`'s
    divisibility rule.  ``mesh`` is anything with a ``shape`` mapping of
    axis sizes."""
    spec = sanitize_spec((DPU_AXIS, ROW_AXIS, None),
                         (n_lead if n_lead is not None else 0, n_rows, LANE),
                         mesh.shape)
    return (spec[0] if n_lead is not None else None), spec[1]


# ----------------------------------------------------- SPMD launcher -----

def _rank_main(fn, rank, world_size, init_method, backend, device, args,
               out):
    """One spawned rank: join the group, run ``fn(device, *args)``, leave
    the group, and report ``(rank, error or None, result)``."""
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
            dev = torch.device("cuda", torch.cuda.current_device())
        else:
            torch.set_num_threads(1)     # the ranks share the host's cores
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
        try:
            result = fn(dev, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, None, result))
    except Exception:
        out.put((rank, traceback.format_exc(), None))


SPMD_TIMEOUT_S = 900.0     # a group's whole run, spawn to last result


def run_spmd(fn: Callable, world_size: int, *args, backend: str,
             device="cuda"):
    """Run ``fn(device, *args)`` on ``world_size`` spawned ranks of a new
    default group with ``backend`` ("gloo" or "nccl": the caller's
    choice) and return rank 0's result.

    ``fn`` must be importable (a module-level function of a package) and
    its arguments and result picklable.  The ranks meet through a
    ``file://`` store in a fresh temporary directory, so concurrent
    groups never race for a port.  On a CUDA ``device`` rank k uses card
    k mod the card count (all of them card 0 on a one-card machine).  A
    rank that raises or dies, or a group that outlives
    ``SPMD_TIMEOUT_S``, stops every rank, and the error is raised here
    with its traceback."""
    ctx = mp.get_context("spawn")
    results, errors = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        out = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, rank, world_size, init, backend,
                                   str(device), args, out))
                 for rank in range(world_size)]
        deadline = time.monotonic() + SPMD_TIMEOUT_S
        try:
            for p in procs:
                p.start()
            while len(results) + len(errors) < world_size and not errors:
                try:
                    rank, err, res = out.get(timeout=1.0)
                except queue.Empty:
                    dead = [(i, p.exitcode) for i, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    if dead:
                        errors.append(f"rank(s) exited without a result: "
                                      f"(rank, exit code) {dead}")
                    elif time.monotonic() > deadline:
                        errors.append(f"timed out after {SPMD_TIMEOUT_S} s "
                                      f"with "
                                      f"{sorted(results)} done")
                    continue
                if err is not None:
                    errors.append(f"rank {rank} raised:\n{err}")
                else:
                    results[rank] = res
        finally:
            for p in procs:
                if errors and p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
                    p.join()
            out.close()
    if errors:
        raise RuntimeError(f"SPMD group of {world_size} ({backend}, "
                           f"{device}) failed: " + "\n".join(errors))
    return results[0]
