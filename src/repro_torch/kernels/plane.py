"""Flat parameter-plane representation: the layout the CUDA kernels run on.

The PyTorch counterpart of ``repro.kernels.plane`` with the same layout, so
that planes from the two packages compare element by element:

* ``LANE = 1024`` is the fixed last dimension.
* ``R`` is the element count rounded up to whole lanes, then to a multiple
  of ``SUBLANE = 8`` rows, or of 128 rows above 256 rows.
* Planes are float32 masters; ``unflatten`` casts back to the leaf dtypes.
* A leading batch axis is allowed: ``(G, R, LANE)`` holds one plane per DPU
  of a group.

Parameter trees are (possibly nested) dicts of tensors.  Their leaves are
ordered by sorted key, recursively, which is the leaf order
``jax.tree_util`` gives a dict, so offsets agree with the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Tuple

import numpy as np
import torch

from repro_torch.device import require_device

LANE = 1024      # last-dim width of every plane
SUBLANE = 8      # every plane has R % 8 == 0


def _row_count(n: int) -> int:
    """Rows needed for n elements, padded to a SUBLANE multiple (>= 8);
    above 256 rows, padded to a multiple of 128 rows."""
    r = max(1, -(-n // LANE))
    if r > 256:
        return -(-r // 128) * 128
    return -(-r // SUBLANE) * SUBLANE


# -- dict trees ---------------------------------------------------------

def tree_paths(tree, prefix: Tuple[str, ...] = ()) -> list:
    """(key path, leaf) pairs in sorted-key order, recursively."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_paths(tree[k], prefix + (k,)))
        return out
    return [(prefix, tree)]


def tree_from_paths(paths, leaves) -> dict:
    """Inverse of :func:`tree_paths` for dict trees."""
    root: dict = {}
    for path, leaf in zip(paths, leaves):
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root


def tree_map(fn: Callable, tree):
    """Apply ``fn`` to every leaf of a dict tree."""
    pairs = tree_paths(tree)
    return tree_from_paths([p for p, _ in pairs], [fn(x) for _, x in pairs])


def tree_unbind(tree) -> list:
    """A dict tree whose leaves share a leading axis of length n as the n
    trees of its slices (views, one ``unbind`` per leaf)."""
    pairs = tree_paths(tree)
    paths = [p for p, _ in pairs]
    cols = [x.unbind(0) for _, x in pairs]
    return [tree_from_paths(paths, [c[i] for c in cols])
            for i in range(len(cols[0]))]


# -- the spec -------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FlatSpec:
    """Static description of a dict tree's flat layout (hashable)."""
    paths: Tuple[Tuple[str, ...], ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]     # start element of each leaf in the plane
    n: int                       # total real elements
    rows: int                    # padded row count (R)

    def _sizes(self):
        return [math.prod(s) for s in self.shapes]

    def flatten(self, tree) -> torch.Tensor:
        """Dict tree -> (R, LANE) f32 plane (zero padding past ``n``), on
        the leaves' device."""
        pairs = tree_paths(tree)
        if tuple(p for p, _ in pairs) != self.paths:
            raise ValueError("the tree's leaves do not match the spec's")
        leaves = [x for _, x in pairs]
        flat = torch.zeros(self.rows * LANE, dtype=torch.float32,
                           device=leaves[0].device)
        for x, off, k in zip(leaves, self.offsets, self._sizes()):
            flat[off:off + k] = x.reshape(-1).to(torch.float32)
        return flat.view(self.rows, LANE)

    def unflatten(self, plane: torch.Tensor) -> dict:
        """(R, LANE) plane -> dict tree of views (differentiable)."""
        flat = plane.reshape(-1)
        leaves = [flat[off:off + k].view(shape).to(dtype)
                  for shape, dtype, off, k in zip(
                      self.shapes, self.dtypes, self.offsets, self._sizes())]
        return tree_from_paths(self.paths, leaves)

    def unflatten_batched(self, planes: torch.Tensor) -> dict:
        """(G, R, LANE) -> dict tree whose leaves carry the leading G axis
        (views).

        Under autograd the views write the stack's gradient once: each
        leaf's gradient goes into its own slice of one plane as the
        backward produces it, and only what no gradient reached (a leaf
        the loss does not use, the padding past ``n``) is zeroed.  Plain
        slices would each hand back a whole zero-filled plane for autograd
        to sum: a fill and an add of the plane per leaf."""
        cuts = list(zip(self.offsets, self._sizes(), self.shapes))
        G = planes.shape[0]
        if torch.is_grad_enabled() and planes.requires_grad:
            grad = _PlaneGrad(self.n, cuts, tuple(planes.shape))
            flat = _Alias.apply(planes, grad)
            leaves = [_LeafView.apply(flat, grad, i)
                      for i in range(len(cuts))]
        else:
            flat = planes.reshape(G, -1)
            leaves = [flat.narrow(1, off, k).view((G,) + shape)
                      for off, k, shape in cuts]
        return tree_from_paths(self.paths, [
            x.to(dtype) for x, dtype in zip(leaves, self.dtypes)])


# -- the gradient plane of the leaf views -----------------------------------

_grad_plane_bytes = 0


def grad_plane_bytes() -> int:
    """Bytes the backward passes of :meth:`FlatSpec.unflatten_batched`'s
    views have written into gradient planes since import: one plane a
    backward.  Autograd's thread adds to it; read it on the host after
    ``torch.autograd.grad`` returns."""
    return _grad_plane_bytes


class _PlaneGrad:
    """One backward's gradient plane, written leaf by leaf.  Each leaf's
    gradient is stored as ``g + 0.0``, the value the sum of zero-filled
    planes gives it (that sum turns -0.0 into +0.0).  The plane is not
    differentiable: under ``create_graph`` the ``out=`` write refuses a
    gradient that requires grad."""

    def __init__(self, n: int, cuts: list, shape: tuple):
        self.n, self.cuts, self.shape = n, cuts, shape
        self.cols = None          # the plane as (G, R * LANE) while written
        self.dsts: tuple = ()     # its slices, one a leaf, then the padding
        self.written: set = set()

    def write(self, i: int, g: torch.Tensor) -> None:
        if self.cols is None:
            self.cols = g.new_empty(self.shape).view(self.shape[0], -1)
            self.dsts = self.cols.split([k for _, k, _ in self.cuts]
                                        + [self.cols.shape[1] - self.n], 1)
        torch.add(g, 0.0, out=self.dsts[i].view(g.shape))
        self.written.add(i)

    def finish(self) -> torch.Tensor:
        """The plane, with the slices no leaf wrote zeroed.  Hands it
        over, so that the next backward starts afresh."""
        global _grad_plane_bytes
        cols, dsts, written = self.cols, self.dsts, self.written
        self.cols, self.dsts, self.written = None, (), set()
        if cols is None:
            return None
        for i, dst in enumerate(dsts):          # the last is the padding
            if i not in written:
                dst.zero_()
        _grad_plane_bytes += cols.numel() * cols.element_size()
        return cols.view(self.shape)


class _Alias(torch.autograd.Function):
    """planes -> their ``(G, R * LANE)`` view: the node every leaf view's
    backward feeds, whose backward returns the plane they wrote."""

    @staticmethod
    def forward(ctx, planes, grad):
        ctx.set_materialize_grads(False)
        ctx.grad = grad
        return planes.reshape(planes.shape[0], -1)

    @staticmethod
    def backward(ctx, _):
        # the leaf views pass nothing on: their gradients are in the plane
        return ctx.grad.finish(), None


class _LeafView(torch.autograd.Function):
    """Leaf ``i`` as a view of the ``(G, R * LANE)`` stack; its backward
    writes the leaf's gradient into its slice of the gradient plane and
    passes nothing on (the stack's gradient leaves through
    :class:`_Alias`)."""

    @staticmethod
    def forward(ctx, flat, grad, i):
        ctx.set_materialize_grads(False)
        ctx.grad, ctx.i = grad, i
        off, k, shape = grad.cuts[i]
        return flat.narrow(1, off, k).view((flat.shape[0],) + shape)

    @staticmethod
    def backward(ctx, g):
        if g is not None:
            ctx.grad.write(ctx.i, g)
        return None, None, None


def spec_of(tree) -> FlatSpec:
    """The FlatSpec of a dict tree of tensors."""
    pairs = tree_paths(tree)
    shapes = tuple(tuple(x.shape) for _, x in pairs)
    sizes = [int(np.prod(s)) if s else 1 for s in shapes]
    offsets = tuple(int(o) for o in np.cumsum([0] + sizes[:-1]))
    n = int(sum(sizes))
    return FlatSpec(paths=tuple(p for p, _ in pairs), shapes=shapes,
                    dtypes=tuple(x.dtype for _, x in pairs),
                    offsets=offsets, n=n, rows=_row_count(n))


@dataclasses.dataclass
class ParamPlane:
    """A tree's parameters as a flat plane: ``data`` is ``(R, LANE)`` f32
    (or ``(G, R, LANE)`` with a leading batch axis), ``spec`` the layout."""
    data: torch.Tensor
    spec: FlatSpec

    @classmethod
    def from_tree(cls, tree) -> "ParamPlane":
        if isinstance(tree, ParamPlane):
            return tree
        spec = spec_of(tree)
        return cls(data=spec.flatten(tree), spec=spec)

    @classmethod
    def from_numpy(cls, tree, device="cuda") -> "ParamPlane":
        """Plane of a dict tree of numpy arrays, on ``device`` (the arrays
        are copied, so read-only inputs are fine)."""
        dev = require_device(device)
        return cls.from_tree(tree_map(
            lambda a: torch.from_numpy(np.array(a)).to(dev), tree))

    def to_tree(self) -> dict:
        if self.data.dim() == 2:
            return self.spec.unflatten(self.data)
        return self.spec.unflatten_batched(self.data)

    @property
    def batched(self) -> bool:
        return self.data.dim() == 3

    def with_data(self, data) -> "ParamPlane":
        return ParamPlane(data=data, spec=self.spec)

    def broadcast(self, g: int) -> "ParamPlane":
        """(R, LANE) -> (g, R, LANE) stride-0 view: materialise it
        (``.contiguous()``) before handing it to a kernel."""
        assert self.data.dim() == 2
        return ParamPlane(data=self.data.unsqueeze(0).expand(
            (g,) + tuple(self.data.shape)), spec=self.spec)


def as_plane(params) -> ParamPlane:
    """Coerce a dict tree or ParamPlane to a ParamPlane."""
    return ParamPlane.from_tree(params)


def as_tree(params) -> Any:
    """Coerce a ParamPlane or dict tree to a dict tree."""
    return params.to_tree() if isinstance(params, ParamPlane) else params
