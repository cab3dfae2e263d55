"""Checkpointing: tensors through ``torch.save`` with a JSON manifest.
Counterpart of ``repro.training.checkpoint`` in a torch-native format.

``save_checkpoint`` flattens a nested dict / list / tuple tree whose leaves
are tensors or numpy arrays into a tensors file (a flat ``{"leaf_i":
tensor}`` dict, every tensor on the CPU) plus a ``manifest.json`` (the
structure as a string, per-leaf shapes / dtypes / kinds, the step and the
caller's metadata).  ``load_checkpoint`` restores into the *structure* of
a caller ``like_tree`` and validates it against the manifest before any
leaf is assigned, so a structure mismatch raises with the exact
discrepancy instead of misassigning leaves.  The tensors are read with
``torch.load(..., weights_only=True)``: no pickled code is run.  Numpy
leaves come back as numpy arrays of their own dtype, tensors as CPU
tensors.

A save is atomic.  Each save writes its tensors to a file of its own,
``tensors-<token>.pt`` (``token`` random), and the manifest names that
file and holds the token and step; both files are written under
temporary names, flushed to disk and renamed, the manifest last.  A save
killed at any point leaves the previous manifest and the tensors file it
names in place.  The tensors file stores the token and step too, and a
load whose files do not pair raises instead of mixing two saves.
"""
from __future__ import annotations

import json
import os
import secrets
from pathlib import Path

import numpy as np
import torch

MANIFEST = "manifest.json"
TOKEN, STEP = "__token__", "__step__"     # pairing keys of a tensors file


def _flatten(tree, leaves: list) -> str:
    """Depth-first leaves of ``tree`` appended to ``leaves``; returns the
    structure string (dict keys sorted, leaves as ``*``)."""
    if isinstance(tree, dict):
        items = sorted(tree.items(), key=lambda kv: str(kv[0]))
        return "{" + ",".join(f"{json.dumps(str(k))}:{_flatten(v, leaves)}"
                              for k, v in items) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ",".join(_flatten(v, leaves) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    if tree is None:
        return "None"
    leaves.append(tree)
    return "*"


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves)
                for k in sorted(like, key=str)}
    if isinstance(like, (list, tuple)):
        out = [_unflatten(v, leaves) for v in like]
        return out if isinstance(like, list) else tuple(out)
    if like is None:
        return None
    return next(leaves)


def _leaf_meta(leaf):
    if isinstance(leaf, torch.Tensor):
        return "torch", str(leaf.dtype).removeprefix("torch."), \
            list(leaf.shape)
    a = np.asarray(leaf)
    return "numpy", str(a.dtype), list(a.shape)


def _write_durably(path: Path, write) -> None:
    """``write(tmp)`` into a temporary file beside ``path``, flushed to
    disk, then renamed onto ``path``."""
    tmp = path.with_name(path.name + ".tmp")
    write(tmp)
    with open(tmp, "rb+") as f:
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _sync_dir(path: Path) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_checkpoint(path, tree, step: int = 0, metadata: dict = None):
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    leaves: list = []
    treedef = _flatten(tree, leaves)
    token = secrets.token_hex(8)
    tensors = {TOKEN: torch.tensor(int(token, 16) - 2**63),
               STEP: torch.tensor(int(step))}
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor):
            tensors[f"leaf_{i}"] = leaf.detach().cpu().contiguous()
        else:
            # a C-ordered copy (np.ascontiguousarray would turn a 0-d
            # array into a 1-d one)
            tensors[f"leaf_{i}"] = torch.from_numpy(
                np.array(leaf, order="C", copy=True))
    metas = [_leaf_meta(leaf) for leaf in leaves]
    tensors_name = f"tensors-{token}.pt"
    manifest = {
        "tensors": tensors_name,
        "token": token,
        "treedef": treedef,
        "num_leaves": len(leaves),
        "step": int(step),
        "kinds": [k for k, _, _ in metas],
        "dtypes": [d for _, d, _ in metas],
        "shapes": [s for _, _, s in metas],
        "metadata": metadata or {},
    }
    _write_durably(path / tensors_name, lambda f: torch.save(tensors, f))
    _write_durably(path / MANIFEST, lambda f: f.write_text(
        json.dumps(manifest, indent=1)))
    _sync_dir(path)
    for old in path.glob("tensors-*.pt*"):      # earlier saves' tensors
        if old.name != tensors_name:
            old.unlink()


def read_manifest(path) -> dict:
    """The checkpoint's manifest dict (structure string, num_leaves, step,
    per-leaf kinds / shapes / dtypes, metadata) without touching the
    tensors."""
    return json.loads((Path(path) / MANIFEST).read_text())


def _validate(manifest: dict, like_tree, path, strict_shapes: bool) -> None:
    leaves: list = []
    treedef = _flatten(like_tree, leaves)
    errs = []
    if len(leaves) != manifest["num_leaves"]:
        errs.append(f"leaf count: checkpoint has {manifest['num_leaves']}, "
                    f"like_tree has {len(leaves)}")
    if treedef != manifest["treedef"]:
        errs.append(f"treedef: checkpoint {manifest['treedef']} != "
                    f"like_tree {treedef}")
    if strict_shapes and len(leaves) == manifest["num_leaves"]:
        for i, (leaf, want) in enumerate(zip(leaves, manifest["shapes"])):
            got = list(leaf.shape) if isinstance(leaf, torch.Tensor) \
                else list(np.shape(leaf))
            if got != want:
                errs.append(f"leaf {i} shape: checkpoint {want}, "
                            f"like_tree {got}")
    if errs:
        raise ValueError(f"checkpoint {path} does not match like_tree: "
                         + "; ".join(errs))


def load_checkpoint(path, like_tree, *, strict_shapes: bool = True):
    """Restore a checkpoint into the structure of ``like_tree``.

    The manifest is validated against ``like_tree`` (leaf count,
    structure, and, unless ``strict_shapes=False``, per-leaf shapes)
    *before* any leaf is assigned.  ``strict_shapes=False`` is for states
    whose leaf shapes are data-dependent (the experiments run state,
    whose online-data buffers change round to round): the saved shapes
    win.

    Returns ``(tree, step, metadata)``; ``metadata`` is the dict passed to
    :func:`save_checkpoint`.
    """
    path = Path(path)
    manifest = read_manifest(path)
    _validate(manifest, like_tree, path, strict_shapes)
    tensors = torch.load(path / manifest["tensors"], map_location="cpu",
                         weights_only=True)
    got = (int(tensors.pop(TOKEN)) + 2**63, int(tensors.pop(STEP)))
    if got != (int(manifest["token"], 16), manifest["step"]):
        raise ValueError(f"checkpoint {path}: {manifest['tensors']} holds "
                         f"the tensors of another save (token, step) "
                         f"{got[0]:016x}, {got[1]}, not the manifest's "
                         f"{manifest['token']}, {manifest['step']}")
    leaves = []
    for i, (kind, dtype, shape) in enumerate(zip(
            manifest["kinds"], manifest["dtypes"], manifest["shapes"])):
        t = tensors[f"leaf_{i}"]
        leaf = t if kind == "torch" else t.numpy()
        got = (str(leaf.dtype).removeprefix("torch."), list(leaf.shape))
        if got != (dtype, shape):
            raise ValueError(f"checkpoint {path}: leaf {i} was saved as "
                             f"{dtype} {shape}, read back as {got}")
        leaves.append(leaf)
    return (_unflatten(like_tree, iter(leaves)), manifest["step"],
            manifest["metadata"])
