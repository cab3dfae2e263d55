"""Full-state sweep checkpoints: kill a sweep mid-run, resume bit-exact.
Counterpart of ``repro.experiments.runstate``.

A sweep's run state is everything the remaining rounds depend on, per
seeded run:

* the engine :class:`~repro_torch.core.engine.LoopState` (flat param
  plane, the numpy ``RandomState`` and the ``torch.Generator`` of the
  mini-batch draws, warm-start plan, cumulative costs, round index),
* the scenario's internal state (mobility positions/velocities, serving
  associations, schedule state),
* every UE's :class:`~repro_torch.core.drift.OnlineDataset` state (stream
  PRNG + live data buffer),
* the metric trace so far (``RoundReport`` records).

Serialization rides through ``repro_torch.training.checkpoint``: array
and tensor leaves go to the tensors file, the nesting structure is packed
into a JSON *skeleton* stored in the manifest metadata (with the report
records, which are JSON-native).  ``load_checkpoint`` validates the leaf
list before unpacking; shapes are data-dependent round to round (online
buffers change), so the like-list is built from the manifest itself.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.experiments.trace import (report_from_record,
                                           report_to_record)
from repro_torch.training.checkpoint import (load_checkpoint, read_manifest,
                                             save_checkpoint)

STATE_KIND = "cefl-sweep-state"


# ------------------------------------------------- pack / unpack --------

def _pack(obj, leaves: list):
    """Nested dict/list/scalar structure -> JSON skeleton; ndarray and
    tensor leaves are swapped for ``{"__leaf__": i}`` placeholders
    appended to ``leaves`` (depth-first, deterministic order)."""
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        leaves.append(obj)
        return {"__leaf__": len(leaves) - 1}
    if isinstance(obj, dict):
        if "__leaf__" in obj:
            raise ValueError("'__leaf__' is a reserved key")
        return {str(k): _pack(v, leaves) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_pack(v, leaves) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    raise TypeError(f"cannot pack {type(obj).__name__} into run state")


def _unpack(skel, leaves: list):
    if isinstance(skel, dict):
        if set(skel) == {"__leaf__"}:
            return leaves[skel["__leaf__"]]
        return {k: _unpack(v, leaves) for k, v in skel.items()}
    if isinstance(skel, list):
        return [_unpack(v, leaves) for v in skel]
    return skel


# ------------------------------------------------- save / load ----------

def sweep_state_dict(runs) -> Tuple[dict, dict]:
    """(array-state, json-reports) for a list of ``sweep._Run``s."""
    state, reports = {}, {}
    for run in runs:
        key = str(run.seed)
        state[key] = {
            "loop": run.state.state_dict(),
            "scenario": run.engine.scenario.state_dict(),
            "ues": {str(i): u.state_dict()
                    for i, u in enumerate(run.ues)},
        }
        reports[key] = [report_to_record(r) for r in run.state.reports]
    return state, reports


def save_sweep_state(path, runs, *, spec_json: str, round_idx: int) -> None:
    state, reports = sweep_state_dict(runs)
    leaves: list = []
    skeleton = _pack(state, leaves)
    save_checkpoint(path, leaves, step=round_idx, metadata={
        "kind": STATE_KIND,
        "skeleton": skeleton,
        "reports": reports,
        "spec": spec_json,
    })


def load_sweep_state(path):
    """-> (state dict, reports dict, spec_json, round_idx).  The saved
    leaf list is validated (count / structure / shapes) against the
    manifest before unpacking, so a corrupted tensors/manifest pair
    raises instead of misassigning state."""
    manifest = read_manifest(path)
    meta = manifest["metadata"]
    if meta.get("kind") != STATE_KIND:
        raise ValueError(f"{path} is not a {STATE_KIND} checkpoint "
                         f"(kind={meta.get('kind')!r})")
    like = [np.zeros(s) for s in manifest["shapes"]]
    leaves, step, meta = load_checkpoint(path, like)
    state = _unpack(meta["skeleton"], leaves)
    return state, meta["reports"], meta["spec"], step


def restore_run(run, state: dict, reports: List[dict], engine) -> None:
    """Load one run's state into freshly built (round-0) objects."""
    run.state.load_state_dict(state["loop"])
    engine.scenario.load_state_dict(state["scenario"])
    for i, u in enumerate(run.ues):
        u.load_state_dict(state["ues"][str(i)])
    run.state.reports = [report_from_record(r) for r in reports]
