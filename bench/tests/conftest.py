"""Fixtures of the benchmark's tests: the repository on the import path,
cells cut to a size the CPU runs in seconds, and the card check."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_cell(name: str):
    """(spec, cell, config, workload) of cell ``name`` with its widths and
    world cut to a CPU test's size; the limits stay as committed."""
    from bench import run
    spec, cell, config, workload = run.load_cell(name)
    config, workload = copy.deepcopy(config), copy.deepcopy(workload)
    if workload["driver"] == "sim_round":
        config["network"].update(num_ue=4, num_bs=2, num_dc=2)
        config["model"].update(input_shape=[8, 8, 1], hidden=[16])
        config["data"].update(pool=1500, mean_arrivals=60.0,
                              std_arrivals=6.0, eval_examples=100)
        config["consts"].update(estimate_iters=2)
        config["engine"].update(solver_outer=2)
    else:
        config.update(d_model=64, n_layer=2, vocab_size=256, d_state=16,
                      headdim=16, chunk_size=16)
        workload.update(batch=4, seq=32)
    return spec, cell, config, workload


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
