"""The control on the card: the reference computed a precision below the
configuration's (TF32 matmuls, bfloat16 costs) in the program's place
is judged not correct, where the program is judged correct, at each
cell's own size (``bench/readings.py`` takes the same readings over more
seeds).  At a smaller width TF32's error shrinks under the limits set at
the cell's, so the test keeps the cell's size."""
from __future__ import annotations

import pytest

from bench import run
from bench.trace import Tracer


@pytest.mark.card
@pytest.mark.parametrize("name", ["paper_mlp.cefl", "mamba2_130m.b8"])
@pytest.mark.parametrize("seed", [2 ** 31 + 5, 2 ** 31 + 6, 2 ** 31 + 7])
def test_control_is_not_correct(name, seed, card, monkeypatch):
    import importlib
    import torch
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    _, _, config, workload = run.load_cell(name)
    driver = importlib.import_module(f"bench.drivers.{workload['driver']}")
    r = driver.make(config, workload, seed, card, Tracer(False))
    r.setup()
    r.close_program()
    limits = workload["limits"]
    assert run.judge(r.readings("program"), limits)[0]
    assert not run.judge(r.readings("control"), limits)[0]
