"""The PyTorch port's scenario fuzzer (``repro_torch.scenario.fuzz``)
against the JAX package's, on the CPU.

* ``draw_spec`` draws from a numpy ``RandomState`` in the reference's
  order, so for the same campaign seed it gives the reference's spec
  JSON (less the engine fields the port has no counterpart for) and the
  same pools.
* Two draws pass invariants 1 (determinism), 2 (conservation), 4
  (finiteness) and 5 (resume); invariant 3 (no-retrace) has no
  counterpart, since the port compiles nothing per shape.
* A broken invariant (the replay run under another seed) is caught,
  serialized, and replays from its artifact; the CLI's
  ``--break-invariant`` selftest exits 0.
"""
import importlib
import json

import numpy as np
import pytest
import torch

from repro_torch.experiments import spec as tspec
from repro_torch.scenario import fuzz as tfuzz

jfuzz = importlib.import_module("repro.scenario.fuzz")
jspec = importlib.import_module("repro.experiments.spec")

torch.set_num_threads(2)

# the reference's spec field the port has no counterpart for (kernel
# dispatch: by device, no knob; "auto" loads and is dropped)
JAX_ONLY_ENGINE = ("kernel_backend",)


def _jax_dict(spec):
    d = json.loads(jspec.to_json(spec))
    for k in JAX_ONLY_ENGINE:
        d["engine"].pop(k)
    return d


def test_pools_equal_the_reference():
    for name in ("SCENARIO_POOL", "STRATEGY_POOL", "ROBUST_POOL"):
        assert getattr(tfuzz, name) == getattr(jfuzz, name), name


@pytest.mark.parametrize("campaign", [0, 1, 7, 1234])
def test_draw_spec_equals_the_reference(campaign):
    jrng, trng = np.random.RandomState(campaign), \
        np.random.RandomState(campaign)
    for _ in range(12):
        t = tfuzz.draw_spec(trng, rounds=4)
        j = jfuzz.draw_spec(jrng, rounds=4)
        assert json.loads(tspec.to_json(t)) == _jax_dict(j)
        assert tspec.from_json(tspec.to_json(t)) == t
    assert trng.randint(2 ** 31 - 1) == jrng.randint(2 ** 31 - 1)


def test_two_draws_pass_every_invariant(tmp_path):
    lines = []
    out = tmp_path / "fuzz_out"
    artifacts = tfuzz.run_fuzz(2, 0, str(out), device="cpu",
                               progress=lines.append)
    assert artifacts == [] and not out.exists()
    assert len(lines) == 2 and all("[fuzz] ok" in ln for ln in lines)


def test_broken_invariant_is_caught_serialized_and_replays(tmp_path):
    lines = []
    artifacts = tfuzz.run_fuzz(1, 3, str(tmp_path), mutate_seed=True,
                               device="cpu", progress=lines.append)
    assert len(artifacts) == 1 and "FAIL" in lines[0]
    assert "--replay" in lines[0] and "--device cpu" in lines[0]
    with open(artifacts[0]) as fh:
        art = json.load(fh)
    assert art["invariant"] == "determinism" and art["fuzz_seed"] == 3
    spec = tspec.from_json(json.dumps(art["spec"]))
    assert spec == tfuzz.draw_spec(np.random.RandomState(3))
    # without the mutation the draw passes: the failure does not
    # reproduce, so the replay exits 0
    assert tfuzz.main(["--replay", artifacts[0], "--device", "cpu"]) == 0
    with pytest.raises(tfuzz.InvariantViolation, match="determinism"):
        tfuzz.check_draw(spec, mutate_seed=True, device="cpu")


def test_cli_break_invariant_selftest(tmp_path, capsys):
    rc = tfuzz.main(["--break-invariant", "determinism", "--device", "cpu",
                     "--out", str(tmp_path), "--seed", "5"])
    assert rc == 0
    assert "selftest ok" in capsys.readouterr().out
    assert (tmp_path / "failing_draw_0.json").exists()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tfuzz.main(["--n", "1", "--out", str(tmp_path)])
