"""A spec file the JAX package writes loads in the PyTorch port, and the
reverse (``repro_torch.experiments.spec`` against ``repro.experiments``).

* Every preset: the reference's JSON, ``kernel_backend`` and
  ``sanitize`` included, loads in the port and equals the port's preset;
  the port's JSON loads in the reference and equals the reference's.
* ``engine.kernel_backend`` other than the reference's default ``"auto"``
  raises a ``ValueError`` naming the device rule, on every path:
  ``from_dict``, ``from_json``, ``override`` and the CLI's ``--set``.
* A file written by ``python -m repro.experiments show quickstart``
  (overridden to 1 round) runs to its end through ``python -m
  repro_torch.experiments run <file> --device cpu``.
"""
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from repro import experiments as jexp
from repro.experiments import __main__ as jcli
from repro_torch import experiments as texp
from repro_torch.experiments import __main__ as tcli

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", jexp.available_experiments())
def test_reference_json_loads_in_the_port_and_back(name):
    jspec = jexp.get_experiment(name)
    tspec = texp.get_experiment(name)
    assert "kernel_backend" in jexp.to_json(jspec)
    assert texp.from_json(jexp.to_json(jspec)) == tspec
    assert texp.ExperimentSpec.from_dict(jspec.to_dict()) == tspec
    assert jexp.from_json(texp.to_json(tspec)) == jspec
    # the sanitizer flag carries over both ways
    on = jspec.override(**{"engine.sanitize": True})
    back = texp.from_json(jexp.to_json(on))
    assert back.engine.sanitize is True
    assert back.engine_options(0).sanitize is True
    assert jexp.from_json(texp.to_json(back)) == on


@pytest.mark.parametrize("backend", ["cpu", "interpret", "pallas"])
def test_kernel_backend_other_than_auto_names_the_device_rule(backend):
    d = jexp.get_experiment("quickstart").to_dict()
    d["engine"]["kernel_backend"] = backend
    with pytest.raises(ValueError, match="device rule"):
        texp.ExperimentSpec.from_dict(d)
    with pytest.raises(ValueError, match="device rule"):
        texp.from_json(json.dumps(d))
    spec = texp.get_experiment("quickstart")
    with pytest.raises(ValueError, match="device rule"):
        spec.override(**{"engine.kernel_backend": backend})
    with pytest.raises(ValueError, match="device rule"):
        tcli.main(["show", "quickstart", "--set",
                   f"engine.kernel_backend={backend}"])
    # "auto" is the port's dispatch by device: accepted and dropped
    assert spec.override(**{"engine.kernel_backend": "auto"}) == spec
    out = io.StringIO()
    with redirect_stdout(out):
        assert tcli.main(["show", "quickstart", "--set",
                          "engine.kernel_backend=auto", "--set",
                          "sanitize=true"]) == 0
    assert texp.from_json(out.getvalue()) == spec.override(
        **{"engine.sanitize": True})


def test_reference_written_quickstart_runs_through_the_port_cli(tmp_path):
    out = io.StringIO()
    with redirect_stdout(out):
        assert jcli.main(["show", "quickstart", "--rounds", "1"]) in (0,
                                                                      None)
    path = tmp_path / "q.json"
    path.write_text(out.getvalue())
    assert json.loads(path.read_text())["engine"]["kernel_backend"] == "auto"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.experiments", "run", str(path),
         "--device", "cpu"], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[quickstart seed=0] rounds=1" in proc.stdout
