"""The port's package re-exports against the JAX package's, and its
import boundary.

Every public name a reference package ``__init__`` imports from
``repro``, defines or lists in ``__all__`` (and those of
``kernels.ops``, ``core.fedprox`` and ``sharding.specs``, whose gaps
are decided) is an attribute of the port's counterpart, except the
names of ``DECIDED``, each with the reason it has no counterpart.  In a
fresh interpreter, importing every port package and entry-point module
leaves ``jax`` and ``repro`` out of ``sys.modules``.
"""
import ast
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

PACKAGES = ["core", "solver", "network", "scenario", "models", "data",
            "training", "kernels", "experiments", "sharding", "configs",
            "analysis"]
MODULES = ["kernels.ops", "core.fedprox", "sharding.specs"]

_DEVICE_RULE = ("device rule: dispatch follows the tensor's device, no "
                "backend knob (ROADMAP North star)")
_TILING = "kernels/tiling.py sizes Pallas blocks against TPU VMEM"
_JAXPR = "the jaxpr contract auditor checks JAX programs (ROADMAP: decided)"
_NO_RETRACE = ("retrace guards count XLA compiles; the port traces "
               "nothing")
_POD_SPECS = {n: "the TPU-pod launch tooling's specs" for n in (
    "param_specs", "cache_specs", "batch_spec", "shard_ctx_for",
    "sanitize_tree")}
DECIDED = {
    "kernels.ops": {
        **{n: _DEVICE_RULE for n in (
            "BACKENDS", "INTERPRET", "set_backend", "use_backend",
            "resolve_backend", "detect_backend", "current_backend")},
        "TilePlan": _TILING, "plan_tiles": _TILING,
        # the plane types live in kernels.plane and kernels
        "FlatSpec": "imported by the reference's ops, in repro_torch.kernels",
        "ParamPlane": "imported by the reference's ops, in "
                      "repro_torch.kernels",
    },
    "experiments": {n: "the vmap sweep: same bits as the sequential "
                       "executor, no win on the H100 (PR 17)" for n in (
        "VmapSweepExecutor", "get_sweep_executor")},
    "training": {n: "training/optim.py: no caller on the port's paths"
                 for n in ("adamw", "sgd")},
    "sharding": _POD_SPECS,
    "sharding.specs": {
        **_POD_SPECS,
        "ModelConfig": "imported for those specs",
        "ShardCtx": "imported for those specs; in repro_torch.models"},
    "core.fedprox": {n: "the per-DPU branch SimExecutor("
                        "batch_homogeneous=False)" for n in (
        "local_train", "local_train_multi", "sample_minibatch")}
    | {"Program": _JAXPR, "contract": _JAXPR},
    "solver": {"ref": "solver/ref.py, the numpy oracle: the reference's own "
                      "check (backend='ref' raises)",
               "solve_surrogate": "solver/ref.py's Algorithm-2 oracle"},
    "analysis": {
        **{n: "the AST linter checks JAX API use (ROADMAP: decided)" for n in (
            "Finding", "lint_paths", "lint_project", "lint_source",
            "render_findings", "RULES", "Rule")},
        "jaxpr": _JAXPR,
        "CompileMonitor": _NO_RETRACE, "compile_counts": _NO_RETRACE,
        "no_retrace": _NO_RETRACE,
        "KeyReuseDetector": "watches jax.random keys; the port draws from "
                            "one torch.Generator a run"},
}


def _reference_names(module: str) -> set:
    rel = module.replace(".", "/")
    path = SRC / "repro" / rel / "__init__.py"
    if not path.exists():
        path = SRC / "repro" / f"{rel}.py"
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and \
                node.module.split(".")[0] == "repro":
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    names |= set(ast.literal_eval(node.value))
                elif isinstance(t, ast.Name):
                    names.add(t.id)
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("module", PACKAGES + MODULES)
def test_every_reference_public_name_is_in_the_port(module):
    port = importlib.import_module(f"repro_torch.{module}")
    decided = DECIDED.get(module, {})
    names = _reference_names(module)
    missing = sorted(n for n in names - set(decided) if not hasattr(port, n))
    assert not missing, f"repro.{module} names missing in the port: {missing}"
    # every decided name is one the reference has and the port lacks
    assert set(decided) <= names, sorted(set(decided) - names)
    assert not [n for n in decided if hasattr(port, n)]


def test_port_imports_neither_jax_nor_repro():
    mods = [f"repro_torch.{p}" for p in PACKAGES + MODULES] + [
        "repro_torch.core.cefl", "repro_torch.serve",
        "repro_torch.launch.train", "repro_torch.experiments.__main__",
        "repro_torch.scenario.fuzz", "repro_torch.sharding.parity"] + [
        f"repro_torch.examples.{e}" for e in (
            "quickstart", "cefl_vs_baselines", "mobility_demo", "serve_lm",
            "train_lm_cefl")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
