"""The port's sharded parameter plane (``repro_torch.sharding``) on gloo
process groups of CPU ranks, against the port's single-device paths and
against the JAX package's ``repro.sharding.plane``.

The groups are spawned once per module (``run_spmd``, world sizes 8 and
4) and every case runs inside them; the tests read the reports.  The
reference's cases are ported one for one (``tests/test_sharding_plane.py``:
mesh shapes (8, 1) (4, 2) (2, 4) (1, 8) (2, 2), the ragged G = 7 and
G = 3 groups, both robust modes, both reduce modes, the engine under
``fednova`` at 4 UEs, the ``MeshExecutor`` contract); in a world of 8 the
(2, 2) mesh leaves ranks 4-7 outside, which run the single-device op.
The collective counts of the reference's jaxpr contracts (which have no
port) are counted on the collective wrappers.

Tolerances.  Against the port's single-device paths: bitwise (the bytes)
for the exact mode, the ops, the fused round and the engine at these
shapes; rtol = atol = 1e-6 for the psum mode (the reference's bound:
float addition reorders).  ``MeshExecutor(mesh_shape=...)``: atol 1e-5,
the reference's allclose contract.  Against the JAX sharded reference,
run in a subprocess with 8 forced host devices: the ops to the ulp bound
of ``tests/test_torch_kernels.py`` (rtol 1e-6 plus two ulps of the
largest operand: XLA contracts FMAs and orders sums its own way), the
staged round to ``tests/test_torch_fedprox.py``'s (new plane rtol 1e-5 /
atol 1e-6, losses rtol 1e-5).  The batch-count test holds a round whose
per-DPU gradients change with the batch count to rtol = atol = 1e-6.
"""
import json
import os
import subprocess
import sys
import types
import warnings
from pathlib import Path

import numpy as np
import pytest

from repro_torch.sharding import parity as P
from repro_torch.sharding.mesh import plane_axes, run_spmd
from repro_torch.sharding.specs import sanitize_spec

MESH_SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8), (2, 2)]
WORLD4_SHAPES = [(2, 2), (4, 1), (1, 4)]
LANE = 1024
ROUND_KW = dict(gamma=3, m_frac=0.25, eta=0.05, mu=0.1, theta=1.0)
SMALL_WORLD = dict(pool=1200, input_shape=(8, 8, 1), hidden=(16,),
                   eval_examples=100)
# (mesh, CPU threads per rank, examples per DPU): the first two give the
# classifier's products other bits at the two batch counts on this CPU
BATCH_COUNT_CASES = [((8, 1), 2, 64), ((4, 2), 4, 500), ((2, 4), 1, 64)]
CLI_RUN = ["run", "quickstart", "--device", "cpu", "--rounds", "2",
           "--strategy", "fednova"]
SRC = str(Path(__file__).resolve().parents[1] / "src")


def _op_inputs(G=8, R=16, seed=1):
    """The reference test's op inputs (``_op_inputs``) plus the proximal
    step's, as numpy."""
    rng = np.random.RandomState(seed)
    x = rng.normal(size=(R, LANE)).astype(np.float32)
    d = rng.normal(size=(G, R, LANE)).astype(np.float32)
    w = np.abs(rng.normal(size=(G,))).astype(np.float32)
    return {"x": x, "d": d, "w": w / w.sum(),
            "xs": rng.normal(size=(G, R, LANE)).astype(np.float32),
            "g": rng.normal(size=(G, R, LANE)).astype(np.float32),
            "coef": np.abs(rng.normal(size=(G,))).astype(np.float32),
            "active": np.ones((G,), np.float32)}


@pytest.fixture(scope="module")
def world8():
    calls = [
        (P.mesh_checks, {}),
        (P.ops_worker, dict(meshes=MESH_SHAPES, inputs=_op_inputs())),
        (P.ops_worker, dict(meshes=[(4, 2)], inputs=_op_inputs(G=7))),
        (P.round_worker, dict(meshes=MESH_SHAPES, eval_examples=100,
                              **ROUND_KW)),
        (P.round_worker, dict(meshes=[(4, 2)], reduces=("psum",),
                              **ROUND_KW)),
        (P.round_worker, dict(meshes=[(8, 1)], G=3, **ROUND_KW)),
        (P.engine_worker, dict(meshes=[(4, 2), (2, 2)])),
        (P.mesh_executor_worker, dict(mesh=(4, 2), world=SMALL_WORLD)),
    ] + [(P.batch_count_worker, dict(mesh=m, threads=t, examples=n))
         for m, t, n in BATCH_COUNT_CASES]
    out = run_spmd(P.sequence_worker, 8, calls, backend="gloo",
                   device="cpu")
    keys = ["mesh", "ops", "ops7", "round", "round_psum", "round3",
            "engine", "mesh_executor"]
    rep = dict(zip(keys, out))
    rep["batch_count"] = out[len(keys):]
    return rep


@pytest.fixture(scope="module")
def world4():
    out = run_spmd(P.sequence_worker, 4, [
        (P.mesh_checks, {}),
        (P.ops_worker, dict(meshes=WORLD4_SHAPES, inputs=_op_inputs())),
        (P.round_worker, dict(meshes=WORLD4_SHAPES, reduces=("exact",
                                                             "psum"),
                              **ROUND_KW)),
        (P.engine_worker, dict(meshes=[(2, 2), (4, 1)])),
        (P.mesh_executor_worker, dict(mesh=(2, 2), world=SMALL_WORLD)),
        (P.cli_worker, dict(argvs=[CLI_RUN,
                                   CLI_RUN + ["--set", "mesh_shape=2,2"]])),
    ], backend="gloo", device="cpu")
    return dict(zip(["mesh", "ops", "round", "engine", "mesh_executor",
                     "cli"], out))


def _world(request, name):
    return request.getfixturevalue(name)


CASES = [("world8", s) for s in MESH_SHAPES] + \
    [("world4", s) for s in WORLD4_SHAPES]


# ------------------------------------------------------------- meshes ---

@pytest.mark.parametrize("world", ["world8", "world4"])
def test_plane_mesh_shapes_and_validation(request, world):
    rep = _world(request, world)["mesh"]
    n = rep["world"]
    assert rep["default_shape"] == {"dpu": n, "rows": 1}
    assert rep["cached"]
    assert "ranks" in rep["too_big"] and str(n) in rep["too_big"]
    assert rep["zero"] is not None
    assert rep["opts_too_big"] is not None
    assert rep["opts_ok"] == (n, 1)


def test_mesh_shape_needs_a_process_group():
    """Without an initialised default group neither the engine options
    nor the mesh can be made."""
    import torch.distributed as dist

    from repro_torch.core.api import EngineOptions
    from repro_torch.sharding.mesh import plane_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group|default group"):
        EngineOptions(mesh_shape=(2, 2))
    with pytest.raises(RuntimeError, match="default group"):
        plane_mesh((1, 1))
    assert EngineOptions().mesh_shape is None


SANITIZE_SIZES = {"data": 2, "model": 16}
SANITIZE_CASES = [((None, None, "model", None), (4, 128, 8, 64)),
                  ((None, None, "model", None), (4, 128, 32, 64)),
                  (("data",), (8, 16, 32)),
                  ((("data", "model"),), (32,)),
                  ((("data", "model"),), (12,)),
                  (("data", "model"), (7, 48))]
PLANE_AXES_CASES = [((d, r), (G, R))
                    for d, r in [(4, 2), (8, 1), (1, 8), (2, 4), (3, 2)]
                    for G, R in [(8, 16), (7, 16), (4, 176), (25, 176),
                                 (None, 12)]]


def _spec_tables(sanitize, plane_axes_fn):
    """``sanitize(spec, shape)`` and ``plane_axes_fn(mesh, G, R)`` over the
    cases above, as JSON (meshes only read ``mesh.shape``)."""
    spec_rows = [list(sanitize(spec, shape))
                 for spec, shape in SANITIZE_CASES]
    axes_rows = [list(plane_axes_fn(types.SimpleNamespace(
        shape={"dpu": d, "rows": r}), G, R))
        for (d, r), (G, R) in PLANE_AXES_CASES]
    return json.loads(json.dumps([spec_rows, axes_rows]))


def test_sanitize_spec_and_plane_axes_match_the_reference(jax_vs_port):
    """The divisibility rule against ``repro.sharding.specs`` and the
    reference's ``plane_axes``, as the subprocess computed them."""
    ref = jax_vs_port[0]
    got = _spec_tables(
        lambda spec, shape: sanitize_spec(spec, shape, SANITIZE_SIZES),
        plane_axes)
    assert got == json.loads(str(ref["spec_tables"]))


# ---------------------------------------------------- standalone ops ---

@pytest.mark.parametrize("world,shape", CASES)
def test_nova_aggregate_sharded_exact_is_bitwise(request, world, shape):
    rec = _world(request, world)["ops"]["meshes"][str(shape)]["nova_exact"]
    assert rec["bitwise"], f"mesh {shape} not bitwise"
    assert rec["ranks_agree"]


@pytest.mark.parametrize("world,shape", CASES)
def test_nova_aggregate_sharded_psum_is_allclose(request, world, shape):
    rep = _world(request, world)
    rec = rep["ops"]["meshes"][str(shape)]["nova_psum"]
    assert rec["allclose"], rec["max_abs_err"]
    # ranks outside the mesh hold the single-device result, which the
    # psum mode matches only to the tolerance
    if shape[0] * shape[1] == rep["mesh"]["world"]:
        assert rec["ranks_agree"]


def test_nova_aggregate_sharded_rejects_unknown_reduce():
    from repro_torch.sharding import plane as shplane
    x = np.zeros((8, LANE), np.float32)
    with pytest.raises(ValueError, match="reduce"):
        shplane.nova_aggregate_plane_sharded(x, x[None], [1.0], 0.3,
                                             mesh=None, reduce="mean")


def test_nova_aggregate_sharded_ragged_group_degrades_bitwise(world8):
    """G = 7 divides no dpu axis: that dim is replicated, still bitwise,
    and no collective runs over 'dpu'."""
    rec = world8["ops7"]["meshes"]["(4, 2)"]
    for op in ("nova_exact", "nova_psum", "robust_trimmed_mean",
               "robust_median", "fedprox_accum"):
        assert rec[op]["bitwise"], op
        assert not any(k.endswith(":dpu") for k in rec[op]["collectives"])


@pytest.mark.parametrize("mode", ["trimmed_mean", "median"])
def test_robust_aggregate_sharded_is_bitwise(world8, world4, mode):
    for world, shape in CASES:
        rep = world8 if world == "world8" else world4
        rec = rep["ops"]["meshes"][str(shape)][f"robust_{mode}"]
        assert rec["bitwise"] and rec["ranks_agree"], (world, shape)


@pytest.mark.parametrize("world,shape", CASES)
def test_fedprox_accum_sharded_is_bitwise(request, world, shape):
    rec = _world(request, world)["ops"]["meshes"][str(shape)][
        "fedprox_accum"]
    assert rec["bitwise"] and rec["ranks_agree"]


# -------------------------------------------- the jaxpr contracts' counts

def test_collective_counts_of_the_nova_contracts(world8):
    """``nova_sharded_exact``: two all-gathers over 'dpu' (d and w), no
    all-reduce; ``nova_sharded_psum``: exactly one all-reduce, no
    all-gather over 'dpu'.  At (4, 2) the output's row gather is the
    one collective over 'rows'."""
    rec = world8["ops"]["meshes"]["(4, 2)"]
    assert rec["nova_exact"]["collectives"] == {"all_gather:dpu": 2,
                                                "all_gather:rows": 1}
    assert rec["nova_psum"]["collectives"] == {"all_reduce:dpu": 1,
                                               "all_gather:rows": 1}


@pytest.mark.parametrize("reduce", ["exact", "psum"])
def test_collective_counts_of_the_round_contracts(world8, reduce):
    """``sharded_round_exact``: all-gathers only; ``sharded_round_psum``:
    exactly one all-reduce (eq. 11) on top of the row gathers."""
    rep = world8["round"] if reduce == "exact" else world8["round_psum"]
    c = rep["meshes"][f"(4, 2) {reduce}"]["collectives"]
    assert c.get("all_reduce:dpu", 0) == (1 if reduce == "psum" else 0)
    assert not any(k.startswith("all_reduce:rows") for k in c)
    # gamma gathers of the rows for the loss plus the aggregate's
    assert c["all_gather:rows"] == ROUND_KW["gamma"] + 1
    assert c["all_gather:dpu"] >= 1


# --------------------------------------------------- fused sharded round

@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_sharded_round_bitwise_across_mesh_shapes(world8, shape):
    rec = world8["round"]["meshes"][f"{shape} exact"]
    assert rec["params_bitwise"], f"params diverge on mesh {shape}"
    assert rec["losses_bitwise"], f"losses diverge on mesh {shape}"
    assert rec["acc_equal"]


@pytest.mark.parametrize("shape", WORLD4_SHAPES)
def test_sharded_round_in_a_world_of_four(world4, shape):
    rep = world4["round"]["meshes"]
    assert rep[f"{shape} exact"]["params_bitwise"]
    assert rep[f"{shape} exact"]["losses_bitwise"]
    assert rep[f"{shape} psum"]["allclose"]


def test_sharded_round_psum_mode_allclose(world8):
    rec = world8["round_psum"]["meshes"]["(4, 2) psum"]
    assert rec["allclose"], rec["max_abs_err"]


def test_sharded_round_ragged_group_bitwise(world8):
    rec = world8["round3"]["meshes"]["(8, 1) exact"]
    assert rec["params_bitwise"] and rec["losses_bitwise"]


@pytest.mark.parametrize("case", range(len(BATCH_COUNT_CASES)))
def test_dpu_split_bits_follow_the_batch_count(world8, case):
    """At the paper's width (28x28x1 -> 200 -> 100 -> 10) the 'dpu'
    split changes how many DPUs one batched loss carries.  The round may
    differ from the single-device one only where the per-DPU gradients
    differ between the two batch counts (the BLAS, not the sharding
    code); then it stays within rtol = atol = 1e-6."""
    rec = world8["batch_count"][case]
    if rec["grads_bitwise"]:
        assert rec["round_bitwise"] and rec["losses_bitwise"], rec
    else:
        assert rec["allclose"], rec
    if BATCH_COUNT_CASES[case][0] == (2, 4):
        assert rec["grads_bitwise"] and rec["round_bitwise"]


# ------------------------------------------------------- engine parity

@pytest.mark.parametrize("world,shape", [("world8", (4, 2)),
                                         ("world8", (2, 2)),
                                         ("world4", (2, 2)),
                                         ("world4", (4, 1))])
def test_engine_sharded_matches_single_device_bitwise(request, world,
                                                      shape):
    """``EngineOptions.mesh_shape`` end to end under ``fednova``:
    accuracy, loss AND final params equal the single-device run's bits,
    and every round went through the sharded fused round."""
    rep = _world(request, world)["engine"]
    rec = rep["meshes"][str(shape)]
    assert rec["acc_equal"] and rec["loss_equal"], (rec["acc"],
                                                    rep["single"])
    assert rec["params_bitwise"], rec["max_abs_err"]
    assert rec["fused_rounds"] == len(rep["single"]["acc"])


@pytest.mark.parametrize("world,shape", [("world8", (4, 2)),
                                         ("world4", (2, 2))])
def test_mesh_executor_sharded_plane_allclose(request, world, shape):
    rec = _world(request, world)["mesh_executor"]
    assert rec["mesh_steps"] == len(rec["loss"])
    np.testing.assert_allclose(rec["loss"], rec["ref_loss"], atol=1e-5)
    assert rec["params_max_abs_err"] <= 1e-5


def test_cli_runs_a_sharded_spec(world4):
    """``--set mesh_shape=2,2`` under a group of 4: rank 0 alone prints,
    every round runs sharded through the engine (a header, a line a
    round and the result line), and the result line equals the one the
    unsharded spec's sweep prints first."""
    single, sharded = world4["cli"]
    assert sharded["fused_rounds"] == 2 and single["fused_rounds"] == 0
    assert sharded["silent_ranks"] and single["silent_ranks"]
    lines = sharded["stdout"].splitlines()
    assert len(lines) == 4
    assert lines[-1] == single["stdout"].splitlines()[0]


def test_spec_carries_mesh_shape():
    from repro_torch.experiments import from_json, get_experiment, to_json
    from repro_torch.experiments.__main__ import _SHORT_KEYS

    spec = get_experiment("quickstart").override(
        **{_SHORT_KEYS["mesh_shape"]: "2,2"})
    assert spec.engine.mesh_shape == (2, 2)
    assert from_json(to_json(spec)) == spec
    assert get_experiment("quickstart").engine.mesh_shape is None


# ------------------------------------------- the JAX sharded reference

def _jax_reference(inputs_path: str, out_path: str) -> None:
    """Run in a subprocess with 8 forced host devices: the reference's
    sharded ops and its sharded round (staged from fixed keys) at mesh
    (4, 2), both modes, on the inputs of ``inputs_path``."""
    import jax
    import jax.numpy as jnp
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro.sharding import plane as sp
    from repro.configs.cefl_paper import ClassifierConfig
    from repro.core import fedprox as jfp
    from repro.kernels.plane import as_plane
    from repro.models.classifier import (classifier_loss,
                                         init_classifier_params)

    assert jax.device_count() == 8
    z = dict(np.load(inputs_path))
    mesh = sp.plane_mesh((4, 2))
    x, d, w = (jnp.asarray(z[k]) for k in ("x", "d", "w"))
    out = {}
    for reduce in ("exact", "psum"):
        out[f"nova_{reduce}"] = sp.nova_aggregate_plane_sharded(
            x, d, w, 0.3, mesh=mesh, reduce=reduce)
    for mode in ("trimmed_mean", "median"):
        out[f"robust_{mode}"] = sp.robust_aggregate_plane_sharded(
            x, d, 0.3, mesh=mesh, mode=mode, trim_frac=0.2)
    xs = jnp.asarray(z["xs"])
    out["fedprox_x"], out["fedprox_acc"] = sp.fedprox_accum_plane_sharded(
        xs, jnp.asarray(z["g"]), x, jnp.zeros_like(xs),
        jnp.asarray(z["coef"]), jnp.asarray(z["active"]), 0.05, 0.1,
        mesh=mesh)
    # the reference test's round inputs, staged as local_round_plane does
    cfg = ClassifierConfig(input_shape=(10, 10, 1), hidden=(32,))
    params = init_classifier_params(jax.random.PRNGKey(0), cfg)
    plane = as_plane(params)
    G, gamma, m_frac = 4, ROUND_KW["gamma"], ROUND_KW["m_frac"]
    eta, mu = ROUND_KW["eta"], ROUND_KW["mu"]
    data = [{k: jnp.asarray(v) for k, v in dd.items()}
            for dd in P.round_datasets(G, 64, (10, 10, 1))]
    Ds = [64] * G
    bucket = jfp._bucket(jfp.batch_size(64, m_frac))
    keys = [jax.random.PRNGKey(i + 1) for i in range(G)]
    step_keys = jax.vmap(lambda k: jax.random.split(k, gamma))(
        jnp.stack(keys))
    stack, idx, wts = jfp._stage_group_batches(data, step_keys, Ds, bucket,
                                               gamma, m_frac)
    args = (plane.broadcast(G).data, plane.data, stack, idx, wts,
            jfp.a_coefficients(gamma, eta, mu),
            jnp.asarray(eta, jnp.float32), jnp.asarray(mu, jnp.float32),
            jnp.asarray(Ds, jnp.float32),
            jnp.asarray(ROUND_KW["theta"] * eta, jnp.float32))
    for reduce in ("exact", "psum"):
        run = sp._sharded_round_fn(classifier_loss, plane.spec, mesh, "cpu",
                                   reduce=reduce)
        out[f"round_{reduce}_new"], out[f"round_{reduce}_losses"], _ = \
            run(*args)
    for i, a in enumerate(args):
        if isinstance(a, dict):
            for k, v in a.items():
                out[f"staged_{i}_{k}"] = v
        else:
            out[f"staged_{i}"] = a
    for k, v in params.items():
        out[f"p0_{k}"] = v
    from jax.sharding import PartitionSpec as JP
    mesh_sizes = types.SimpleNamespace(shape=SANITIZE_SIZES)
    out["spec_tables"] = json.dumps(_spec_tables(
        lambda spec, shape: sp.sanitize_spec(JP(*spec), shape, mesh_sizes),
        sp.plane_axes))
    np.savez(out_path, **{k: np.asarray(v) for k, v in out.items()})


@pytest.fixture(scope="module")
def jax_vs_port(tmp_path_factory):
    """The JAX reference's outputs (subprocess) and the port's on the same
    inputs (a group of 8), at mesh (4, 2)."""
    tmp = tmp_path_factory.mktemp("jax_sharded")
    inputs = _op_inputs()
    np.savez(tmp / "inputs.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    proc = subprocess.run(
        [sys.executable, __file__, str(tmp / "inputs.npz"),
         str(tmp / "ref.npz")], env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = dict(np.load(tmp / "ref.npz"))
    staged = tuple(
        {k.split("_", 2)[2]: v for k, v in ref.items()
         if k.startswith("staged_2_")} if i == 2 else ref[f"staged_{i}"]
        for i in range(10))
    p0 = {k[3:]: v for k, v in ref.items() if k.startswith("p0_")}
    ops_rep, round_rep = run_spmd(P.sequence_worker, 8, [
        (P.ops_worker, dict(meshes=[(4, 2)], inputs=inputs, keep=(4, 2))),
        (P.round_worker, dict(meshes=[], staged=staged, p0=p0,
                              staged_meshes=[(4, 2)], **ROUND_KW)),
    ], backend="gloo", device="cpu")
    return ref, inputs, ops_rep["outputs"], round_rep["staged"]


def _ulp_close(got, want, *operands):
    scale = max(float(np.max(np.abs(o))) for o in operands)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=2 * np.spacing(np.float32(scale)))


@pytest.mark.parametrize("op", ["nova_exact", "nova_psum",
                                "robust_trimmed_mean", "robust_median",
                                "fedprox_x", "fedprox_acc"])
def test_sharded_ops_match_the_jax_sharded_reference(jax_vs_port, op):
    ref, inputs, port, _ = jax_vs_port
    operands = [inputs["x"], inputs["d"]] if not op.startswith("fedprox") \
        else [inputs["xs"], inputs["g"], inputs["x"]]
    _ulp_close(port[op], ref[op], *operands)


@pytest.mark.parametrize("reduce", ["exact", "psum"])
def test_sharded_round_matches_the_jax_sharded_reference(jax_vs_port,
                                                         reduce):
    ref, _, _, staged = jax_vs_port
    got = staged[f"(4, 2) {reduce}"]
    np.testing.assert_allclose(got["new"], ref[f"round_{reduce}_new"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["losses"], ref[f"round_{reduce}_losses"],
                               rtol=1e-5)
    # the port's sharded exact round is its single-device round's bits
    if reduce == "exact":
        assert np.array_equal(got["new"].view(np.uint32),
                              staged["single"][0].view(np.uint32))


if __name__ == "__main__":
    _jax_reference(sys.argv[1], sys.argv[2])
