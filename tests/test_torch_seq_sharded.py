"""The port's sequence-sharded decode (``models.attention.
decode_attention_seq_sharded``, ``ShardCtx``, the ``ctx`` of
``blocks.attn_decode`` / ``lm.lm_decode_step``, ``lm.shard_cache``) on
gloo groups of 4 and 8 CPU ranks, each spawned once per module, against
the port's single-device decode and against the JAX package's
``decode_attention_seq_sharded`` run in a subprocess with 8 forced host
devices on the same numpy inputs.

Tolerances.  f32: 8 f32 ulps of the largest |v| (the output is a convex
combination of v rows; the shards sum their partials in another order
than one pass over the cache, and XLA in its own, which moves each
softmax weight by a few ulps relative; ``chip_smoke.py``'s swa bound).
bf16: one bf16 ulp of the plain version's f32 result, or that f32 bound
where it is larger (the sharded result agrees to f32 rounding, then
rounds once to bf16).  ``lm_decode_step`` with ``ctx``: logits within
5e-4 of the single-device step's (``chip_smoke.py``'s serve check bound)
and the same greedy tokens where the top-2 margin is clear.
"""
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from repro_torch.sharding import parity as P
from repro_torch.sharding.mesh import run_spmd

SHAPE = dict(B=2, S=64, Hq=6, Hkv=2, D=32)
CACHE_LENS = (40, 64)
WINDOWS = (None, 24)
WORLDS = (4, 8)
SRC = str(Path(__file__).resolve().parents[1] / "src")


def _inputs(seed=5):
    rng = np.random.RandomState(seed)
    B, S, Hq, Hkv, D = (SHAPE[k] for k in ("B", "S", "Hq", "Hkv", "D"))
    return {"q": rng.normal(size=(B, Hq, D)).astype(np.float32),
            "k": rng.normal(size=(B, S, Hkv, D)).astype(np.float32),
            "v": rng.normal(size=(B, S, Hkv, D)).astype(np.float32)}


def _calls():
    calls = [(P.decode_worker, dict(inputs=_inputs(), cache_lens=CACHE_LENS,
                                    window=w, keep_outputs=True))
             for w in WINDOWS]
    calls.append((P.decode_worker, dict(inputs=_inputs(), dtype="bfloat16",
                                        cache_lens=CACHE_LENS,
                                        keep_outputs=True)))
    calls.append((P.lm_decode_worker, dict(prompt=40, cache_len=64,
                                           steps=3)))
    return calls


@pytest.fixture(scope="module")
def groups():
    """Per world size: the decode reports (one per window), the bf16
    report and the lm_decode_step report."""
    out = {}
    for n in WORLDS:
        rep = run_spmd(P.sequence_worker, n, _calls(), backend="gloo",
                       device="cpu")
        out[n] = {"decode": dict(zip(WINDOWS, rep[:len(WINDOWS)])),
                  "bf16": rep[len(WINDOWS)], "lm": rep[-1]}
    return out


def _f32_bound(v_absmax):
    return 8 * float(np.spacing(np.float32(v_absmax)))


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("cache_len", CACHE_LENS)
def test_seq_sharded_decode_matches_single_device(groups, n, window,
                                                  cache_len):
    c = groups[n]["decode"][window]["cases"][cache_len]
    assert c["ok_shapes"]
    bound = _f32_bound(c["v_absmax"])
    assert c["vs_plain_f32"] <= bound
    if window is None:   # the kernel dispatch takes no window
        assert c["vs_single"] <= bound


@pytest.mark.parametrize("n", WORLDS)
def test_seq_sharded_decode_collectives(groups, n):
    """One MAX all-reduce (the running max) and two SUM all-reduces (the
    denominators and the numerators) per call, over the cache axis."""
    for window in WINDOWS:
        for c in groups[n]["decode"][window]["cases"].values():
            assert c["collectives"] == {"all_reduce:cache": 3}


def _bf16_ulp(a):
    """One bf16 ulp at |a| (8 significant bits)."""
    _, e = np.frexp(np.abs(a))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("n", WORLDS)
def test_seq_sharded_decode_bf16(groups, n):
    for c in groups[n]["bf16"]["cases"].values():
        got, want = c["out"], c["plain_f32"]
        bound = np.maximum(_bf16_ulp(np.maximum(np.abs(got), np.abs(want))),
                           _f32_bound(c["v_absmax"]))
        assert np.all(np.abs(got - want) <= bound)


@pytest.mark.parametrize("n", WORLDS)
def test_lm_decode_step_with_ctx_matches_single_device(groups, n):
    rep = groups[n]["lm"]
    assert rep["shards"] == n and rep["cache_rows"] == 64
    assert rep["finite"]
    assert rep["logits_max_abs_err"] <= rep["logits_atol"], rep
    assert rep["tokens_agree_where_clear"]
    assert rep["ok"]


def test_no_shard_ctx_is_the_single_device_path():
    from repro_torch.models.common import NO_SHARD, ShardCtx

    assert not NO_SHARD.on_mesh and not NO_SHARD.seq_shard_decode
    assert not ShardCtx(seq_shard_decode=True).on_mesh


# ------------------------------------------- the JAX sharded reference

def _jax_reference(inputs_path: str, out_path: str) -> None:
    """Run in a subprocess with 8 forced host devices: the reference's
    ``decode_attention_seq_sharded`` with the cache split over a (1, n)
    ('data', 'model') mesh, for each world size, window and cache_len."""
    import jax
    import jax.numpy as jnp
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro.models.attention import decode_attention_seq_sharded
        from repro.models.common import ShardCtx

    assert jax.device_count() == 8
    z = {k: jnp.asarray(v) for k, v in np.load(inputs_path).items()}
    out = {}
    for n in WORLDS:
        mesh = jax.make_mesh((1, n), ("data", "model"),
                             devices=jax.devices()[:n])
        ctx = ShardCtx(mesh=mesh, batch_axes=("data",),
                       cache_axes=("model",), seq_shard_decode=True)
        for window in WINDOWS:
            for cl in CACHE_LENS:
                out[f"{n}_{window}_{cl}"] = np.asarray(
                    decode_attention_seq_sharded(
                        z["q"], z["k"], z["v"], jnp.asarray(cl, jnp.int32),
                        ctx=ctx, window=window))
    np.savez(out_path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_seq_sharded")
    np.savez(tmp / "inputs.npz", **_inputs())
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    proc = subprocess.run(
        [sys.executable, __file__, str(tmp / "inputs.npz"),
         str(tmp / "ref.npz")], env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(tmp / "ref.npz"))


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("cache_len", CACHE_LENS)
def test_seq_sharded_decode_matches_the_jax_reference(groups, reference, n,
                                                      window, cache_len):
    c = groups[n]["decode"][window]["cases"][cache_len]
    want = reference[f"{n}_{window}_{cache_len}"]
    bound = _f32_bound(c["v_absmax"])
    np.testing.assert_allclose(c["out"], want, rtol=0, atol=bound)
    np.testing.assert_allclose(c["plain"], want, rtol=0, atol=bound)


if __name__ == "__main__":
    _jax_reference(sys.argv[1], sys.argv[2])
