"""Parity of the PyTorch port's parameter plane (repro_torch.kernels.plane)
with the JAX package's: same rows, offsets and leaf order, flatten /
unflatten round trips, and bitwise-equal planes of the same parameters."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import plane as jplane
from repro_torch.kernels import plane as tplane

torch.set_num_threads(2)


def _classifier_tree(din, hidden, dout=10, seed=0):
    rng = np.random.RandomState(seed)
    dims = [din] + list(hidden) + [dout]
    tree = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        tree[f"w{i}"] = rng.normal(size=(a, b)).astype(np.float32)
        tree[f"b{i}"] = rng.normal(size=(b,)).astype(np.float32)
    return tree


TREES = {
    # the quickstart classifier 14x14x1 -> 64 -> 10: 16 rows
    "quickstart": (_classifier_tree(196, (64,)), 16),
    # the paper classifier 28x28x1 -> 200 -> 100 -> 10: 176 rows
    "paper": (_classifier_tree(784, (200, 100)), 176),
    # above 256 rows the count rounds up to a multiple of 128
    "wide": ({"a": np.ones((300, 1024), np.float32),
              "b": {"c": np.ones((5,), np.float32),
                    "d": np.ones((3, 7), np.float32)}}, 384),
}


def _jax_tree(tree):
    return {k: _jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("name", sorted(TREES))
def test_spec_matches_jax(name):
    tree, rows = TREES[name]
    js = jplane.spec_of(_jax_tree(tree))
    ts = tplane.spec_of(_torch_tree(tree))
    assert ts.rows == js.rows == rows
    assert ts.n == js.n
    assert ts.offsets == js.offsets
    assert ts.shapes == js.shapes


@pytest.mark.parametrize("n", [1, 1024, 1025, 8 * 1024, 8 * 1024 + 1,
                               256 * 1024, 256 * 1024 + 1, 1000 * 1024])
def test_row_count_matches_jax(n):
    assert tplane._row_count(n) == jplane._row_count(n)


@pytest.mark.parametrize("name", sorted(TREES))
def test_plane_of_jax_params_is_bitwise_equal(name):
    tree, _ = TREES[name]
    jp = jplane.ParamPlane.from_tree(_jax_tree(tree))
    tp = tplane.ParamPlane.from_numpy(tree, device="cpu")
    np.testing.assert_array_equal(tp.data.numpy(), np.asarray(jp.data))


@pytest.mark.parametrize("name", sorted(TREES))
def test_round_trip(name):
    tree, _ = TREES[name]
    t = _torch_tree(tree)
    plane = tplane.as_plane(t)
    back = tplane.as_tree(plane)
    for (pa, a), (pb, b) in zip(tplane.tree_paths(t),
                                tplane.tree_paths(back)):
        assert pa == pb
        assert torch.equal(a, b)


def test_round_trip_bf16_leaves():
    t = {"w": torch.randn(5, 7, generator=torch.Generator().manual_seed(0))
         .to(torch.bfloat16), "b": torch.arange(3.0)}
    plane = tplane.as_plane(t)
    assert plane.data.dtype == torch.float32
    back = plane.to_tree()
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], t["w"])
    assert torch.equal(back["b"], t["b"])


def test_unflatten_batched_matches_per_plane():
    tree, _ = TREES["quickstart"]
    plane = tplane.ParamPlane.from_numpy(tree, device="cpu")
    stack = torch.stack([plane.data, 2 * plane.data])
    batched = plane.spec.unflatten_batched(stack)
    for g in range(2):
        single = plane.spec.unflatten(stack[g])
        for k in single:
            assert torch.equal(batched[k][g], single[k])


def test_broadcast_is_a_view_to_materialise():
    tree, _ = TREES["quickstart"]
    plane = tplane.ParamPlane.from_numpy(tree, device="cpu")
    b = plane.broadcast(3)
    assert b.batched and tuple(b.data.shape) == (3, 16, tplane.LANE)
    assert not b.data.is_contiguous()
    assert torch.equal(b.data.contiguous()[2], plane.data)
