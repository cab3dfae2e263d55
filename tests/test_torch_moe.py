"""The port's MoE (``repro_torch.models.moe``) against the JAX package's
``repro.models.moe``, on the same numpy-seeded inputs and the JAX
parameters carried across.

The routing (top-k expert ids, each pair's queue position, the
capacity-kept mask) is held EXACTLY equal to the reference's first, ties
included; values are compared only after that.

Tolerances, with their reasons:
- float32 output and aux terms: 2e-5 absolute (the bound
  ``tests/test_moe_and_data.py`` holds the reference's drop-free form
  to; outputs of order 1, the expert products summed over d in XLA's and
  torch's CPU orders; measured about 2e-7);
- bfloat16 output: one bf16 ulp of the result plus the f32 bound (both
  packages round each expert product to bf16; XLA's CPU dot and torch's
  may round a sum on either side).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoE
from repro.models import moe as jmoe
from repro_torch.configs.base import MoEConfig as TMoE
from repro_torch.models import moe as tmoe

torch.set_num_threads(2)

ATOL = 2e-5


def _configs(**kw):
    return JMoE(**kw), TMoE(**kw)


def _params(m, d, dtype=jnp.float32, seed=0, zero_router=False):
    p = jmoe.init_moe_params(jax.random.PRNGKey(seed), d, m, dtype)
    if zero_router:
        p["router"] = jnp.zeros_like(p["router"])
    tp = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.float32 if k == "router" or dtype == jnp.float32
        else torch.bfloat16) for k, v in p.items()}
    return p, tp


def _jax_routing(p, x, m, group_size, C):
    """The reference's routing, by its own lines (moe.py:61-72): top-k ids
    and each pair's queue position, token-major over the (T * k) pairs."""
    B, S, d = x.shape
    T = B * S
    group_size = min(group_size, T)
    G = T // group_size
    xg = x.reshape(G, group_size, d)
    logits = jnp.einsum("gtd,de->gte", xg.astype(jnp.float32), p["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    _, ids = jax.lax.top_k(probs, m.top_k)
    onehot = jax.nn.one_hot(ids, m.num_experts, dtype=jnp.float32)
    flat = onehot.reshape(G, group_size * m.top_k, m.num_experts)
    pos = jnp.cumsum(flat, axis=1) - flat
    pair_pos = jnp.sum(pos * flat, -1).reshape(G, group_size, m.top_k)
    return np.asarray(ids), np.asarray(pair_pos).astype(np.int64), \
        np.asarray(pair_pos < C)


def _check_routing(p, tp, x, m, tm, group_size, capacity):
    """Routing equal to the reference's, exactly; returns the port's."""
    B, S, d = x.shape
    gs = min(group_size, B * S)
    C = capacity if capacity is not None else tmoe.moe_capacity(gs, tm)
    assert C == (capacity if capacity is not None
                 else jmoe.moe_capacity(gs, m))
    ids, pos, kept = _jax_routing(p, jnp.asarray(x), m, group_size, C)
    r = tmoe.moe_route(tp["router"],
                       torch.from_numpy(x).reshape(-1, gs, d), tm, C)
    np.testing.assert_array_equal(r["expert_ids"].numpy(), ids)
    np.testing.assert_array_equal(r["position"].numpy(), pos)
    np.testing.assert_array_equal(r["kept"].numpy(), kept)
    return r


CASES = [  # (E, k, d, ff, capacity factor, B, S, group_size, capacity)
    (4, 2, 16, 32, 1.25, 2, 16, 1024, None),     # one group, drops
    (4, 2, 16, 32, 1.0, 2, 16, 8, None),         # 4 groups of 8
    (8, 1, 24, 16, 1.25, 3, 8, 1024, None),      # top-1 (llama4)
    (8, 2, 16, 32, 0.5, 2, 32, 16, None),        # heavy drops
    (4, 2, 16, 32, 1.25, 4, 1, 4, 4),            # the decode form
    (16, 2, 32, 24, 1.25, 1, 64, 1024, None),    # jamba's E and k
]


@pytest.mark.parametrize("E,k,d,ff,cf,B,S,gs,cap", CASES)
def test_moe_forward_matches_repro(E, k, d, ff, cf, B, S, gs, cap):
    m, tm = _configs(num_experts=E, top_k=k, expert_ff=ff,
                     capacity_factor=cf)
    p, tp = _params(m, d)
    x = np.random.RandomState(E + k + S).normal(size=(B, S, d)).astype(
        np.float32)
    _check_routing(p, tp, x, m, tm, gs, cap)
    y, aux = jmoe.moe_forward(p, jnp.asarray(x), m, group_size=gs,
                              capacity=cap)
    ty, taux = tmoe.moe_forward(tp, torch.from_numpy(x), tm, group_size=gs,
                                capacity=cap)
    assert ty.shape == (B, S, d) and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), atol=ATOL)
    for key in ("load_balance", "router_z"):
        assert taux[key].dtype == torch.float32 and taux[key].dim() == 0
        np.testing.assert_allclose(float(taux[key]), float(aux[key]),
                                   atol=ATOL)


def test_moe_forward_bf16_matches_repro():
    """A bf16 model: the f32 router, gates rounded to bf16 in combine."""
    m, tm = _configs(num_experts=4, top_k=2, expert_ff=32)
    p, tp = _params(m, 16, jnp.bfloat16)
    assert tp["router"].dtype == torch.float32
    assert tp["w_in"].dtype == torch.bfloat16
    x = np.random.RandomState(5).normal(size=(2, 16, 16)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(
        torch.bfloat16)
    _check_routing(p, tp, np.array(xb.astype(jnp.float32)), m, tm, 1024,
                   None)
    y, _ = jmoe.moe_forward(p, xb, m)
    ty, _ = tmoe.moe_forward(tp, xt, tm)
    assert ty.dtype == torch.bfloat16
    g = ty.float().numpy()
    w = np.asarray(y.astype(jnp.float32))
    _, e = np.frexp(np.maximum(np.abs(g), np.abs(w)))
    assert np.all(np.abs(g - w) <= np.ldexp(1.0, e - 8) + ATOL)


@pytest.mark.parametrize("k", [1, 2])
def test_zero_router_ties_pick_the_lowest_experts(k):
    """A zero router: every prob ties, so every token picks experts
    0..k-1 (``jax.lax.top_k``'s order), queues overflow past the
    capacity, and the port matches the reference value for value."""
    m, tm = _configs(num_experts=4, top_k=k, expert_ff=32)
    p, tp = _params(m, 16, zero_router=True)
    x = np.random.RandomState(6).normal(size=(2, 16, 16)).astype(np.float32)
    r = _check_routing(p, tp, x, m, tm, 1024, None)
    assert (r["expert_ids"] == torch.arange(k)).all()
    C = tmoe.moe_capacity(32, tm)
    assert int(r["kept"].sum()) == k * C < 32 * k
    y, aux = jmoe.moe_forward(p, jnp.asarray(x), m)
    ty, taux = tmoe.moe_forward(tp, torch.from_numpy(x), tm)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), atol=ATOL)
    np.testing.assert_allclose(float(taux["load_balance"]),
                               float(aux["load_balance"]), atol=ATOL)


def test_overflowing_positions_give_zero_rows():
    """Top-1 with a zero router: token t sits at position t of expert 0's
    queue; tokens at positions >= C are dropped and their output row is
    exactly zero (``jax.nn.one_hot`` of an out-of-range position)."""
    m, tm = _configs(num_experts=4, top_k=1, expert_ff=32)
    p, tp = _params(m, 16, zero_router=True)
    x = np.random.RandomState(7).normal(size=(1, 32, 16)).astype(np.float32)
    C = tmoe.moe_capacity(32, tm)
    ty, _ = tmoe.moe_forward(tp, torch.from_numpy(x), tm)
    assert (ty[0, C:] == 0).all()
    assert (ty[0, :C].abs().amax(dim=-1) > 0).all()
    y, _ = jmoe.moe_forward(p, jnp.asarray(x), m)
    np.testing.assert_array_equal(np.asarray(y)[0, C:], 0.0)


def test_moe_dropfree_equals_dense_topk():
    """Drop-free (capacity = group size): the output is the gate-weighted
    sum of the top-k experts' outputs (``tests/test_moe_and_data.py``'s
    first check, on the port)."""
    m, tm = _configs(num_experts=4, top_k=2, expert_ff=32,
                     capacity_factor=2.0)
    _, tp = _params(m, 16)
    x = torch.from_numpy(np.random.RandomState(8).normal(
        size=(2, 8, 16)).astype(np.float32) * 0.5)
    y, _ = tmoe.moe_forward(tp, x, tm, group_size=16, capacity=16)
    probs = torch.softmax(x @ tp["router"], -1)
    gate, ids = torch.topk(probs, 2)
    gate = gate / gate.sum(-1, keepdim=True)
    h = torch.einsum("btd,edf->btef", x, tp["w_in"])
    g = torch.einsum("btd,edf->btef", x, tp["w_gate"])
    ye = torch.einsum("btef,efd->bted", torch.nn.functional.silu(g) * h,
                      tp["w_out"])
    dense = sum(gate[..., j, None] * torch.gather(
        ye, 2, ids[..., j, None, None].expand(-1, -1, 1, 16))[:, :, 0]
        for j in range(2))
    np.testing.assert_allclose(y.numpy(), dense.numpy(), atol=ATOL)


def test_moe_capacity_drops_tokens_and_aux_bounds():
    m, tm = _configs(num_experts=4, top_k=2, expert_ff=32,
                     capacity_factor=0.3)
    _, tp = _params(m, 16)
    x = torch.from_numpy(np.random.RandomState(9).normal(
        size=(2, 16, 16)).astype(np.float32))
    y_small, aux = tmoe.moe_forward(tp, x, tm, group_size=32)
    y_free, _ = tmoe.moe_forward(tp, x, tm, group_size=32, capacity=32)
    assert float((y_small - y_free).abs().max()) > 1e-6
    _, aux = tmoe.moe_forward(tp, torch.cat([x, x], 1), tm, group_size=64)
    assert float(aux["load_balance"]) >= 1.0 - 1e-3   # >= 1 at uniformity
    assert float(aux["router_z"]) >= 0


def test_capacity_formula_and_group_refusal():
    m, tm = _configs(num_experts=8, top_k=2, expert_ff=4,
                     capacity_factor=1.25)
    for n in (1, 7, 64, 256, 1024):
        assert tmoe.moe_capacity(n, tm) == jmoe.moe_capacity(n, m)
    assert tmoe.moe_capacity(256, tm) == int(256 * 2 * 1.25 / 8)
    _, tp = _params(m, 8)
    with pytest.raises(ValueError, match="MoE groups"):
        tmoe.moe_forward(tp, torch.zeros((3, 5, 8)), tm, group_size=4)


def test_init_moe_params_shapes_and_scales():
    """The tree and dtypes of the reference's init (the router f32 in a
    bf16 model), and draws of N(0, 1/fan_in)."""
    m, tm = _configs(num_experts=4, top_k=2, expert_ff=64)
    want = jmoe.init_moe_params(jax.random.PRNGKey(0), 128, m, jnp.bfloat16)
    got = tmoe.init_moe_params(torch.Generator().manual_seed(0), 128, tm,
                               torch.bfloat16)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape
        assert str(got[name].dtype).split(".")[-1] == str(w.dtype)
    for name, fan_in in (("router", 128), ("w_in", 128), ("w_out", 64)):
        std = float(got[name].float().std()) * np.sqrt(fan_in)
        assert abs(std - 1.0) < 0.05, (name, std)
