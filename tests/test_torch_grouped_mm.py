"""The grouped products of the drop-free MoE (``kernels/grouped_mm.py``).

On the CPU the plain version is held against a per-expert loop, forward
and backward.  On a card (tests marked ``card``, skipped without one) the
CUDA kernels (``csrc/grouped_mm.cu``) are held against the plain version
on the same data, at the Nemotron-H cell's shapes and at shapes that take
the kernels' scalar loads, empty segments and one heavily loaded expert,
and
an expert layer's forward and backward run under
``torch.cuda.set_sync_debug_mode("error")``: nothing in the layer reads
the device on the host.

This file imports no JAX, so the card tests run where JAX is absent:
``python3 -m pytest --noconftest -o addopts= -p no:cacheprovider
tests/test_torch_grouped_mm.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels import grouped_mm as gmm
from repro_torch.models import moe


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _segments(rng, T, k, E, held, p=None):
    """A routing's sorted pairs: (offsets, rows, inv) of T tokens' k
    distinct experts of E (drawn with probabilities p), experts
    0..held-1 held."""
    ids = np.stack([rng.choice(E, k, replace=False, p=p) for _ in range(T)])
    key = np.where(ids < held, ids, held).reshape(-1)
    order = np.argsort(key, kind="stable")
    offsets = np.searchsorted(key[order], np.arange(held + 1))
    inv = np.empty_like(order)
    inv[order] = np.arange(T * k)
    return (torch.from_numpy(offsets).long(),
            torch.from_numpy(order // k).long(),
            torch.from_numpy(inv.reshape(T, k)).long())


def _loop(a, w, offsets, rows):
    """The products one expert at a time, pairs in sorted order."""
    out = torch.zeros((rows.numel(), w.shape[2]), dtype=a.dtype)
    o = offsets.tolist()
    for e in range(w.shape[0]):
        for r in range(o[e], o[e + 1]):
            out[r] = a[rows[r]] @ w[e]
    return out


@pytest.mark.parametrize("T,k,E,held,K,N", [(12, 2, 8, 4, 16, 24),
                                            (40, 6, 16, 3, 32, 8),
                                            (7, 3, 4, 4, 5, 9)])
def test_plain_version_matches_the_loop(T, k, E, held, K, N):
    rng = np.random.RandomState(T + K)
    offsets, rows, inv = _segments(rng, T, k, E, held)
    a = torch.from_numpy(rng.randn(T, K)).requires_grad_(True)
    w = torch.from_numpy(rng.randn(held, K, N)).requires_grad_(True)
    got = gmm.grouped_matmul(a, w, offsets, rows, inv)
    want = _loop(a, w, offsets, rows)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert torch.all(got[int(offsets[-1]):] == 0)
    ct = torch.from_numpy(rng.randn(*got.shape))
    g = torch.autograd.grad((got * ct).sum(), (a, w))
    h = torch.autograd.grad((want * ct).sum(), (a, w))
    for x, y in zip(g, h):
        torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-12)


def test_second_product_without_rows():
    """The down product reads its own rows in order (no gather)."""
    rng = np.random.RandomState(3)
    offsets, _, _ = _segments(rng, 10, 2, 6, 3)
    P = 20
    a = torch.from_numpy(rng.randn(P, 7)).requires_grad_(True)
    w = torch.from_numpy(rng.randn(3, 7, 5)).requires_grad_(True)
    got = gmm.grouped_matmul(a, w, offsets)
    want = _loop(a, w, offsets, torch.arange(P))
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    ct = torch.from_numpy(rng.randn(P, 5))
    g = torch.autograd.grad((got * ct).sum(), (a, w))
    h = torch.autograd.grad((want * ct).sum(), (a, w))
    for x, y in zip(g, h):
        torch.testing.assert_close(x, y, rtol=1e-12, atol=1e-12)


def test_plain_version_counts_the_rows_it_writes():
    rng = np.random.RandomState(5)
    offsets, rows, _ = _segments(rng, 30, 3, 8, 5)
    written = torch.zeros((), dtype=torch.int64)
    gmm.grouped_mm(torch.randn(30, 4), torch.randn(5, 4, 3), offsets, rows,
                   written)
    assert int(written) == int(offsets[-1]) > 0
    with pytest.raises(TypeError):
        gmm.grouped_mm(torch.randn(30, 4), torch.randn(5, 4, 3), offsets,
                       rows, torch.zeros(1, dtype=torch.int32))


def test_cpu_counts_no_launch():
    rng = np.random.RandomState(0)
    offsets, rows, inv = _segments(rng, 6, 2, 4, 2)
    before = dict(gmm.LAUNCHES)
    gmm.grouped_mm(torch.randn(6, 4), torch.randn(2, 4, 3), offsets, rows)
    assert gmm.LAUNCHES == before


def test_refuses_mixed_dtypes_and_wrong_offsets():
    a, w = torch.randn(4, 3), torch.randn(2, 3, 5, dtype=torch.float64)
    with pytest.raises(TypeError):
        gmm.grouped_mm(a, w, torch.tensor([0, 1, 2]))
    with pytest.raises(TypeError):
        gmm.grouped_mm(a, w.float(), torch.tensor([0, 1, 2],
                                                  dtype=torch.int32))
    with pytest.raises(ValueError):
        gmm.grouped_mm(a, w.float(), torch.tensor([0, 1]))


# ----------------------------------------------------------------- card

NANO = dict(T=8192, k=6, E=128, held=16, d=2688, f=1856)
SHAPES = {
    "nano": NANO,
    "small": dict(T=300, k=6, E=32, held=8, d=100, f=72),
    # widths not a multiple of 4: the kernels' scalar loads and stores
    "odd": dict(T=257, k=3, E=12, held=5, d=97, f=70),
    # expert 1 takes most pairs (many 128-pair tiles), experts 3 and 5 none
    "skewed": dict(T=2000, k=2, E=8, held=6, d=64, f=136,
                   p=[.05, .6, .05, 0, .1, 0, .1, .1]),
}


@pytest.mark.card
@pytest.mark.parametrize("shape", list(SHAPES))
def test_kernels_match_the_plain_version(card, shape):
    s = SHAPES[shape]
    rng = np.random.RandomState(1)
    offsets, rows, inv = _segments(rng, s["T"], s["k"], s["E"], s["held"],
                                   s.get("p"))
    a = torch.from_numpy(rng.randn(s["T"], s["d"]).astype(np.float32))
    w = torch.from_numpy(rng.randn(s["held"], s["d"], s["f"])
                         .astype(np.float32)) / s["d"] ** 0.5
    ct = torch.from_numpy(rng.randn(rows.numel(), s["f"]).astype(np.float32))
    want, wgrads = [], []
    for dev in (torch.device("cpu"), card):
        aa = a.to(dev).requires_grad_(True)
        ww = w.to(dev).requires_grad_(True)
        out = gmm.grouped_matmul(aa, ww, offsets.to(dev), rows.to(dev),
                                 inv.to(dev))
        ga, gw = torch.autograd.grad((out * ct.to(dev)).sum(), (aa, ww))
        want.append(out.cpu())
        wgrads.append((ga.cpu(), gw.cpu()))
    # f32 sums of d (forward, wgrad over a segment's rows) or f (dgrad)
    # products in another order: a few ulps of the row's magnitude
    torch.testing.assert_close(want[1], want[0], rtol=2e-5, atol=2e-5)
    for x, y in zip(wgrads[1], wgrads[0]):
        torch.testing.assert_close(x, y, rtol=2e-5, atol=2e-4)
    # the kernel counts every row it writes, once
    written = torch.zeros((), dtype=torch.int64, device=card)
    gmm.grouped_mm(a.to(card), w.to(card), offsets.to(card), rows.to(card),
                   written)
    assert int(written) == int(offsets[-1])


@pytest.mark.card
@pytest.mark.filterwarnings("ignore:Synchronization debug mode")
def test_expert_layer_reads_nothing_on_the_host(card):
    m = MoEConfig(num_experts=128, top_k=6, expert_ff=1856,
                  shared_expert=True, expert_act="relu2", dropless=True,
                  routed_scale=2.5, held_experts=16)
    gen = torch.Generator(device=card).manual_seed(0)
    p = moe.init_moe_params(gen, 2688, m, torch.float32)
    for t in p.values():
        t.requires_grad_(True)
    x = torch.randn((2, 4096, 2688), device=card, requires_grad=True)
    y = moe.dropless_forward(p, x, m)          # compiles the kernels
    torch.autograd.grad(y.sum(), [x] + list(p.values()))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = moe.dropless_forward(p, x, m)
        grads = torch.autograd.grad(y.square().sum(),
                                    [x] + list(p.values()))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.card
def test_share_offset_routes_the_same_pairs(card):
    """A chip holding experts 16-31 computes the pairs routed there."""
    m = MoEConfig(num_experts=64, top_k=4, expert_ff=48, dropless=True,
                  expert_act="relu2", routed_scale=2.5,
                  held_experts=16, expert_offset=16)
    h = torch.randn((500, 40), device=card)
    router = torch.randn((40, 64), device=card)
    offsets = moe.dropless_route(router, h, m).offsets
    _, ids = torch.topk(torch.sigmoid(h @ router), 4, dim=-1)
    assert int(offsets[-1]) == int(((ids >= 16) & (ids < 32)).sum())
    m1 = dataclasses.replace(m, expert_offset=0)
    assert int(moe.dropless_route(router, h, m1).offsets[-1]) == \
        int((ids < 16).sum())
