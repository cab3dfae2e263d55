"""The gradient plane of ``FlatSpec.unflatten_batched``'s views
(``repro_torch.kernels.plane``), on the CPU.

The views write the stack's gradient once, each leaf's gradient into its
own slice as the backward produces it.  Each case holds that plane bit for
bit against the slice path it replaced, written out here: plain slices of
the plane, whose backward hands each leaf's gradient back as a zero-filled
whole plane that autograd sums.  Cases: a Nemotron-H period (Mamba-2 with
groups, the drop-free MoE, attention) at n_dpu = 2, the paper's MLP at
G = 3, a leaf the loss does not use, gradients of -0.0, a bf16 leaf, and
every local step of ``build_cefl_round_step`` at n_micro 1 and 2.  The
padding past ``spec.n`` must come out +0.0.  Then the mechanism itself:
under ``torch.profiler`` the new backward runs no plane-sized fill, zero
or add, and the round step's backward span counts one plane written."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.configs.cefl_paper import ClassifierConfig
from repro_torch.core import round_step as rs
from repro_torch.kernels import plane as P
from repro_torch.kernels.plane import ParamPlane, tree_from_paths, tree_unbind
from repro_torch.models import classifier as cls
from repro_torch.models import lm as L

torch.set_num_threads(2)


def slice_path(spec, planes):
    """The views as plain slices of the plane (the path replaced)."""
    G = planes.shape[0]
    flat = planes.reshape(G, -1)
    return tree_from_paths(spec.paths, [
        flat[:, off:off + k].reshape((G,) + shape).to(dtype)
        for shape, dtype, off, k in zip(spec.shapes, spec.dtypes,
                                        spec.offsets, spec._sizes())])


def plane_grad(unflatten, p, loss):
    leaf = p.detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(loss(unflatten(leaf)).sum(), leaf)
    return g


def bits(t):
    return t.contiguous().view(torch.int32)


def assert_bitwise(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.equal(bits(got), bits(want))


# -- the cases --------------------------------------------------------------

def nemotron_cfg():
    base = get_config("nemotron3-nano-30b-a3b")
    return dataclasses.replace(
        base, name="nemotron-h-grad-test", num_layers=7, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=48, vocab_size=128,
        layer_pattern="MEMEMAE", dtype="float32",
        moe=dataclasses.replace(base.moe, num_experts=8, top_k=3,
                                expert_ff=32, held_experts=4),
        ssm=dataclasses.replace(base.ssm, state_dim=16, head_dim=16,
                                num_heads=8, n_groups=2, chunk_size=8))


def lm_loss_fn(cfg):
    """``experiments.lm.build_lm_step``'s loss: one ``lm_loss`` with remat
    per DPU of the stack."""
    def loss_fn(p, micro, mask):
        return torch.stack([
            L.lm_loss(p_i, cfg, {k: v[i] for k, v in micro.items()},
                      example_mask=mask[i], remat=True, q_block=16,
                      kv_block=16)[0]
            for i, p_i in enumerate(tree_unbind(p))])
    return loss_fn


def nemotron_case(n=2, n_micro=1, seed=0):
    cfg = nemotron_cfg()
    tree = L.init_lm_params(torch.Generator().manual_seed(seed), cfg,
                            torch.float32)
    plane = ParamPlane.from_tree(tree)
    gen = torch.Generator().manual_seed(seed + 1)
    p = plane.broadcast(n).data + 0.01 * torch.randn(
        (n,) + tuple(plane.data.shape), generator=gen)
    p.view(n, -1)[:, plane.spec.n:] = 0.0
    rng = np.random.RandomState(seed)
    tok = torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                       (n, n_micro, 2, 16)))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, -1)}
    return plane.spec, p, lm_loss_fn(cfg), batch


MLP = ClassifierConfig(input_shape=(28, 28, 1), hidden=(200, 100))


def mlp_tree(seed=0, extra=None):
    tree = cls.init_classifier_params(torch.Generator().manual_seed(seed),
                                      MLP, "cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    tree = {k: v + 0.1 * torch.randn(v.shape, generator=gen)
            for k, v in tree.items()}
    tree.update(extra or {})
    return tree


def mlp_batch(G, n_micro=None, mb=12, seed=0):
    rng = np.random.RandomState(seed)
    lead = (G,) if n_micro is None else (G, n_micro)
    x = rng.normal(size=lead + (mb, 28, 28, 1)).astype(np.float32)
    y = rng.randint(0, 10, size=lead + (mb,))
    return {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}


def mlp_loss(batch, mask):
    def loss(params):
        used = {k: v for k, v in params.items() if k[0] in "wb"}
        return cls.classifier_loss(used, batch, mask)
    return loss


def mlp_case(G=3, extra=None):
    tree = mlp_tree(extra=extra)
    plane = ParamPlane.from_tree(tree)
    mask = (torch.arange(12)[None, :] < torch.tensor([[12], [7], [1]])[:G]
            ).float()
    return plane.spec, plane.broadcast(G).data.contiguous(), mlp_loss(
        mlp_batch(G), mask)


def case(name):
    if name == "nemotron_period":
        spec, p, loss_fn, batch = nemotron_case()
        micro = {k: v[:, 0] for k, v in batch.items()}
        mask = torch.ones((2, 2))
        return spec, p, lambda t: loss_fn(t, micro, mask)
    if name == "mlp_g3":
        return mlp_case()
    if name == "unused_leaf":
        return mlp_case(extra={"unused": torch.randn(3, 50),
                               "z_unused": torch.randn(7)})
    if name == "negative_zeros":
        c = torch.tensor([-0.0, 2.0, -0.0, 0.0, -3.0])

        def loss(t):
            return (t["a"] * c).sum(-1) + (t["b"] ** 2).sum((-2, -1))
        tree = {"a": torch.randn(5), "b": torch.randn(4, 3)}
        plane = ParamPlane.from_tree(tree)
        return plane.spec, plane.broadcast(2).data.contiguous(), loss
    if name == "bf16_leaf":
        tree = {"a": torch.randn(6, 5), "b": torch.randn(9).bfloat16(),
                "c": torch.randn(4)}

        def loss(t):
            return ((t["a"].sum(-1)[..., :4] * t["c"]).sum(-1)
                    + (t["b"].float() ** 3).sum(-1))
        plane = ParamPlane.from_tree(tree)
        return plane.spec, plane.broadcast(2).data.contiguous(), loss
    raise KeyError(name)


CASES = ["nemotron_period", "mlp_g3", "unused_leaf", "negative_zeros",
         "bf16_leaf"]


@pytest.mark.parametrize("name", CASES)
def test_plane_gradient_is_the_slice_paths_bit_for_bit(name):
    spec, p, loss = case(name)
    got = plane_grad(spec.unflatten_batched, p, loss)
    want = plane_grad(lambda x: slice_path(spec, x), p, loss)
    assert_bitwise(got, want)
    assert got.is_contiguous()
    pad = bits(got).view(p.shape[0], -1)[:, spec.n:]
    assert bool((pad == 0).all())           # +0.0, not merely equal to 0
    assert bool(got.abs().sum() > 0)


def test_nemotron_plane_holds_every_layer_kind():
    spec, _, _ = case("nemotron_period")
    names = {".".join(path) for path in spec.paths}
    for part in ("mamba", "moe", "attn"):
        assert any(part in nm for nm in names), part
    assert len(spec.paths) >= 40


def test_unused_leaves_get_zeros():
    spec, p, loss = case("unused_leaf")
    got = plane_grad(spec.unflatten_batched, p, loss)
    flat = bits(got).view(p.shape[0], -1)
    for path, off, k in zip(spec.paths, spec.offsets, spec._sizes()):
        zero = bool((flat[:, off:off + k] == 0).all())
        assert zero == path[0].endswith("unused"), path


def test_negative_zero_gradients_come_out_positive():
    spec, p, loss = case("negative_zeros")
    got = plane_grad(spec.unflatten_batched, p, loss)
    a = got.view(2, -1)[:, :5]
    assert bool((bits(a[:, [0, 2, 3]]) == 0).all())
    assert torch.equal(a[:, [1, 4]], torch.tensor([[2.0, -3.0]] * 2))


@pytest.mark.parametrize("model", ["mlp", "nemotron"])
@pytest.mark.parametrize("n_micro", [1, 2])
def test_round_step_gradients_are_the_slice_paths(model, n_micro,
                                                  monkeypatch):
    """Every local step's gradient plane, as ``fedprox_accum`` receives
    it, against the replaced recipe: zeros, plus each microbatch's slice
    path gradient, times 1 / n_micro."""
    if model == "mlp":
        spec, p0 = mlp_case()[:2]
        batch = mlp_batch(3, n_micro)
        loss_fn = cls.classifier_loss
        meta = rs.make_dpu_meta(3, gammas=[2, 1, 2], m_fracs=[1.0, 0.5, 0.7],
                                weights=[3.0, 1.0, 2.0], device="cpu")
    else:
        spec, p0, loss_fn, batch = nemotron_case(n_micro=n_micro)
        meta = rs.make_dpu_meta(2, gammas=[2, 2], device="cpu")
    step = rs.build_cefl_round_step(loss_fn, rs.CEFLHyper(
        eta=0.05, mu=0.01, gamma_max=2, n_micro=n_micro))
    seen = []
    accum = rs.ops.fedprox_accum_plane

    def record(p, g, *args):
        seen.append((p.clone(), g.clone()))
        return accum(p, g, *args)
    monkeypatch.setattr(rs.ops, "fedprox_accum_plane", record)
    step(ParamPlane(p0, spec), batch, meta)
    assert len(seen) == 2
    mb = next(iter(batch.values())).shape[2]
    mask = rs._example_mask(meta["m_frac"], mb)
    for p, g in seen:
        g_acc = torch.zeros_like(p)
        for j in range(n_micro):
            micro = {k: v[:, j] for k, v in batch.items()}
            g_acc = g_acc + plane_grad(
                lambda x: slice_path(spec, x), p,
                lambda t, micro=micro: loss_fn(t, micro, mask))
        assert_bitwise(g, g_acc * (1.0 / n_micro))


# -- the mechanism ------------------------------------------------------------

WRITES = {"aten::fill_", "aten::zero_", "aten::zeros", "aten::add_",
          "aten::add", "aten::copy_", "aten::mul", "aten::mul_"}


def plane_sized_writes(unflatten, p, loss):
    size = p.numel()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=True) as prof:
        plane_grad(unflatten, p, loss)
    return [e.name for e in prof.events() if e.name in WRITES and any(
        s and int(np.prod(s)) == size for s in e.input_shapes)]


@pytest.mark.parametrize("name", ["nemotron_period", "mlp_g3"])
def test_backward_writes_no_plane_sized_pass_per_leaf(name):
    spec, p, loss = case(name)
    new = plane_sized_writes(spec.unflatten_batched, p, loss)
    old = plane_sized_writes(lambda x: slice_path(spec, x), p, loss)
    n_leaves = len(spec.paths)
    # the slice path fills a plane per leaf and adds them up
    assert len(old) >= 2 * n_leaves - 1, old
    assert len(new) <= 1, new


def test_views_share_the_plane_and_no_grad_gives_plain_views():
    spec, p, _ = case("mlp_g3")
    leaf = p.detach().requires_grad_(True)
    base = leaf.untyped_storage().data_ptr()
    with torch.enable_grad():
        tree = spec.unflatten_batched(leaf)
    for (path, x), off in zip(P.tree_paths(tree), spec.offsets):
        assert x.untyped_storage().data_ptr() == base
        assert x.data_ptr() == leaf.data_ptr() + 4 * off
        assert x.grad_fn is not None
    with torch.no_grad():
        plain = spec.unflatten_batched(leaf)
    for (_, x), (_, y) in zip(P.tree_paths(plain),
                              P.tree_paths(slice_path(spec, p))):
        assert x.grad_fn is None and torch.equal(x, y)
        assert x.untyped_storage().data_ptr() == base


def test_a_second_backward_of_one_graph_gives_the_same_plane():
    spec, p, loss = case("mlp_g3")
    leaf = p.detach().requires_grad_(True)
    with torch.enable_grad():
        total = loss(spec.unflatten_batched(leaf)).sum()
        (g1,) = torch.autograd.grad(total, leaf, retain_graph=True)
        (g2,) = torch.autograd.grad(total, leaf)
    assert g1.data_ptr() != g2.data_ptr()
    assert_bitwise(g1, g2)


def test_gradient_reaching_the_stack_past_the_views_is_added():
    spec, p, loss = case("mlp_g3")

    def grad(unflatten):
        leaf = p.detach().requires_grad_(True)
        with torch.enable_grad():
            total = (loss(unflatten(leaf)) + 0.5 * leaf.sum()).sum()
            return torch.autograd.grad(total, leaf)[0]
    assert_bitwise(grad(spec.unflatten_batched),
                   grad(lambda x: slice_path(spec, x)))


def test_a_second_order_gradient_is_refused():
    spec, p, loss = case("mlp_g3")
    leaf = p.detach().requires_grad_(True)
    with torch.enable_grad():
        total = loss(spec.unflatten_batched(leaf)).sum()
        with pytest.raises(RuntimeError, match="out="):
            torch.autograd.grad(total, leaf, create_graph=True)


@pytest.mark.parametrize("n_micro", [1, 2])
def test_round_step_backward_counts_one_plane(n_micro):
    spec, p0 = mlp_case()[:2]
    step = rs.build_cefl_round_step(cls.classifier_loss, rs.CEFLHyper(
        gamma_max=2, n_micro=n_micro))
    meta = rs.make_dpu_meta(3, device="cpu")
    before = P.grad_plane_bytes()
    tracing.clear()
    tracing.enable()
    try:
        step(ParamPlane(p0, spec), mlp_batch(3, n_micro), meta)
    finally:
        tracing.disable()
    spans = [s for s in tracing.spans() if s.name == "round_step.backward"]
    tracing.clear()
    plane = p0.numel() * 4
    assert len(spans) == 2 * n_micro
    for s in spans:
        assert s.attrs == {"grad_plane_bytes": plane, "plane_bytes": plane}
    assert P.grad_plane_bytes() - before == 2 * n_micro * plane
