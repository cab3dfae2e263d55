"""Nemotron-H in the port (``configs/nemotron3_nano_30b_a3b.py``): Mamba-2
with grouped B and C, the drop-free sigmoid MoE over a chip's held
experts, NoPE GQA, and 'E' layers, held against the plain reference
``tests/nemotron_h_reference.py`` on seeded random weights at a small size
(2 periods of MEMEMAE, d 64, 8 experts of which 4 held, 2 groups), on the
CPU.  The grouped products' own tests are ``test_torch_grouped_mm.py``."""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import nemotron_h_reference as ref
from repro_torch import tracing
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import MoEConfig, SSMConfig
from repro_torch.core.round_step import make_dpu_meta
from repro_torch.experiments.lm import build_lm_step
from repro_torch.experiments.spec import ModelSpec
from repro_torch.kernels import grouped_mm as gmm
from repro_torch.kernels.plane import ParamPlane, tree_map
from repro_torch.models import blocks as B
from repro_torch.models import lm as L
from repro_torch.models import mamba, moe

FIXTURE = Path(__file__).parent / "fixtures" / "ssd_g1_parent.pt"


def small_cfg(held=4, offset=0):
    base = get_config("nemotron3-nano-30b-a3b")
    return dataclasses.replace(
        base, name="nemotron-h-test", num_layers=14, d_model=64,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=48, vocab_size=128,
        layer_pattern="MEMEMAE", dtype="float32",
        moe=dataclasses.replace(base.moe, num_experts=8, top_k=3,
                                expert_ff=32, held_experts=held,
                                expert_offset=offset),
        ssm=dataclasses.replace(base.ssm, state_dim=16, head_dim=16,
                                num_heads=8, n_groups=2, chunk_size=8))


def random_params(cfg, seed=0):
    """The program's init, then every leaf redrawn (norms and biases too,
    so that none is zero) at the init's scale."""
    p = L.init_lm_params(torch.Generator().manual_seed(seed), cfg,
                         torch.float32)
    gen = torch.Generator().manual_seed(seed + 1)

    def redraw(t):
        scale = float(t.std()) if t.numel() > 1 and float(t.std()) > 0 \
            else 0.1
        return torch.randn(t.shape, generator=gen) * scale
    p = tree_map(redraw, p)
    for j, spec in enumerate(B.period_spec(cfg)):
        if spec.kind != "M":
            continue
        name = f"layer_{j}"
        mp = p["blocks"][name]["mamba"]
        mp["a_log"] = torch.log(torch.rand(mp["a_log"].shape,
                                           generator=gen) * 4 + 0.5)
        mp["dt_bias"] = torch.rand(mp["dt_bias"].shape, generator=gen) - 3
    return p


def batch(cfg, b=2, S=16, seed=0):
    rng = np.random.RandomState(seed)
    tok = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, S)))
    return {"tokens": tok, "labels": torch.roll(tok, -1, -1)}


def program_logits(params, cfg, tokens):
    x = L.embed_tokens(params, cfg, tokens)
    x, _ = L.lm_backbone(params, cfg, x, remat=False)
    return L.unembed(params, cfg, x)


def test_registry_entry_at_published_size():
    cfg = get_config("nemotron3-nano-30b-a3b")
    kinds = [s.kind for s in B.period_spec(cfg)]
    assert (kinds.count("M"), kinds.count("E"), kinds.count("A")) == \
        (23, 23, 6)
    assert B.num_periods(cfg) == 1 and not cfg.rope
    assert cfg.ssm.dims(cfg.d_model) == (4096, 64, 6144)
    assert abs(cfg.param_count() / 1e9 - 31.58) < 0.01
    r = reduced(cfg)
    assert r.layer_pattern == "MAE" and r.ssm.n_groups == 2
    assert r.moe.held == r.moe.num_experts


def test_logits_loss_and_grads_match_the_reference():
    cfg = small_cfg()
    p = random_params(cfg)
    bt = batch(cfg)
    torch.testing.assert_close(program_logits(p, cfg, bt["tokens"]),
                               ref.logits(p, bt["tokens"], cfg),
                               rtol=1e-4, atol=1e-4)
    names, vals = zip(*ref.leaves(p))
    leaves = [v.clone().requires_grad_(True) for v in vals]
    tree = ref.rebuild(names, leaves)
    got, _ = L.lm_loss(tree, cfg, bt, remat=True)
    want = ref.loss(tree, bt, cfg)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    g = torch.autograd.grad(got, leaves)
    h = torch.autograd.grad(want, leaves)
    for name, x, y in zip(names, g, h):
        scale = float(y.abs().max()) + 1e-12
        assert float((x - y).abs().max()) / scale < 1e-3, name


def test_one_round_matches_the_reference_round():
    cfg = small_cfg()
    p0 = random_params(cfg, seed=3)
    spec = ModelSpec(kind="lm", arch=cfg.name, reduced=False, batch=4,
                     seq=16, n_dpu=2, n_micro=1, gamma=2)
    step = build_lm_step(cfg, spec, eta=0.05, mu=0.01)
    rng = np.random.RandomState(5)
    tok = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 1, 2, 16)))
    bt = {"tokens": tok, "labels": torch.roll(tok, -1, -1)}
    plane = ParamPlane.from_tree(p0)
    params = plane.with_data(plane.broadcast(2).data.contiguous())
    meta = make_dpu_meta(2, gammas=[2, 2], device="cpu")
    new, metrics = step(params, bt, meta)
    want, want_loss = ref.cefl_round(p0, bt, cfg, gamma=2, eta=0.05,
                                     mu=0.01)
    assert abs(float(metrics["loss"]) - want_loss) < 1e-5 * abs(want_loss)
    got = new.with_data(new.data[1]).to_tree()
    for (name, x), (_, y), (_, x0) in zip(ref.leaves(got), ref.leaves(want),
                                          ref.leaves(p0)):
        change = float((y - x0).abs().max()) + 1e-12
        assert float((x - y).abs().max()) / change < 2e-3, name


def test_expert_shares_add_up_to_the_whole_layer():
    """Four chips holding 2 experts each, plus the shared expert once,
    give the uncut layer."""
    whole = small_cfg(held=8)
    p = random_params(whole, seed=7)
    lp = ref._index(p["blocks"]["layer_1"], 0)
    h = torch.randn((2, 16, 64), generator=torch.Generator().manual_seed(1))
    want = ref.moe_layer(lp, h, whole)
    parts = torch.zeros_like(h)
    for chip in range(4):
        m = dataclasses.replace(whole.moe, held_experts=2,
                                expert_offset=2 * chip)
        share = {"router": lp["moe"]["router"],
                 "w_in": lp["moe"]["w_in"][2 * chip:2 * chip + 2],
                 "w_out": lp["moe"]["w_out"][2 * chip:2 * chip + 2]}
        parts = parts + moe.dropless_forward(share, h, m)
    parts = parts + B.mlp_forward(lp["mlp"], h, whole)
    torch.testing.assert_close(parts, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_ssd_with_groups_matches_the_reference(groups):
    cfg = dataclasses.replace(small_cfg(), ssm=dataclasses.replace(
        small_cfg().ssm, n_groups=groups))
    p = random_params(cfg, seed=11)
    mp = ref._index(p["blocks"]["layer_0"]["mamba"], 0)
    h = torch.randn((2, 24, 64), generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(mamba.ssd_forward(mp, h, cfg.ssm),
                               ref.mamba_mixer(mp, h, cfg),
                               rtol=1e-4, atol=1e-4)


def test_ssd_one_group_is_bit_identical_to_before():
    """The ungrouped SSD gives the bits it gave before groups existed
    (outputs, final state and gradients stored from that code)."""
    s = SSMConfig(state_dim=16, head_dim=16, expand=2, chunk_size=8)
    f = torch.load(FIXTURE)
    p = {k: v.clone().requires_grad_(True) for k, v in f["params"].items()}
    y, st = mamba.ssd_forward(p, f["x"], s, return_state=True)
    assert torch.equal(y, f["y"]) and torch.equal(st["h"], f["h"])
    assert torch.equal(st["conv"], f["conv"])
    w = torch.linspace(-1, 1, y.numel()).reshape(y.shape)
    g = torch.autograd.grad((y * w).sum(), list(p.values()))
    for k, x in zip(p, g):
        assert torch.equal(x, f["grads"][k]), k


def test_prefill_and_decode_match_the_full_forward():
    cfg = small_cfg()
    p = random_params(cfg, seed=13)
    tok = batch(cfg, b=2, S=24, seed=4)["tokens"]
    full = ref.logits(p, tok, cfg)
    with torch.no_grad():
        first, cache = L.prefill(p, cfg, tok[:, :16], 24)
        torch.testing.assert_close(first, full[:, 15], rtol=1e-4,
                                   atol=1e-4)
        for t in range(16, 24):
            lg, cache = L.lm_decode_step(p, cfg, tok[:, t], cache)
            torch.testing.assert_close(lg, full[:, t], rtol=1e-4,
                                       atol=1e-4)


def test_traced_round_counts_the_held_pairs():
    cfg = small_cfg()
    p0 = random_params(cfg, seed=17)
    spec = ModelSpec(kind="lm", arch=cfg.name, reduced=False, batch=4,
                     seq=16, n_dpu=2, n_micro=1, gamma=1)
    step = build_lm_step(cfg, spec, eta=0.05, mu=0.01)
    tok = batch(cfg, b=4, S=16, seed=6)["tokens"].reshape(2, 1, 2, 16)
    bt = {"tokens": tok, "labels": torch.roll(tok, -1, -1)}
    plane = ParamPlane.from_tree(p0)
    params = plane.with_data(plane.broadcast(2).data.contiguous())
    tracing.clear()
    tracing.enable()
    try:
        step(params, bt, make_dpu_meta(2, device="cpu"))
    finally:
        tracing.disable()
    spans = tracing.spans()
    names = {s.name for s in spans}
    assert {"moe.route", "moe.experts", "mamba.ssd", "moe.counts"} <= names
    counts = [s for s in spans if s.name == "moe.counts"]
    assert len(counts) == 1
    want = 0
    for i in range(2):
        x = L.embed_tokens(p0, cfg, tok[i, 0])
        for j, spec_j in enumerate(B.period_spec(cfg) * 2):
            lp = ref._index(p0["blocks"][f"layer_{j % 7}"], j // 7)
            if spec_j.kind == "E":
                h = ref.rms(x, lp["ln1"], cfg.norm_eps).reshape(-1, 64)
                ids = moe.dropless_route(lp["moe"]["router"], h,
                                         cfg.moe).ids
                want += int((ids < 4).sum())
            x, _, _, _ = B.layer_forward(lp, x, cfg, spec_j, angles=None)
    a = counts[0].attrs
    assert a["moe_pairs_held"] == want and a["moe_dropped"] == 0
    assert a["moe_load_max"] >= 1.0
    tracing.clear()


def test_drop_free_layer_takes_relu2_experts():
    with pytest.raises(ValueError, match="relu"):
        MoEConfig(num_experts=8, top_k=2, expert_ff=16, dropless=True)


def test_a_pair_left_uncomputed_reads_as_dropped(monkeypatch):
    """``moe_dropped`` holds the router's pairs to held experts against
    the rows the up product counted as it wrote them: a product that
    leaves the last held expert's segment out reads its pairs dropped."""
    m = small_cfg().moe
    p = moe.init_moe_params(torch.Generator().manual_seed(3), 64, m,
                            torch.float32)
    h = torch.randn((2, 40, 64), generator=torch.Generator().manual_seed(4))
    real = gmm.grouped_mm

    def lossy(a, w, offsets, rows=None, written=None):
        cut = offsets.clone()
        cut[-1] = cut[-2]
        return real(a, w, cut, rows, written)

    monkeypatch.setattr(gmm, "grouped_mm", lossy)
    tracing.clear()
    tracing.enable()
    try:
        moe.dropless_forward(p, h, m)
        moe.flush_counts()
    finally:
        tracing.disable()
    c = [s for s in tracing.spans() if s.name == "moe.counts"][0].attrs
    tracing.clear()
    ids = moe.dropless_route(p["router"], h.reshape(-1, 64), m).ids
    last = int((ids == m.expert_offset + m.held - 1).sum())
    assert last > 0 and c["moe_dropped"] == last
    assert c["moe_pairs_held"] == int((ids < m.held).sum()) - last


def test_run_lm_trains_the_reduced_model():
    """The registry entry trains through the port's front door
    (``run_lm``, which raises unless the loss falls)."""
    from repro_torch.experiments.lm import run_lm
    from repro_torch.experiments.spec import get_experiment
    s = get_experiment("lm_smoke")
    s = dataclasses.replace(
        s, model=dataclasses.replace(s.model, arch="nemotron3-nano-30b-a3b",
                                     batch=4, seq=32),
        engine=dataclasses.replace(s.engine, rounds=4))
    result = run_lm(s, device="cpu", verbose=False)
    assert len(result.reports) == 4
