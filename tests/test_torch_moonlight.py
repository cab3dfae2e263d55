"""Moonlight-16B-A3B in the port (``configs/moonlight_16b_a3b.py``): latent
attention (MLA) with a 192/128 head split and decoupled RoPE, a leading
dense SwiGLU layer, and SwiGLU experts on the drop-free grouped path,
held against the plain reference ``tests/moonlight_reference.py`` on
seeded random weights at a small size (one dense layer and two MoE
layers, d 64, 8 experts of which 4 held), on the CPU.  The JAX package
has no MLA, so nothing here has a JAX counterpart.

Tolerances, with their reasons: logits and layer outputs 1e-4 (f32; the
program's blocked online softmax and grouped products sum in other
orders than the reference's full softmax and boolean gathers); the loss
1e-5 relative; gradients 1e-3 of each leaf's largest entry (the flash
backward recomputes the probabilities per tile); a round's change 2e-3
of the leaf's largest change, as the Nemotron-H tests hold theirs."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

import moonlight_reference as ref
from repro_torch import tracing
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import MLAConfig
from repro_torch.core.round_step import make_dpu_meta
from repro_torch.experiments.lm import build_lm_step
from repro_torch.experiments.spec import ModelSpec
from repro_torch.kernels.plane import ParamPlane, tree_map
from repro_torch.models import attention as attn
from repro_torch.models import blocks as B
from repro_torch.models import lm as L
from repro_torch.models import moe
from nemotron_h_reference import _index, leaves, rebuild, rms


def small_cfg(held=4, offset=0, layers=3):
    base = get_config("moonlight-16b-a3b")
    return dataclasses.replace(
        base, name="moonlight-test", num_layers=layers, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=24, d_ff=96, vocab_size=128,
        dtype="float32",
        mla=MLAConfig(kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=12),
        moe=dataclasses.replace(base.moe, num_experts=8, top_k=3,
                                expert_ff=32, held_experts=held,
                                expert_offset=offset, shared_ff=48))


def random_params(cfg, seed=0):
    """The program's init, then every leaf redrawn (norms too, so that
    none is zero) at the init's scale."""
    p = L.init_lm_params(torch.Generator().manual_seed(seed), cfg,
                         torch.float32)
    gen = torch.Generator().manual_seed(seed + 1)

    def redraw(t):
        scale = float(t.std()) if t.numel() > 1 and float(t.std()) > 0 \
            else 0.1
        return torch.randn(t.shape, generator=gen) * scale
    return tree_map(redraw, p)


def batch(cfg, b=2, S=16, seed=0):
    rng = np.random.RandomState(seed)
    tok = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, S)))
    return {"tokens": tok, "labels": torch.roll(tok, -1, -1)}


def program_logits(params, cfg, tokens):
    x = L.embed_tokens(params, cfg, tokens)
    x, _ = L.lm_backbone(params, cfg, x, remat=False)
    return L.unembed(params, cfg, x)


def test_registry_entry_at_published_size():
    cfg = get_config("moonlight-16b-a3b")
    assert get_config("moonlight_16b_a3b") == cfg
    assert cfg.mla.qk_head_dim == 192 and cfg.mla.v_head_dim == 128
    assert cfg.first_dense == 1 and B.num_periods(cfg) == 26
    assert [(s.kind, s.use_moe) for s in B.period_spec(cfg)] == [("A", True)]
    assert not cfg.layer_uses_moe(0) and cfg.layer_uses_moe(26)
    assert abs(cfg.param_count() / 1e9 - 15.96) < 0.005
    assert abs(cfg.active_param_count() / 1e9 - 2.91) < 0.01
    r = reduced(cfg)
    assert r.first_dense == 1 and r.num_layers == 2 and r.mla is not None
    assert r.moe.dropless and r.moe.expert_act == "swiglu"


def test_the_layer_counts_add_up():
    """param_count by hand: the embedding and head, the dense layer, 26
    MoE layers of 64 SwiGLU experts, a shared expert of 2,816 and the
    router, MLA in every layer, two norms a layer (the final norm is not
    counted, as for every config)."""
    d, H = 2048, 16
    mla = d * H * 192 + d * 576 + 512 + 512 * H * 256 + H * 128 * d
    dense = mla + 3 * d * 11264 + 2 * d
    moe_layer = mla + 64 * 3 * d * 1408 + d * 64 + 3 * d * 2816 + 2 * d
    want = 2 * 163840 * d + dense + 26 * moe_layer
    cfg = get_config("moonlight-16b-a3b")
    assert cfg.param_count() == want
    assert cfg.active_param_count() == cfg.param_count() \
        - 26 * 58 * 3 * d * 1408


def _naive(q, k, v, causal):
    s = torch.einsum("bshd,bthd->bhst", q,
                     k.repeat_interleave(q.shape[2] // k.shape[2], 2)) \
        / math.sqrt(q.shape[-1])
    if causal:
        S = q.shape[1]
        s = s.masked_fill(~torch.ones(S, k.shape[1], dtype=torch.bool)
                          .tril(), -torch.inf)
    return torch.einsum("bhst,bthd->bshd", torch.softmax(s, -1),
                        v.repeat_interleave(q.shape[2] // v.shape[2], 2))


# (B, S, Hq, Hkv, D, Dv, causal, block)
SPLITS = {"mla-192-128": (1, 48, 2, 2, 192, 128, True, 16),
          "mla-small-gqa": (2, 40, 4, 2, 24, 12, True, 8),
          "wider-v": (2, 24, 2, 1, 16, 40, True, 8),
          "bidirectional": (1, 36, 3, 3, 32, 8, False, 12)}


@pytest.mark.parametrize("case", sorted(SPLITS))
def test_blocked_attention_with_its_own_value_dim(case):
    """Forward and the flash backward with v's head dim apart from q's and
    k's, against autograd through a naive softmax scaled by 1/sqrt(D)."""
    Bb, S, Hq, Hkv, D, Dv, causal, blk = SPLITS[case]
    g = torch.Generator().manual_seed(len(case))
    q, k = (torch.randn((Bb, S, h, D), generator=g) for h in (Hq, Hkv))
    v = torch.randn((Bb, S, Hkv, Dv), generator=g)
    w = torch.randn((Bb, S, Hq, Dv), generator=g)
    leaves_ = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = attn.blocked_attention(*leaves_, causal=causal, q_block=blk,
                                 kv_block=blk)
    assert out.shape == (Bb, S, Hq, Dv)
    got = torch.autograd.grad((out * w).sum(), leaves_)
    naive = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want_out = _naive(*naive, causal)
    want = torch.autograd.grad((want_out * w).sum(), naive)
    torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-5)
    for name, x, y in zip("qkv", got, want):
        assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max()), \
            name


def test_mla_matches_the_reference():
    cfg = small_cfg()
    p = random_params(cfg, seed=2)
    ap = _index(p["blocks"]["layer_0"]["attn"], 1)
    h = torch.randn((2, 24, 64), generator=torch.Generator().manual_seed(3))
    angles = L._angles(cfg, 24, h.device)
    got = B.mla_forward(ap, h, cfg, angles=angles, q_block=8, kv_block=8)
    torch.testing.assert_close(got, ref.mla(ap, h, cfg), rtol=1e-4,
                               atol=1e-4)


def test_swiglu_drop_free_layer_matches_a_per_expert_loop():
    cfg = small_cfg()
    p = random_params(cfg, seed=4)
    mp = _index(p["blocks"]["layer_0"]["moe"], 0)
    h = torch.randn((2, 20, 64), generator=torch.Generator().manual_seed(5))
    names, vals = zip(*leaves(mp))
    a = [v.clone().requires_grad_(True) for v in vals]
    b = [v.clone().requires_grad_(True) for v in vals]
    got = moe.dropless_forward(rebuild(names, a), h, cfg.moe)
    want = ref.experts(rebuild(names, b), h.reshape(-1, 64), cfg) \
        .reshape(h.shape)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    w = torch.randn(h.shape, generator=torch.Generator().manual_seed(6))
    ga = torch.autograd.grad((got * w).sum(), a, allow_unused=True)
    gb = torch.autograd.grad((want * w).sum(), b, allow_unused=True)
    for name, x, y in zip(names, ga, gb):
        if y is None:            # the router: top-k is not differentiable
            continue
        assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max()), \
            name


def test_dense_and_moe_layers_give_the_reference_logits():
    """The leading dense layer (outside the stacked periods) and the two
    stacked MoE layers."""
    cfg = small_cfg()
    p = random_params(cfg)
    assert set(p["lead"]) == {"layer_0"} and "moe" not in p["lead"]["layer_0"]
    assert p["lead"]["layer_0"]["mlp"]["w_in"].shape == (64, 96)
    assert p["blocks"]["layer_0"]["mlp"]["w_in"].shape == (2, 64, 48)
    assert p["blocks"]["layer_0"]["moe"]["w_gate_up"].shape == (2, 4, 64, 64)
    tok = batch(cfg)["tokens"]
    torch.testing.assert_close(program_logits(p, cfg, tok),
                               ref.logits(p, tok, cfg), rtol=1e-4, atol=1e-4)


def test_loss_and_every_leafs_gradient_match_the_reference():
    cfg = small_cfg()
    p = random_params(cfg, seed=8)
    bt = batch(cfg, seed=1)
    names, vals = zip(*leaves(p))
    leaves_ = [v.clone().requires_grad_(True) for v in vals]
    tree = rebuild(names, leaves_)
    got, _ = L.lm_loss(tree, cfg, bt, remat=True, q_block=8, kv_block=8)
    want = ref.loss(tree, bt, cfg)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    g = torch.autograd.grad(got, leaves_)
    h = torch.autograd.grad(want, leaves_)
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
    new, metrics = step(params, bt, make_dpu_meta(2, gammas=[2, 2],
                                                  device="cpu"))
    want, want_loss = ref.cefl_round(p0, bt, cfg, gamma=2, eta=0.05,
                                     mu=0.01)
    assert abs(float(metrics["loss"]) - want_loss) < 1e-5 * abs(want_loss)
    got = new.with_data(new.data[1]).to_tree()
    for (name, x), (_, y), (_, x0) in zip(leaves(got), leaves(want),
                                          leaves(p0)):
        change = float((y - x0).abs().max()) + 1e-12
        assert float((x - y).abs().max()) / change < 2e-3, name


def test_expert_shares_add_up_to_the_whole_layer():
    """Four chips holding 2 experts each, plus the shared expert once,
    give the uncut layer."""
    whole = small_cfg(held=8)
    p = random_params(whole, seed=7)
    lp = _index(p["blocks"]["layer_0"], 0)
    h = torch.randn((2, 16, 64), generator=torch.Generator().manual_seed(1))
    want = ref.moe_layer(lp, h, whole)
    parts = torch.zeros_like(h)
    for chip in range(4):
        m = dataclasses.replace(whole.moe, held_experts=2,
                                expert_offset=2 * chip)
        sl = slice(2 * chip, 2 * chip + 2)
        share = {"router": lp["moe"]["router"],
                 "w_gate_up": lp["moe"]["w_gate_up"][sl],
                 "w_out": lp["moe"]["w_out"][sl]}
        parts = parts + moe.dropless_forward(share, h, m)
    parts = parts + B.mlp_forward(lp["mlp"], h, whole)
    torch.testing.assert_close(parts, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("entry", ["prefill", "decode", "init_cache"])
def test_serving_refuses_latent_attention(entry):
    cfg = small_cfg()
    p = random_params(cfg)
    tok = batch(cfg)["tokens"]
    calls = {"prefill": lambda: L.prefill(p, cfg, tok, 32),
             "decode": lambda: L.lm_decode_step(p, cfg, tok[:, 0],
                                                {"blocks": {}, "pos": 0}),
             "init_cache": lambda: L.init_cache(cfg, 2, 32, device="cpu")}
    with pytest.raises(NotImplementedError, match="latent cache"):
        calls[entry]()


def test_traced_round_spans_and_counts():
    """A traced round: an ``attn.mla`` span per MLA layer call (forward
    and remat recompute) with its shape, a ``mlp.dense`` span for the
    leading layer, the gate-up grouped launches at N = 2f, and one
    ``moe.counts`` whose held pairs are the router's."""
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
    tracing.clear()
    mla = [s for s in spans if s.name == "attn.mla"]
    # 3 layers x 2 DPUs, forward and remat recompute
    assert len(mla) == 12
    assert all(s.attrs == {"tokens": 32, "S": 16, "heads": 4, "qk": 24,
                           "v": 12} for s in mla)
    assert len([s for s in spans if s.name == "mlp.dense"]) == 4
    experts = [s for s in spans if s.name == "moe.experts"]
    assert len(experts) == 8 and all(s.attrs["f"] == 32 for s in experts)
    counts = [s for s in spans if s.name == "moe.counts"]
    assert len(counts) == 1
    want = 0
    for i in range(2):
        x = L.embed_tokens(p0, cfg, tok[i, 0])
        x = ref._layer(p0["lead"]["layer_0"], x, cfg, dense=True)
        for j in range(2):
            lp = _index(p0["blocks"]["layer_0"], j)
            x = x + ref.mla(lp["attn"], rms(x, lp["ln1"], cfg.norm_eps),
                            cfg)
            h = rms(x, lp["ln2"], cfg.norm_eps).reshape(-1, 64)
            ids = moe.dropless_route(lp["moe"]["router"], h, cfg.moe).ids
            want += int((ids < 4).sum())
            x = x + ref.moe_layer(lp, h.reshape(x.shape), cfg)
    a = counts[0].attrs
    assert a["moe_pairs_held"] == want and a["moe_dropped"] == 0


def test_run_lm_trains_the_reduced_model():
    """The registry entry trains through the port's front door
    (``run_lm``, which raises unless the loss falls)."""
    from repro_torch.experiments.lm import run_lm
    from repro_torch.experiments.spec import get_experiment
    s = get_experiment("lm_smoke")
    s = dataclasses.replace(
        s, model=dataclasses.replace(s.model, arch="moonlight-16b-a3b",
                                     batch=4, seq=32),
        engine=dataclasses.replace(s.engine, rounds=4))
    result = run_lm(s, device="cpu", verbose=False)
    assert len(result.reports) == 4
