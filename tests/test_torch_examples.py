"""The port's LM examples (``repro_torch.examples``) on the CPU at their
smallest sizes, each through its ``main(argv)`` with ``--device cpu``
(the CE-FL ones: ``test_torch_examples_cefl.py`` and
``test_torch_examples_mobility.py``):

* ``serve_lm --reduced`` at mamba2-130m and at starcoder2-15b: tokens in
  the vocabulary; the attention decode goes through
  ``ops.swa_decode_attention`` once per layer and step.
* ``train_lm_cefl --steps 2`` in ``tmp_path`` (losses finite and falling),
  and ``--full`` with a reduced ``lm_mamba2_130m``, which writes its
  checkpoint to ``results/ckpt_mamba2_cefl`` under the working directory.
* Without ``--device`` every example asks for the card.
"""
import numpy as np
import pytest
import torch

from repro import experiments as jexp
from repro_torch import experiments as texp
from repro_torch.configs import get_config, reduced
from repro_torch.examples import (cefl_vs_baselines, mobility_demo,
                                  quickstart, serve_lm, train_lm_cefl)
from repro_torch.kernels import ops
from repro_torch.kernels.plane import tree_paths
from repro_torch.training import load_checkpoint

torch.set_num_threads(2)


# The fields an example prints that do not depend on ``jax.random`` (the
# plan's aggregator, the scenario's handovers, the offloading's
# ``dc_points``, energy and delay) come from the engine's host path
# alone: ``begin_round`` (scenario tick, plan, offloading) and
# ``finish_round`` (costs).  Replaying those two for every round, without
# training, gives the values the reference example prints for the same
# arguments, at a fraction of its cost.  test_torch_examples_cefl.py and
# test_torch_examples_mobility.py import these two helpers.

def reference_host_reports(spec, seed: int = 0):
    """The reference's round reports of ``spec`` (one seed) with the
    device work skipped: loss NaN, accuracy 0."""
    ctx = jexp.build_context(spec)
    eng = ctx.make_engine(seed)
    ues = ctx.make_ues(seed)
    state = eng.init_loop(ues, init_params=ctx.p0, loss_fn=ctx.loss_fn,
                          eval_fn=ctx.eval_fn)
    while state.t < spec.engine.rounds:
        staged = eng.begin_round(state, ues)
        eng.finish_round(state, staged, float("nan"), 0.0)
    return state.reports


def host_fields(r):
    return (r.round, r.aggregator, tuple(r.handovers), tuple(r.dc_points),
            r.aggregator_moved, r.active_ues)


@pytest.mark.parametrize("arch", ["mamba2-130m", "starcoder2-15b"])
def test_serve_lm_reduced(arch, monkeypatch, capsys):
    calls = []
    real = ops._ref.swa_decode_attention_ref

    def counted(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(ops._ref, "swa_decode_attention_ref", counted)
    toks = serve_lm.main(["--arch", arch, "--reduced", "--device", "cpu"])
    cfg = reduced(get_config(arch))
    assert toks.shape == (4, 16)
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
    attn_layers = sum(k == "A" for k in cfg.layer_pattern) \
        * cfg.num_layers // len(cfg.layer_pattern) \
        if not cfg.attn_free else 0
    assert len(calls) == attn_layers * 15
    if arch == "starcoder2-15b":
        assert attn_layers == cfg.num_layers > 0
        assert set(calls) == {(4, cfg.num_heads, cfg.head_dim)}
    out = capsys.readouterr().out
    assert f"[serve] {cfg.name}:" in out and "seq1:" in out


def test_train_lm_cefl_smoke_and_full(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = train_lm_cefl.main(["--steps", "2", "--device", "cpu"])
    losses = [r.loss for r in res.reports]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert not (tmp_path / "results").exists()
    # --full on a reduced mamba2-130m (the full width is the card's)
    real = texp.get_experiment
    monkeypatch.setattr(
        train_lm_cefl, "get_experiment", lambda name: real(name).override(
            **{"model.reduced": True, "model.seq": 64}))
    res = train_lm_cefl.main(["--full", "--steps", "2", "--device", "cpu"])
    ckpt = tmp_path / "results" / "ckpt_mamba2_cefl"
    assert (ckpt / "manifest.json").exists()
    restored, step, meta = load_checkpoint(ckpt, res.params)
    assert (step, meta) == (2, {"arch": "mamba2-130m", "seed": 0})
    want = tree_paths(res.params)
    got = tree_paths(restored)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        assert torch.equal(a, b), p


@pytest.mark.parametrize("example", [quickstart, cefl_vs_baselines,
                                     mobility_demo, serve_lm,
                                     train_lm_cefl])
def test_examples_ask_for_the_card_by_default(example):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="cuda"):
        example.main([])
