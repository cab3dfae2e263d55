"""The port's CE-FL LM training (``repro_torch.models.lm.lm_loss``, the
mesh round on an LM, ``experiments.lm.run_lm``, ``launch.train``, the LM
presets through the front door) against the JAX package's.

JAX parameters are carried across with ``params_from_numpy`` (or, for a
whole run, injected in place of the port's random init), so both packages
train the same weights on the same token batches, which are made by the
same numpy stream.

Tolerances, with their reasons:
- loss: rtol 1e-6 (one f32 logsumexp over the same logits; measured
  agreement about 1e-7);
- gradients: 1e-5 of each leaf's largest entry (measured about 2e-6: the
  backward sums over tokens in XLA's and torch's CPU orders);
- one round: rtol 1e-5, atol 1e-6 on the new parameters (the gradients'
  error times eta = 3e-2, over two local steps; measured 7e-7 absolute);
- a 4-round run: rtol 1e-4 on each round's loss (the rounding of the
  parameters compounds over the rounds).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import round_step as JR
from repro.data import make_token_batches as j_token_batches
from repro.experiments import get_experiment as j_get_experiment
from repro.experiments.lm import run_lm as j_run_lm
from repro.kernels.plane import ParamPlane as JPlane
from repro.models import lm as JL
from repro_torch import configs as tconfigs
from repro_torch import experiments as texp
from repro_torch.core import round_step as TR
from repro_torch.data.synthetic import make_token_batches
from repro_torch.experiments import __main__ as tcli
from repro_torch.experiments import lm as tlm
from repro_torch.experiments.spec import ModelSpec
from repro_torch.kernels.plane import ParamPlane, tree_map, tree_paths
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as TL

torch.set_num_threads(2)

ETA, MU = 3e-2, 0.01


def _cfgs():
    return (jconfigs.reduced(jconfigs.get_config("mamba2-130m")),
            tconfigs.reduced(tconfigs.get_config("mamba2-130m")))


def _params(jcfg, seed=0):
    p = JL.init_lm_params(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return p, TL.params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                   device="cpu")


def _paths(tree):
    return dict(tree_paths(jax.tree_util.tree_map(np.asarray, tree)))


@pytest.mark.parametrize("kw", [
    dict(vocab=512, n_dpu=2, n_micro=1, mb=4, seq=64, seed=0),
    dict(vocab=50280, n_dpu=2, n_micro=2, mb=2, seq=128, seed=170003),
    dict(vocab=97, n_dpu=3, n_micro=1, mb=2, seq=8, seed=5, enc_seq=4,
         d_model=6)], ids=["smoke", "full-vocab", "enc-dec"])
def test_make_token_batches_bit_for_bit(kw):
    want = j_token_batches(**kw)
    got = make_token_batches(**kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_and_grad_match_repro(masked):
    jcfg, tcfg = _cfgs()
    p, tp = _params(jcfg)
    b = make_token_batches(jcfg.vocab_size, 1, 1, 3, 32, seed=3)
    micro = {k: v[0, 0] for k, v in b.items()}
    mask = np.array([1, 0, 1], np.float32) if masked else None
    (jl, _), jg = jax.value_and_grad(
        lambda pp: JL.lm_loss(pp, jcfg, micro, example_mask=None
                              if mask is None else jnp.asarray(mask)),
        has_aux=True)(p)
    leaves = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    tl, aux = TL.lm_loss(leaves, tcfg,
                         {k: torch.from_numpy(v) for k, v in micro.items()},
                         example_mask=None if mask is None
                         else torch.from_numpy(mask))
    tl.backward()
    assert float(aux["load_balance"]) == 0.0
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    want = _paths(jg)
    got = tree_paths(leaves)
    assert [path for path, _ in got] == sorted(want)
    for path, t in got:
        w = want[path]
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=str(path))


def test_lm_loss_without_remat_and_without_autograd_agree():
    """The checkpointed backbone and loss give the values of the plain
    forward, with and without autograd."""
    _, tcfg = _cfgs()
    _, tp = _params(_cfgs()[0])
    b = {k: torch.from_numpy(v[0, 0]) for k, v in make_token_batches(
        tcfg.vocab_size, 1, 1, 2, 16, seed=4).items()}
    with torch.no_grad():
        plain, _ = TL.lm_loss(tp, tcfg, b, remat=False)
    leaves = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    remat, _ = TL.lm_loss(leaves, tcfg, b)
    assert float(remat.detach()) == float(plain)
    # the loss over chunks of 8 tokens equals one chunk of all 16
    x, _ = TL.lm_backbone(tp, tcfg, TL.embed_tokens(tp, tcfg, b["tokens"]))
    np.testing.assert_allclose(
        float(TL.chunked_loss(tp, tcfg, x, b["labels"], chunk=8)),
        float(TL.chunked_loss(tp, tcfg, x, b["labels"])), rtol=1e-6)


def _arch(arch):
    """repro's and the port's reduced config of ``arch``, the JAX
    parameters, the port's copy."""
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    return (jcfg, tcfg) + _params(jcfg)


def _batch(cfg, n_dpu, n_micro, mb, seq, seed):
    return make_token_batches(
        cfg.vocab_size, n_dpu, n_micro, mb, seq, seed=seed,
        enc_seq=cfg.encoder_seq if cfg.is_encdec else 0, d_model=cfg.d_model)


def _loss_and_grads(arch, masked=False):
    """The loss, aux and gradients of one microbatch (3 x 32 tokens) of
    the reduced ``arch``: the reference's and the port's."""
    jcfg, tcfg, p, tp = _arch(arch)
    micro = {k: v[0, 0] for k, v in _batch(jcfg, 1, 1, 3, 32, 3).items()}
    mask = np.array([1, 0, 1], np.float32) if masked else None
    kw = dict(q_block=16, kv_block=16)
    (jl, jaux), jg = jax.value_and_grad(
        lambda pp: JL.lm_loss(pp, jcfg, micro, example_mask=None
                              if mask is None else jnp.asarray(mask), **kw),
        has_aux=True)(p)
    leaves = tree_map(lambda t: t.clone().requires_grad_(True), tp)
    tl, taux = TL.lm_loss(leaves, tcfg,
                          {k: torch.from_numpy(v) for k, v in micro.items()},
                          example_mask=None if mask is None
                          else torch.from_numpy(mask), **kw)
    tl.backward()
    return (jl, jaux, _paths(jg)), (tl, taux, leaves)


def _check_loss_and_grads(arch, masked=False):
    (jl, jaux, want), (tl, taux, leaves) = _loss_and_grads(arch, masked)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
    for key in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(taux[key].detach()),
                                   float(jaux[key]), rtol=1e-6, atol=1e-7)
    got = tree_paths(leaves)
    assert [path for path, _ in got] == sorted(want)
    for path, t in got:
        w = want[path]
        g = t.grad.numpy() if t.grad is not None else np.zeros_like(w)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()),
                                   err_msg=str(path))
    return taux


def test_lm_loss_refuses_attention_layers():
    """Training attention layers was refused until the flash backward was
    ported; now qwen3 (attention with qk-norm) trains: its loss and every
    gradient match the reference's, through a masked microbatch."""
    taux = _check_loss_and_grads("qwen3-32b", masked=True)
    assert float(taux["load_balance"].detach()) == 0.0


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_lm_loss_and_grad_match_repro_every_arch(arch):
    """Every architecture at its reduced size: the loss (MoE aux terms
    included), the aux terms and every gradient against the reference's,
    at ``test_lm_loss_and_grad_match_repro``'s bar."""
    taux = _check_loss_and_grads(arch)
    assert (float(taux["load_balance"].detach()) > 0) == \
        (tconfigs.get_config(arch).moe is not None)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_lm_round_matches_repro_every_arch(arch):
    """One CE-FL round (plane form; n_dpu 2, n_micro 2, gammas (2, 1),
    absolute weights) of every reduced architecture against the
    reference's ``round_step``, at ``test_lm_round_matches_repro``'s bar."""
    jcfg, tcfg, p, tp = _arch(arch)
    b = _batch(jcfg, 2, 2, 2, 32, 3)
    hyper = JR.CEFLHyper(eta=ETA, mu=MU, theta=2.0, gamma_max=2, n_micro=2,
                         kernel_backend="cpu")
    jstep = jax.jit(JR.build_cefl_round_step(
        lambda pp, mm, mk: JL.lm_loss(pp, jcfg, mm, example_mask=mk,
                                      q_block=32, kv_block=32), hyper))
    meta = dict(gammas=[2, 1], m_fracs=[1.0, 0.5], weights=[300.0, 500.0])
    jnew, jm = jstep(JPlane.from_tree(p).broadcast(2),
                     {k: jnp.asarray(v) for k, v in b.items()},
                     JR.make_dpu_meta(2, **meta))
    plane = ParamPlane.from_tree(tp)
    tstep = tlm.build_lm_step(
        tcfg, ModelSpec(kind="lm", arch=arch, reduced=True, batch=8, seq=32,
                        n_dpu=2, n_micro=2, gamma=2), eta=ETA, mu=MU)
    tnew, tm = tstep(plane.with_data(plane.broadcast(2).data.contiguous()),
                     {k: torch.from_numpy(v) for k, v in b.items()},
                     TR.make_dpu_meta(2, device="cpu", **meta))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(tnew.data.numpy(), np.asarray(jnew.data),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("form", ["plane", "tree"])
def test_lm_round_matches_repro(form):
    """One CE-FL round (n_dpu 2, n_micro 2, gammas (2, 1), absolute
    weights) on reduced mamba2: the port's ``build_lm_step`` against
    ``repro.core.round_step`` with the ``"cpu"`` dispatch."""
    jcfg, tcfg = _cfgs()
    p, tp = _params(jcfg)
    b = make_token_batches(jcfg.vocab_size, 2, 2, 2, 32, seed=3)
    hyper = JR.CEFLHyper(eta=ETA, mu=MU, theta=2.0, gamma_max=2, n_micro=2,
                         kernel_backend="cpu")
    jstep = jax.jit(JR.build_cefl_round_step(
        lambda pp, mm, mk: JL.lm_loss(pp, jcfg, mm, example_mask=mk),
        hyper))
    meta = dict(gammas=[2, 1], m_fracs=[1.0, 0.5], weights=[300.0, 500.0])
    if form == "plane":
        jparams = JPlane.from_tree(p).broadcast(2)
        plane = ParamPlane.from_tree(tp)
        tparams = plane.with_data(plane.broadcast(2).data.contiguous())
    else:
        jparams = jax.tree_util.tree_map(
            lambda x: jnp.broadcast_to(x[None], (2,) + x.shape), p)
        tparams = tree_map(lambda x: x.expand((2,) + tuple(x.shape))
                           .contiguous(), tp)
    jnew, jm = jstep(jparams, {k: jnp.asarray(v) for k, v in b.items()},
                     JR.make_dpu_meta(2, **meta))
    tstep = tlm.build_lm_step(
        tcfg, ModelSpec(kind="lm", batch=8, seq=32, n_dpu=2, n_micro=2,
                        gamma=2), eta=ETA, mu=MU)
    tnew, tm = tstep(tparams, {k: torch.from_numpy(v) for k, v in b.items()},
                     TR.make_dpu_meta(2, device="cpu", **meta))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    if form == "plane":
        assert isinstance(tnew, ParamPlane)
        np.testing.assert_allclose(tnew.data.numpy(), np.asarray(jnew.data),
                                   rtol=1e-5, atol=1e-6)
    else:
        want = _paths(jnew)
        for path, t in tree_paths(tnew):
            np.testing.assert_allclose(t.numpy(), want[path], rtol=1e-5,
                                       atol=1e-6, err_msg=str(path))


SMALL = {"engine.rounds": 4, "model.batch": 4, "model.seq": 64}


def test_run_lm_matches_repro(monkeypatch, tmp_path):
    """``run_lm`` on lm_smoke cut to 4 rounds, batch 4, seq 64, started
    from the JAX package's initial parameters: every round's loss within
    rtol 1e-4 of ``repro.experiments.lm.run_lm``'s; the checkpoint holds
    DPU 0's trained tree."""
    jspec = j_get_experiment("lm_smoke").override(**SMALL)
    want = [r.loss for r in j_run_lm(jspec, verbose=False).reports]
    jcfg, _ = _cfgs()
    _, tp = _params(jcfg)
    monkeypatch.setattr(tlm.L, "init_lm_params",
                        lambda gen, cfg, dtype=None: tree_map(
                            lambda t: t.to(gen.device, dtype), tp))
    spec = texp.get_experiment("lm_smoke").override(**SMALL)
    res = tlm.run_lm(spec, device="cpu", verbose=False,
                     checkpoint=str(tmp_path / "ck"))
    got = res.series("loss")
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    assert [r.round for r in res.reports] == [0, 1, 2, 3]
    from repro_torch.training.checkpoint import load_checkpoint
    tree, step, meta = load_checkpoint(str(tmp_path / "ck"), res.params)
    assert step == 4 and meta == {"arch": "mamba2-130m", "seed": 0}
    for (pa, a), (pb, b) in zip(tree_paths(res.params), tree_paths(tree)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(b), a.numpy())


def test_launch_train_shim_on_the_cpu():
    losses = ttrain.main(["--reduced", "--steps", "3", "--batch", "4",
                          "--seq", "32", "--gamma", "2", "--device", "cpu"])
    assert len(losses) == 3 and losses[-1] < losses[0]
    tree_losses = ttrain.main(["--reduced", "--steps", "3", "--batch", "4",
                               "--seq", "32", "--gamma", "2", "--tree",
                               "--device", "cpu"])
    np.testing.assert_allclose(tree_losses, losses, rtol=1e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            ttrain.main(["--reduced", "--steps", "1"])


def test_launch_train_moe_hybrid_on_the_cpu():
    """``launch.train`` trains any architecture: jamba (Mamba + attention
    + MoE) at its reduced size, with a falling loss."""
    losses = ttrain.main(["--arch", "jamba-v0.1-52b", "--reduced", "--steps",
                          "3", "--batch", "4", "--seq", "32", "--gamma", "2",
                          "--device", "cpu"])
    assert len(losses) == 3 and losses[-1] < losses[0]


def test_lm_config_refuses_ragged_moe_groups():
    """A microbatch whose tokens are not whole 1024-token MoE groups is
    refused before any work (the reference asserts inside the step)."""
    spec = texp.get_experiment("lm_smoke").override(**{
        "model.arch": "arctic-480b", "model.reduced": True})
    m = spec.model
    ok = dataclasses.replace(m, batch=16, seq=256)       # 8 x 256 = 2048
    assert tlm.lm_config(ok).moe is not None
    assert tlm.lm_config(dataclasses.replace(m, batch=2, seq=96))  # < 1024
    with pytest.raises(ValueError, match="MoE groups"):
        tlm.lm_config(dataclasses.replace(m, batch=10, seq=256))  # 1280


def test_lm_spec_json_round_trip():
    for name in ("lm_smoke", "lm_mamba2_130m"):
        spec = texp.get_experiment(name)
        assert spec.model.kind == "lm"
        assert texp.from_json(texp.to_json(spec)) == spec
        assert json.loads(texp.to_json(spec)) == \
            json.loads(json.dumps(dataclasses.asdict(spec)))
    over = texp.get_experiment("lm_smoke").override(
        **{"model.seq": "128", "model.reduced": "false"})
    assert (over.model.seq, over.model.reduced) == (128, False)
    assert texp.from_json(texp.to_json(over)) == over
    assert tlm.lm_config(over.model).d_model == 768
    with pytest.raises(ValueError, match="chunk"):
        tlm.lm_config(dataclasses.replace(over.model, seq=100))
    with pytest.raises(ValueError, match="split"):
        tlm.lm_config(dataclasses.replace(over.model, batch=3))


def _cli(capsys, *argv):
    rc = tcli.main(list(argv))
    return rc, capsys.readouterr().out


def test_cli_runs_lm_smoke_on_the_cpu_and_its_refusals(capsys, tmp_path):
    trace = tmp_path / "t.jsonl"
    rc, out = _cli(capsys, "run", "lm_smoke", "--device", "cpu", "--rounds",
                   "3", "--set", "model.seq=32", "--trace", str(trace))
    assert rc == 0 and "final loss" in out
    lines = [json.loads(ln) for ln in trace.read_text().splitlines()]
    assert [r["round"] for r in lines] == [0, 1, 2]
    assert {r["executor"] for r in lines} == {"lm"}
    assert lines[-1]["loss"] < lines[0]["loss"]
    rc, out = _cli(capsys, "validate", "lm_mamba2_130m", "--device", "cpu")
    assert rc == 0 and "OK" in out
    with pytest.raises(SystemExit, match="classifier"):
        _cli(capsys, "run", "lm_smoke", "--device", "cpu", "--checkpoint",
             str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="callbacks"):
        texp.run("lm_smoke", device="cpu", callbacks=(print,))
    with pytest.raises(ValueError, match="one seed"):
        texp.run(texp.get_experiment("lm_smoke").override(seeds=(0, 1)),
                 device="cpu")
    with pytest.raises(ValueError, match="classifier"):
        texp.sweep("lm_smoke", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            _cli(capsys, "run", "lm_smoke", "--rounds", "1")
