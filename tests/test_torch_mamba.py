"""The port's Mamba-2 mixer (``repro_torch.models.mamba``) against the JAX
package's (``repro.models.mamba``).

JAX parameters from ``repro.models.mamba.init_mamba_params`` are carried
across with ``params_from_numpy``; inputs are made with numpy from a seed.

Tolerances, with their reasons:
- float32 outputs and states: 1e-5 absolute on values of order 1 (the
  products sum in XLA's and torch's CPU orders; measured about 1e-6).
- gradients: rtol 1e-4 against JAX's, per leaf relative to the leaf's
  largest entry (sums over the batch and sequence in two orders).
- the full-width layer: the port's float32 gradient within 1e-4 of its
  own float64 gradient, norm-wise per leaf (||g32 - g64|| / ||g64||).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import SSMConfig as JSSM
from repro.models import mamba as JM
from repro_torch import configs as tconfigs
from repro_torch.configs.base import SSMConfig as TSSM
from repro_torch.kernels.plane import tree_map
from repro_torch.models import mamba as TM
from repro_torch.models.lm import params_from_numpy

torch.set_num_threads(2)

F32 = 1e-5

# tests/test_mamba.py's S_CFG, and the reduced and full mamba2-130m mixers
S_KW = dict(state_dim=8, head_dim=8, expand=2, chunk_size=4, conv_width=4)
RED = dataclasses.asdict(
    jconfigs.reduced(jconfigs.get_config("mamba2-130m")).ssm)
FULL = dataclasses.asdict(jconfigs.get_config("mamba2-130m").ssm)
CASES = {"s_cfg": (S_KW, 16), "reduced": (RED, 64)}   # (ssm, d_model)


def _setup(kw, d_model, B=2, S=16, seed=0, scale=0.5):
    js, ts = JSSM(**kw), TSSM(**kw)
    p = JM.init_mamba_params(jax.random.PRNGKey(seed), d_model, js,
                             jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                           device="cpu")
    x = (np.random.RandomState(seed + 1).randn(B, S, d_model) * scale
         ).astype(np.float32)
    return js, ts, p, tp, x


@pytest.mark.parametrize("case", sorted(CASES))
def test_ssd_forward_and_state_match_repro(case):
    kw, d = CASES[case]
    js, ts, p, tp, x = _setup(kw, d)
    jy, jst = JM.ssd_forward(p, jnp.asarray(x), js, return_state=True)
    ty, tst = TM.ssd_forward(tp, torch.from_numpy(x), ts, return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=F32)
    for k in ("h", "conv"):
        assert tst[k].dtype == torch.float32
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   atol=F32)
    # without the state: the same output
    np.testing.assert_allclose(
        TM.ssd_forward(tp, torch.from_numpy(x), ts).numpy(), ty.numpy(),
        atol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_chaining_matches_repro(case):
    kw, d = CASES[case]
    js, ts, p, tp, x = _setup(kw, d)
    half = x.shape[1] // 2
    j1, jst = JM.ssd_forward(p, jnp.asarray(x[:, :half]), js,
                             return_state=True)
    j2 = JM.ssd_forward(p, jnp.asarray(x[:, half:]), js, init_state=jst)
    t1, tst = TM.ssd_forward(tp, torch.from_numpy(x[:, :half]), ts,
                             return_state=True)
    t2 = TM.ssd_forward(tp, torch.from_numpy(x[:, half:]), ts,
                        init_state=tst)
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), atol=F32)
    full = TM.ssd_forward(tp, torch.from_numpy(x), ts)
    np.testing.assert_allclose(torch.cat([t1, t2], 1).numpy(), full.numpy(),
                               atol=F32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_step_matches_repro_and_the_chunked_form(case):
    """Token by token: the port's recurrent step equals JAX's, and the
    run of steps equals the port's chunked form (chunked = recurrent)."""
    kw, d = CASES[case]
    js, ts, p, tp, x = _setup(kw, d)
    jcur = JM.init_mamba_state(2, d, js, jnp.float32)
    tcur = TM.init_mamba_state(2, d, ts, torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in tcur.items()} == \
        {k: tuple(v.shape) for k, v in jcur.items()}
    ys = []
    for t in range(x.shape[1]):
        jy, jcur = JM.mamba_decode_step(p, jnp.asarray(x[:, t]), jcur, js)
        ty, tcur = TM.mamba_decode_step(tp, torch.from_numpy(x[:, t]), tcur,
                                        ts)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=F32)
        ys.append(ty)
    for k in ("h", "conv"):
        np.testing.assert_allclose(tcur[k].numpy(), np.asarray(jcur[k]),
                                   atol=F32)
    y, st = TM.ssd_forward(tp, torch.from_numpy(x), ts, return_state=True)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y.numpy(),
                               atol=F32)
    for k in ("h", "conv"):
        np.testing.assert_allclose(st[k].numpy(), tcur[k].numpy(),
                                   atol=F32)


@pytest.mark.parametrize("chunk", [2, 8, 16])
def test_chunk_invariance(chunk):
    js, ts, p, tp, x = _setup(S_KW, 16)
    y1 = TM.ssd_forward(tp, torch.from_numpy(x), ts)
    y2 = TM.ssd_forward(tp, torch.from_numpy(x),
                        dataclasses.replace(ts, chunk_size=chunk))
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=F32)


def test_sequence_not_a_multiple_of_the_chunk_raises():
    js, ts, p, tp, x = _setup(S_KW, 16, S=6)
    with pytest.raises(ValueError, match="chunk size 4"):
        TM.ssd_forward(tp, torch.from_numpy(x), ts)


def _grads(tp, x, ts, dtype=torch.float32):
    leaves = tree_map(lambda t: t.detach().to(dtype, copy=True)
                      .requires_grad_(True), tp)
    y = TM.ssd_forward(leaves, torch.from_numpy(x).to(dtype), ts)
    torch.sum(y ** 2).backward()
    return {k: v.grad for k, v in leaves.items()}


def _jax_grads(p, x, js):
    return jax.jit(jax.grad(
        lambda pp: jnp.sum(JM.ssd_forward(pp, jnp.asarray(x), js) ** 2)))(p)


@pytest.mark.parametrize("case", sorted(CASES))
def test_grads_match_repro(case):
    kw, d = CASES[case]
    js, ts, p, tp, x = _setup(kw, d)
    jg = _jax_grads(p, x, js)
    tg = _grads(tp, x, ts)
    assert sorted(tg) == sorted(jg)
    for k, g in tg.items():
        want = np.asarray(jg[k])
        assert np.all(np.isfinite(want)), k
        assert torch.isfinite(g).all(), k
        np.testing.assert_allclose(
            g.numpy(), want, rtol=0,
            atol=1e-4 * max(float(np.abs(want).max()), 1e-30), err_msg=k)


def test_full_width_gradient_finite_where_repro_overflows():
    """A fault of the reference, not copied: at mamba2-130m's width (24
    heads, chunk 64) the reference's masked decay ``where(tri, exp(diff),
    0)`` overflows above the diagonal and its backward gives inf * 0 =
    NaN in w_in, a_log and dt_bias.  The port masks before the exp: its
    forward equals the reference's, its gradient is finite and within
    1e-4 of its own float64 gradient.  The input has unit variance, as
    a layer's rms-normed input has."""
    js, ts, p, tp, x = _setup(FULL, 768, B=1, S=128, scale=1.0)
    jy = JM.ssd_forward(p, jnp.asarray(x), js)
    ty = TM.ssd_forward(tp, torch.from_numpy(x), ts)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=F32)
    jg = _jax_grads(p, x, js)
    bad = sorted(k for k, g in jg.items() if not np.all(np.isfinite(g)))
    assert {"w_in", "a_log", "dt_bias"} <= set(bad), bad
    g32 = _grads(tp, x, ts)
    g64 = _grads(tp, x, ts, torch.float64)
    for k in g32:
        assert torch.isfinite(g32[k]).all(), k
        rel = float(torch.linalg.vector_norm(g32[k].double() - g64[k])
                    / torch.linalg.vector_norm(g64[k]))
        assert rel < 1e-4, (k, rel)
        if k not in bad:       # where the reference is finite, it agrees
            want = np.asarray(jg[k])
            np.testing.assert_allclose(
                g32[k].numpy(), want, rtol=0,
                atol=1e-4 * float(np.abs(want).max()), err_msg=k)


def test_init_params_match_repro_in_shape_and_scale():
    js, ts = JSSM(**FULL), TSSM(**FULL)
    jp = JM.init_mamba_params(jax.random.PRNGKey(0), 768, js, jnp.float32)
    tp = TM.init_mamba_params(torch.Generator().manual_seed(0), 768, ts,
                              torch.float32)
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    for k in ("d_skip", "conv_b", "norm"):                # deterministic
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))
    # log(1..H): XLA's and torch's log differ by an ulp
    np.testing.assert_allclose(tp["a_log"].numpy(), np.asarray(jp["a_log"]),
                               rtol=2e-7)
    assert abs(float(tp["w_in"].std()) * np.sqrt(768) - 1) < 0.01
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert float(dt.min()) >= ts.dt_min * 0.999
    assert float(dt.max()) <= ts.dt_max * 1.001
    assert tconfigs.get_config("mamba2-130m").ssm == ts
