"""Mesh-native CE-FL LM training from a spec (``ModelSpec.kind="lm"``).
Counterpart of ``repro.experiments.lm``.

The round is the engine's mesh round (``core.round_step``, through
:meth:`~repro_torch.core.engine.MeshExecutor.build_step`) on the flat
parameter plane, driven for ``engine.rounds`` rounds of synthetic token
batches: per local step one ``fedprox_accum`` launch over every DPU, per
round one ``nova_aggregate_stacked`` launch.  ``launch/train.py`` is a
thin argparse shim over :func:`run_lm`.

    from repro_torch.experiments.lm import run_lm
    result = run_lm("lm_smoke", device="cpu")
"""
from __future__ import annotations

import time

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import RoundReport, RunResult
from repro_torch.core.engine import MeshExecutor
from repro_torch.core.round_step import CEFLHyper, make_dpu_meta
from repro_torch.data.synthetic import make_token_batches
from repro_torch.device import require_device
from repro_torch.experiments.spec import (ExperimentSpec, ModelSpec,
                                          get_experiment)
from repro_torch.kernels.plane import ParamPlane, tree_map, tree_unbind
from repro_torch.models import lm as L
from repro_torch.models import moe as moe_lib
from repro_torch.training.checkpoint import save_checkpoint


def lm_config(m: ModelSpec) -> ModelConfig:
    """The spec's architecture, cut to its smoke size when ``reduced``;
    raises if the batch does not split over the DPUs and microbatches,
    the sequence over the SSD chunks, or a microbatch's tokens over the
    MoE's token groups (``models.moe.moe_forward``)."""
    cfg = get_config(m.arch)
    if m.reduced:
        cfg = reduced(cfg)
    if m.batch % (m.n_dpu * m.n_micro):
        raise ValueError(f"batch {m.batch} does not split over {m.n_dpu} "
                         f"DPUs x {m.n_micro} microbatches")
    if cfg.ssm is not None and m.seq % cfg.ssm.chunk_size:
        raise ValueError(f"seq {m.seq} is not a multiple of {cfg.name}'s "
                         f"SSD chunk {cfg.ssm.chunk_size}")
    tokens = m.batch // (m.n_dpu * m.n_micro) * m.seq
    if cfg.moe is not None and not cfg.moe.dropless \
            and tokens % min(1024, tokens):
        raise ValueError(f"a microbatch of {tokens} tokens is not a whole "
                         f"number of {cfg.name}'s 1024-token MoE groups")
    return cfg


def build_lm_step(cfg: ModelConfig, m: ModelSpec, *, eta: float, mu: float):
    """The LM round step: ``lm_loss`` with remat, summed over a per-DPU
    loop (the round step's batched convention: params with a leading DPU
    axis give ``(n,)`` losses), theta = gamma (tau_eff compensation).
    With a drop-free MoE, a round that tracing records ends with one host
    read of its routing counts (``models.moe.flush_counts``).  Attention
    runs in tiles of seq / 8 positions, at least 512: at 8,192 positions
    512-wide tiles (136 a causal layer) left the card idle a third of the
    time waiting on the host's launches (PERF.md)."""
    blk = min(max(512, m.seq // 8), m.seq)

    def loss_fn(p, micro, mask):
        return torch.stack([
            L.lm_loss(p_i, cfg, {k: v[i] for k, v in micro.items()},
                      example_mask=mask[i], remat=True, q_block=blk,
                      kv_block=blk)[0]
            for i, p_i in enumerate(tree_unbind(p))])

    hyper = CEFLHyper(eta=eta, mu=mu, theta=float(m.gamma),
                      gamma_max=m.gamma, n_micro=m.n_micro)
    step = MeshExecutor().build_step(loss_fn, hyper)
    if cfg.moe is None or not cfg.moe.dropless:
        return step

    def counted_step(params, batch, meta):
        out = step(params, batch, meta)
        moe_lib.flush_counts()
        return out
    return counted_step


def lm_batch(cfg: ModelConfig, m: ModelSpec, seed: int, device) -> dict:
    """Round ``seed``'s token batch, (n_dpu, n_micro, mb, seq) on
    ``device``."""
    mb = m.batch // (m.n_dpu * m.n_micro)
    b = make_token_batches(
        cfg.vocab_size, m.n_dpu, m.n_micro, mb, m.seq, seed=seed,
        enc_seq=cfg.encoder_seq if cfg.is_encdec else 0,
        d_model=cfg.d_model)
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def run_lm(spec, *, seed=None, checkpoint=None, use_plane: bool = True,
           verbose: bool = True, device="cuda") -> RunResult:
    """Train the spec's LM arch with the mesh-native CE-FL round on
    ``device`` (``"cuda"`` by default; a CPU run must be asked for).

    Returns a :class:`RunResult` whose reports carry the per-round loss
    (the network-cost fields are zero: there is no radio plane here);
    ``result.params`` is the trained tree of DPU 0.  Raises if the last
    round's loss is not below the first's."""
    spec: ExperimentSpec = get_experiment(spec)
    m = spec.model
    if m.kind != "lm":
        raise ValueError(f"run_lm trains lm specs, not {m.kind!r}")
    dev = require_device(device)
    seed = spec.run_seeds[0] if seed is None else int(seed)
    cfg = lm_config(m)
    if verbose:
        print(f"[train] {cfg.name}: {cfg.param_count() / 1e6:.1f}M params, "
              f"{m.n_dpu} DPUs x gamma={m.gamma}, {dev}")
    params0 = L.init_lm_params(torch.Generator(device=dev).manual_seed(seed),
                               cfg, torch.float32)
    if use_plane:
        # the plane form: params stay (n_dpu, R, LANE) for the whole run;
        # the tree view is made only for the checkpoint
        plane = ParamPlane.from_tree(params0)
        params = plane.with_data(plane.broadcast(m.n_dpu).data.contiguous())
        del plane
    else:
        params = tree_map(lambda x: x.expand((m.n_dpu,) + tuple(x.shape))
                          .contiguous(), params0)
    del params0

    step = build_lm_step(cfg, m, eta=spec.engine.eta, mu=spec.engine.mu)
    meta = make_dpu_meta(m.n_dpu, gammas=[m.gamma] * m.n_dpu, device=dev)
    reports = []
    for t in range(spec.engine.rounds):
        batch = lm_batch(cfg, m, seed * 10000 + t, dev)
        t0 = time.perf_counter()
        params, metrics = step(params, batch, meta)
        loss = float(metrics["loss"])
        wall = time.perf_counter() - t0
        if verbose:
            print(f"  round {t:4d}  loss {loss:8.4f}  ({wall:.2f}s)")
        reports.append(RoundReport(
            round=t, acc=float("nan"), loss=loss, energy=0.0, delay=0.0,
            cum_energy=0.0, cum_delay=0.0, aggregator=0, dc_points=(),
            gamma_mean=float(m.gamma), m_mean=1.0, wall_time=wall))
    final = (params.with_data(params.data[0]).to_tree()
             if isinstance(params, ParamPlane)
             else tree_map(lambda x: x[0], params))
    if checkpoint:
        save_checkpoint(checkpoint, final, step=spec.engine.rounds,
                        metadata={"arch": m.arch, "seed": seed})
        if verbose:
            print(f"[train] checkpoint -> {checkpoint}")
    losses = [r.loss for r in reports]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not decrease: {losses[0]} -> "
                             f"{losses[-1]}")
    if verbose:
        print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return RunResult(reports=reports, params=final)
