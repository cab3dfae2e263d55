"""Spec -> runnable context: network, data pool, model init, constants.
Counterpart of ``repro.experiments.build``.

``build_context`` is the one place the port turns a declarative
:class:`~repro_torch.experiments.spec.ExperimentSpec` into live objects,
on one device.  Everything spec-level (network topology, data pool,
initial params, constants, objective weights) is shared across the seeds
of a grid; only :meth:`ExperimentContext.make_ues` / :meth:`make_engine`
take the per-run seed, and both derive every stream from it.

Randomness: the numpy streams (pool, topology, UE streams) are the
reference's, bit for bit.  The initial params and the constants
estimation's probes come from ``torch.Generator``s seeded as the
reference seeds its ``jax.random`` keys (``data.pool_seed``, and 7), so
their numbers differ from the reference's.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.cefl_paper import ClassifierConfig
from repro_torch.core.convergence import MLConstants
from repro_torch.core.engine import Engine
from repro_torch.core.estimation import Draws, estimate_constants
from repro_torch.data.synthetic import make_image_dataset, make_online_ues
from repro_torch.device import require_device
from repro_torch.experiments.spec import ExperimentSpec, get_experiment
from repro_torch.models.classifier import (classifier_accuracy,
                                           classifier_loss,
                                           init_classifier_params)
from repro_torch.network.topology import NetworkConfig, make_network
from repro_torch.solver.objective import ObjectiveWeights


@dataclasses.dataclass
class ExperimentContext:
    """Live objects for one spec (shared across the seed axis)."""
    spec: ExperimentSpec
    device: torch.device
    net: object
    p0: object
    loss_fn: Callable
    eval_fn: Callable
    consts: MLConstants
    ow: ObjectiveWeights
    train_x: np.ndarray
    train_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray

    def make_ues(self, seed: int):
        """Per-run online UE streams — every stream seed derives from the
        run seed (the spec's single-seed contract)."""
        d = self.spec.data
        return make_online_ues(
            self.train_x, self.train_y, num_ue=self.spec.network.num_ue,
            labels_per_ue=d.labels_per_ue, mean_arrivals=d.mean_arrivals,
            std_arrivals=d.std_arrivals, seed=int(seed),
            drift_labels=d.drift_labels)

    def make_engine(self, seed: int, *, executor=None,
                    callbacks=()) -> Engine:
        return Engine(self.net, consts=self.consts, ow=self.ow,
                      opts=self.spec.engine_options(seed),
                      executor=executor, callbacks=callbacks,
                      device=self.device)


def _build_consts(spec: ExperimentSpec, p0, train_x, train_y, device):
    c = spec.consts
    N, S = spec.network.num_ue, spec.network.num_dc
    if c.mode == "fixed":
        nd = N + S
        return MLConstants(L=c.L, theta_i=np.full(nd, c.theta),
                           sigma_i=np.full(nd, c.sigma),
                           zeta1=c.zeta1, zeta2=c.zeta2)
    if c.mode != "estimate":
        raise ValueError(f"unknown consts mode {c.mode!r}")
    # one-shot pre-training estimation (paper Algs. 4-6, App. H-1) on
    # probe streams seeded off the spec (not the run).  Theta/sigma are
    # per-UE; DC entries (mixtures of offloaded UE data) take UE means.
    probe = [ds.step() for ds in make_online_ues(
        train_x, train_y, num_ue=N,
        labels_per_ue=spec.data.labels_per_ue,
        mean_arrivals=spec.data.mean_arrivals,
        std_arrivals=spec.data.std_arrivals, seed=c.probe_seed)]
    draws = Draws(torch.Generator(device=device).manual_seed(7))
    consts = estimate_constants(classifier_loss, p0, probe, draws=draws,
                                iters=c.estimate_iters)
    return dataclasses.replace(
        consts,
        theta_i=np.concatenate([consts.theta_i,
                                np.full(S, consts.theta_i.mean())]),
        sigma_i=np.concatenate([consts.sigma_i,
                                np.full(S, consts.sigma_i.mean())]))


def _cache_key(spec: ExperimentSpec) -> ExperimentSpec:
    """Strip the axes that don't affect the built objects — the run axes
    (name, strategy, scenario, seeds) and ``data.drift_labels`` — so a
    strategy/scenario/drift grid over one base spec shares a single
    context build (and a single constants estimation)."""
    return dataclasses.replace(
        spec, name="", strategy="cefl", scenario="static", seeds=(),
        data=dataclasses.replace(spec.data, drift_labels=False))


def _build(spec: ExperimentSpec, device: torch.device) -> ExperimentContext:
    if spec.model.kind != "classifier":
        raise NotImplementedError(
            f"model kind {spec.model.kind!r}: the port builds classifier "
            "specs; LM training is ROADMAP queue 1 item 6")
    m, d, n = spec.model, spec.data, spec.network
    net = make_network(NetworkConfig(num_ue=n.num_ue, num_bs=n.num_bs,
                                     num_dc=n.num_dc,
                                     seed=n.topology_seed))
    (trx, tr_y), (tex, te_y) = make_image_dataset(
        d.pool, tuple(m.input_shape), num_classes=m.num_classes,
        seed=d.pool_seed)
    ccfg = ClassifierConfig(input_shape=tuple(m.input_shape),
                            hidden=tuple(m.hidden),
                            num_classes=m.num_classes)
    p0 = init_classifier_params(
        torch.Generator(device=device).manual_seed(d.pool_seed), ccfg,
        device=device)
    ex = torch.from_numpy(tex[:d.eval_examples]).to(device)
    ey = torch.from_numpy(te_y[:d.eval_examples]).to(device)

    def eval_fn(p):
        return classifier_accuracy(p, ex, ey)

    consts = _build_consts(spec, p0, trx, tr_y, device)
    o = spec.objective
    ow = ObjectiveWeights(xi1=o.xi1, xi2=o.xi2, xi3=o.xi3, drift=o.drift,
                          T=spec.engine.rounds)
    return ExperimentContext(spec=spec, device=device, net=net, p0=p0,
                             loss_fn=classifier_loss, eval_fn=eval_fn,
                             consts=consts, ow=ow,
                             train_x=trx, train_y=tr_y,
                             test_x=tex, test_y=te_y)


@functools.lru_cache(maxsize=8)
def _build_context_cached(spec: ExperimentSpec,
                          device: str) -> ExperimentContext:
    return _build(spec, torch.device(device))


def build_context(spec, *, device="cuda",
                  cache: bool = True) -> ExperimentContext:
    """Build (or fetch the cached) context for a spec or preset name on
    ``device`` (``"cuda"`` by default; a CPU build must be asked for).

    The cache key ignores name/strategy/scenario/seeds — a grid over
    those axes shares one build — and the returned context carries the
    real spec (``make_engine`` needs its strategy/scenario/seeds)."""
    spec = get_experiment(spec)
    dev = require_device(device)
    if cache:
        ctx = _build_context_cached(_cache_key(spec), str(dev))
    else:
        ctx = _build(_cache_key(spec), dev)
    if ctx.spec != spec:
        ctx = dataclasses.replace(ctx, spec=spec)
    return ctx


def clear_context_cache() -> None:
    _build_context_cached.cache_clear()
