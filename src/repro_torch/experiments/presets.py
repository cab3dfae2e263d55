"""Named experiment presets — the registry's built-ins.  Counterpart of
``repro.experiments.presets``: every preset, with the same values.

Each name maps to a fully specified :class:`~repro_torch.experiments.spec.
ExperimentSpec`; the paper touchstones reference the table/figure they
reproduce.  Override any axis from the CLI::

    python -m repro_torch.experiments run quickstart --device cpu
    python -m repro_torch.experiments run campus_walk_vs_fixed \
        --set strategy=fixed:0 --seeds 0,1,2

The LM presets (``lm_smoke``, ``lm_mamba2_130m``) run through
``repro_torch.experiments.lm.run_lm``.
"""
from __future__ import annotations

from repro_torch.experiments.spec import (ConstsSpec, DataSpec, EngineSpec,
                                    ExperimentSpec, ModelSpec, NetworkSpec,
                                    ObjectiveSpec, register_experiment)


@register_experiment("quickstart")
def quickstart() -> ExperimentSpec:
    """CE-FL on a 6-UE / 3-BS / 2-DC synthetic edge network in ~a minute
    on CPU — the README front-door experiment."""
    return ExperimentSpec(
        name="quickstart",
        model=ModelSpec(input_shape=(14, 14, 1), hidden=(64,)),
        data=DataSpec(pool=6000, mean_arrivals=300.0, std_arrivals=30.0),
        network=NetworkSpec(num_ue=6, num_bs=3, num_dc=2),
        consts=ConstsSpec(mode="fixed", L=5.0, theta=2.0, sigma=3.0),
        engine=EngineSpec(rounds=8, eta=0.1, solver_outer=2,
                          reoptimize_every=4),
        strategy="cefl", scenario="static", seeds=(0,))


@register_experiment("paper_table1")
def paper_table1() -> ExperimentSpec:
    """Tables I-II grid cell (F-MNIST-like, paper-size 20/10/5 network,
    estimated constants): sweep ``strategy`` over cefl/fednova/fedavg and
    the seed list to reproduce energy/delay-to-accuracy rows."""
    return ExperimentSpec(
        name="paper_table1",
        model=ModelSpec(input_shape=(28, 28, 1), hidden=(200, 100)),
        data=DataSpec(pool=48000, mean_arrivals=2000.0,
                      std_arrivals=200.0, eval_examples=1000),
        network=NetworkSpec(num_ue=20, num_bs=10, num_dc=5),
        consts=ConstsSpec(mode="estimate", estimate_iters=8),
        objective=ObjectiveSpec(xi1=1.0, xi2=1e-2, xi3=2.0),
        engine=EngineSpec(rounds=40, eta=0.1, solver_outer=4,
                          reoptimize_every=3),
        strategy="cefl", scenario="static", seeds=(0, 1, 2))


@register_experiment("campus_walk_vs_fixed")
def campus_walk_vs_fixed() -> ExperimentSpec:
    """The mobility story (paper Sec. III / Figs. 3-4 dynamics): random-
    waypoint pedestrians, network re-derived every round, the floating
    aggregation point chasing the data.  Run as-is for cefl, and with
    ``--set strategy=fixed:0`` for the baseline that cannot float."""
    return ExperimentSpec(
        name="campus_walk_vs_fixed",
        model=ModelSpec(input_shape=(14, 14, 1), hidden=(32,)),
        data=DataSpec(pool=6000, mean_arrivals=300.0, std_arrivals=30.0,
                      eval_examples=400),
        network=NetworkSpec(num_ue=8, num_bs=4, num_dc=3),
        consts=ConstsSpec(mode="fixed", L=4.0, theta=2.0, sigma=1.0),
        engine=EngineSpec(rounds=20, eta=0.1, solver_outer=2,
                          reoptimize_every=1),
        strategy="cefl", scenario="campus_walk", seeds=(0,))


@register_experiment("label_shift_drift")
def label_shift_drift() -> ExperimentSpec:
    """Pure concept drift (paper Definition 1): static radio plane,
    labels rotating one class every 4 rounds."""
    return ExperimentSpec(
        name="label_shift_drift",
        model=ModelSpec(input_shape=(14, 14, 1), hidden=(64,)),
        data=DataSpec(pool=6000, mean_arrivals=300.0, std_arrivals=30.0),
        network=NetworkSpec(num_ue=8, num_bs=4, num_dc=3),
        consts=ConstsSpec(mode="fixed", L=4.0, theta=2.0, sigma=1.0),
        engine=EngineSpec(rounds=12, eta=0.1, solver_outer=2,
                          reoptimize_every=2),
        strategy="cefl", scenario="label_shift:4", seeds=(0, 1))


@register_experiment("sweep_smoke")
def sweep_smoke() -> ExperimentSpec:
    """CI-sized multi-seed sweep (2 seeds, 3 rounds, tiny net/model) —
    the spec the sweep smoke job and the parity tests run."""
    return ExperimentSpec(
        name="sweep_smoke",
        model=ModelSpec(input_shape=(8, 8, 1), hidden=(16,)),
        data=DataSpec(pool=2000, mean_arrivals=120.0, std_arrivals=12.0,
                      eval_examples=200),
        network=NetworkSpec(num_ue=4, num_bs=2, num_dc=2),
        consts=ConstsSpec(mode="fixed", L=5.0, theta=2.0, sigma=3.0),
        engine=EngineSpec(rounds=3, eta=0.1, solver_outer=2,
                          reoptimize_every=1),
        strategy="greedy_data", scenario="campus_walk", seeds=(0, 1))


@register_experiment("sweep_bench")
def sweep_bench() -> ExperimentSpec:
    """The 8-seed sweep the reference's sweep benchmark times
    (``benchmarks/sweep_bench.py`` -> BENCH_sweep.json)."""
    return ExperimentSpec(
        name="sweep_bench",
        model=ModelSpec(input_shape=(14, 14, 1), hidden=(64,)),
        data=DataSpec(pool=4000, mean_arrivals=200.0, std_arrivals=20.0,
                      eval_examples=400),
        network=NetworkSpec(num_ue=6, num_bs=3, num_dc=2),
        consts=ConstsSpec(mode="fixed", L=5.0, theta=2.0, sigma=3.0),
        engine=EngineSpec(rounds=6, eta=0.1, solver_outer=2,
                          reoptimize_every=1),
        strategy="greedy_data", scenario="static",
        seeds=(0, 1, 2, 3, 4, 5, 6, 7))


@register_experiment("lm_smoke")
def lm_smoke() -> ExperimentSpec:
    """Mesh-native CE-FL LM training, smoke-sized (the old
    ``launch/train.py`` defaults with --reduced)."""
    return ExperimentSpec(
        name="lm_smoke",
        model=ModelSpec(kind="lm", arch="mamba2-130m", reduced=True,
                        batch=8, seq=256, n_dpu=2, n_micro=1, gamma=1),
        engine=EngineSpec(rounds=20, eta=3e-2, mu=0.01),
        strategy="fixed:0", scenario="static", seeds=(0,))


@register_experiment("lm_mamba2_130m")
def lm_mamba2_130m() -> ExperimentSpec:
    """The full 130M-parameter mamba2 CE-FL run."""
    return ExperimentSpec(
        name="lm_mamba2_130m",
        model=ModelSpec(kind="lm", arch="mamba2-130m", reduced=False,
                        batch=8, seq=512, n_dpu=2, n_micro=1, gamma=2),
        engine=EngineSpec(rounds=200, eta=3e-2, mu=0.01),
        strategy="fixed:0", scenario="static", seeds=(0,))


@register_experiment("bench_quick")
def bench_quick() -> ExperimentSpec:
    """The QUICK=1 benchmark harness cell (``benchmarks/common.setup``):
    scaled-down network/model so the whole suite fits one CPU core."""
    return ExperimentSpec(
        name="bench_quick",
        model=ModelSpec(input_shape=(14, 14, 1), hidden=(64,)),
        data=DataSpec(pool=8000, mean_arrivals=400.0, std_arrivals=40.0,
                      eval_examples=1000),
        network=NetworkSpec(num_ue=8, num_bs=4, num_dc=3),
        consts=ConstsSpec(mode="estimate", estimate_iters=3),
        objective=ObjectiveSpec(xi1=1.0, xi2=1e-2, xi3=2.0),
        engine=EngineSpec(rounds=10, eta=0.1, solver_outer=2,
                          reoptimize_every=3),
        strategy="cefl", scenario="static", seeds=(0,))


@register_experiment("bench_paper")
def bench_paper() -> ExperimentSpec:
    """The QUICK=0 benchmark harness cell: the paper's 20/10/5 topology
    and full-size F-MNIST-like task."""
    return ExperimentSpec(
        name="bench_paper",
        model=ModelSpec(input_shape=(28, 28, 1), hidden=(200, 100)),
        data=DataSpec(pool=48000, mean_arrivals=2000.0,
                      std_arrivals=200.0, eval_examples=1000),
        network=NetworkSpec(num_ue=20, num_bs=10, num_dc=5),
        consts=ConstsSpec(mode="estimate", estimate_iters=8),
        objective=ObjectiveSpec(xi1=1.0, xi2=1e-2, xi3=2.0),
        engine=EngineSpec(rounds=40, eta=0.1, solver_outer=4,
                          reoptimize_every=3),
        strategy="cefl", scenario="static", seeds=(0,))
