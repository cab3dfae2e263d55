"""SPMD workers that hold the sharded paths against their single-device
counterparts.

Each ``*_worker(device, ...)`` runs on every rank of a group that
:func:`~repro_torch.sharding.mesh.run_spmd` started: every rank builds the
same inputs (from numpy arrays it is handed, or from a seeded generator
on its device), runs the sharded path, and rank 0 holds the result against
the single-device path and reports.  :func:`sequence_worker` runs several
in one group.  The CPU tests (``tests/test_torch_sharding.py``,
``tests/test_torch_seq_sharded.py``) and ``chip_smoke.py`` (phase 11) call
them; they live in the package so that spawned ranks can import them.

Reports carry, per sharded call, the kernel launches of every rank
(``ops.LAUNCHES``, set to 0 just before the call and read just after) and
rank 0's collectives (``mesh.COLLECTIVES``, likewise) and seconds.  A
bitwise comparison compares the bytes (so -0 differs from +0).
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import fedprox
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.plane import LANE, ParamPlane, as_plane, tree_map
from repro_torch.sharding import mesh as shmesh
from repro_torch.sharding import plane as shplane
from repro_torch.sharding.mesh import plane_mesh

PSUM_TOL = 1e-6            # rtol = atol of the psum mode (the reference's)


def sequence_worker(device, calls: Sequence):
    """Run ``fn(device, **kwargs)`` for each ``(fn, kwargs)`` of ``calls``
    in order, in one group; the list of their reports."""
    return [fn(device, **kwargs) for fn, kwargs in calls]


# ------------------------------------------------------------ helpers --

def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _lead() -> bool:
    return dist.get_rank() == 0


def bitwise(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Same shape, dtype and bytes."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return bool(torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> dict:
    err = (got.float() - want.float()).abs()
    scale = want.float().abs()
    return {"max_abs_err": float(err.max()),
            "max_rel_err": float((err / torch.clamp(scale, min=1e-30))
                                 .max()),
            "allclose": bool(torch.all(err <= PSUM_TOL + PSUM_TOL * scale))}


def _per_rank(obj) -> list:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _agree(out) -> Optional[bool]:
    """Whether every rank holds the same bytes of ``out`` (a tensor or a
    tuple of them); None above 64 MiB, where hashing on the host costs
    more than the check is worth."""
    ts = out if isinstance(out, tuple) else (out,)
    if sum(t.numel() * t.element_size() for t in ts) > 64 << 20:
        return None
    h = hashlib.sha1()
    for t in ts:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy())
    return len(set(_per_rank(h.hexdigest()))) == 1


def counted(dev, fn: Callable):
    """``fn()`` with the launch and collective counters set to 0 just
    before and read just after (the device synchronised at both ends).
    Returns ``(result, {"launches": per-rank list, "collectives": rank
    0's {kind:axis: n}, "s": seconds})``; collective on the default
    group."""
    _sync(dev)
    ops.reset_launches()
    shmesh.reset_collectives()
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    secs = time.perf_counter() - t0
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    coll = {f"{k}:{a}": n for (k, a), n in shmesh.COLLECTIVES.items()}
    return out, {"launches": _per_rank(launches), "collectives": coll,
                 "s": secs}


def _spacing(t: torch.Tensor) -> float:
    """One f32 ulp at the largest |t|."""
    return float(np.spacing(np.float32(float(t.float().abs().max()))))


def _within(got, want, tol: float) -> dict:
    err = float((got.float() - want.float()).abs().max())
    return {"max_abs_err": err, "tol": tol, "ok": err <= tol}


def _tensor(a, dev):
    return torch.from_numpy(np.array(a)).to(dev)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


# -------------------------------------------------------------- ops -----

def op_inputs(G: int, R: int, seed: int, dev) -> dict:
    """The sharded ops' inputs from a generator on ``dev``: x (R, LANE),
    d (G, R, LANE) standard normal, w (G,) normalized positive weights;
    the proximal step's xs, g (G, R, LANE), coef (G,), active (G,)
    (one DPU inactive when G > 1)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    w = torch.rand((G,), generator=gen, device=dev) + 0.1
    active = torch.ones((G,), device=dev)
    if G > 1:
        active[G // 2] = 0.0
    return {"x": randn(R, LANE), "d": randn(G, R, LANE), "w": w / w.sum(),
            "xs": randn(G, R, LANE), "g": randn(G, R, LANE),
            "coef": torch.rand((G,), generator=gen, device=dev) + 0.5,
            "active": active}


def ops_worker(device, *, meshes, G: int = 8, R: int = 16, seed: int = 1,
               inputs: Optional[dict] = None, theta_eta: float = 0.3,
               trim_frac: float = 0.2, eta: float = 0.05, mu: float = 0.1,
               keep=None):
    """The three sharded ops at each mesh of ``meshes`` against the
    single-device ops on the same inputs (``inputs``: numpy arrays of
    :func:`op_inputs`' names, else made from ``seed``): nova exact
    (bitwise), nova psum (rtol = atol = 1e-6), robust trimmed mean and
    median (bitwise), fedprox_accum (bitwise, both outputs).  ``keep``: a
    mesh whose outputs come back as numpy arrays (``"outputs"``)."""
    dev = torch.device(device)
    lead = _lead()
    keep = None if keep is None else tuple(keep)
    t = {k: _tensor(v, dev) for k, v in inputs.items()} if inputs \
        else op_inputs(G, R, seed, dev)
    G, R = t["d"].shape[0], t["x"].shape[0]
    x, d, w = t["x"], t["d"], t["w"]
    report = {"G": G, "R": R, "meshes": {}}
    outputs = {}
    modes = ("trimmed_mean", "median")
    refs = {}
    if lead:
        refs["nova"] = ops.nova_aggregate_plane(x, d, w, theta_eta)
        for mode in modes:
            refs[mode] = ops.robust_aggregate_plane(
                x, d, theta_eta, mode=mode, trim_frac=trim_frac)
        # the single-device results against the plain versions on the
        # same tensors (on a card, the kernels'), to chip_smoke.py's
        # phase-4 bounds: two f32 ulps of the largest |x| plus theta_eta
        # times the summed values' ulps of the largest |d|; the median
        # bitwise
        sx, sd = _spacing(x), _spacing(d)
        report["kernel_vs_plain"] = {
            "nova": _within(refs["nova"], kref.nova_aggregate_ref(
                x, d, w, theta_eta), 2 * sx + theta_eta * G * sd)}
        for mode in modes:
            kw = ops.robust_kwargs(G, mode, trim_frac)
            m = G - 2 * kw["k"]
            report["kernel_vs_plain"][mode] = _within(
                refs[mode], kref.robust_aggregate_ref(x, d, theta_eta, **kw),
                0.0 if kw["median"] else 2 * sx + theta_eta * 2 * m * sd)
    for shape in meshes:
        m = plane_mesh(shape)
        rec = {}
        for reduce in shplane.REDUCE_MODES:
            out, c = counted(dev, lambda: shplane.nova_aggregate_plane_sharded(
                x, d, w, theta_eta, mesh=m, reduce=reduce))
            c["ranks_agree"] = _agree(out)
            if lead:
                c["bitwise"] = bitwise(out, refs["nova"])
                c.update(_rel_err(out, refs["nova"]))
            rec[f"nova_{reduce}"] = c
            if tuple(shape) == keep:
                outputs[f"nova_{reduce}"] = _np(out)
        for mode in modes:
            out, c = counted(
                dev, lambda: shplane.robust_aggregate_plane_sharded(
                    x, d, theta_eta, mesh=m, mode=mode, trim_frac=trim_frac))
            c["ranks_agree"] = _agree(out)
            if lead:
                c["bitwise"] = bitwise(out, refs[mode])
            rec[f"robust_{mode}"] = c
            if tuple(shape) == keep:
                outputs[f"robust_{mode}"] = _np(out)
        report["meshes"][str(tuple(shape))] = rec
    del d, refs, t["d"]
    xs, g, coef, act = t["xs"], t["g"], t["coef"], t["active"]
    acc = torch.zeros_like(xs)
    ref_k = None
    if lead:
        ref_k = ops.fedprox_accum_plane(xs, g, x, acc, coef, act, eta, mu)
        plain = kref.fedprox_accum_ref(xs, g, x, acc, coef, act, eta, mu)
        tol = 2 * max(_spacing(xs), _spacing(g), _spacing(x))
        a, b = (_within(k, p_, tol) for k, p_ in zip(ref_k, plain))
        report["kernel_vs_plain"]["fedprox_accum"] = {
            "max_abs_err": max(a["max_abs_err"], b["max_abs_err"]),
            "tol": tol, "ok": a["ok"] and b["ok"]}
    for shape in meshes:
        m = plane_mesh(shape)
        out, c = counted(dev, lambda: shplane.fedprox_accum_plane_sharded(
            xs, g, x, acc, coef, act, eta, mu, mesh=m))
        c["ranks_agree"] = _agree(out)
        if lead:
            c["bitwise"] = bitwise(out[0], ref_k[0]) and bitwise(out[1],
                                                                ref_k[1])
        report["meshes"][str(tuple(shape))]["fedprox_accum"] = c
        if tuple(shape) == keep:
            outputs["fedprox_x"], outputs["fedprox_acc"] = map(_np, out)
        del out
    if keep is not None:
        report["outputs"] = outputs
    return report if lead else None


def mesh_checks(device):
    """``plane_mesh`` and ``EngineOptions.mesh_shape`` validation on the
    default group: the errors each bad shape raises, the default shape,
    and one mesh per shape (the cache)."""
    from repro_torch.core.api import EngineOptions

    world = dist.get_world_size()
    out = {"world": world,
           "default_shape": plane_mesh(None).shape,
           "cached": plane_mesh((world, 1)) is plane_mesh((world, 1))}
    for name, fn in (("too_big", lambda: plane_mesh((world, 2))),
                     ("zero", lambda: plane_mesh((0, 1))),
                     ("opts_too_big", lambda: EngineOptions(
                         mesh_shape=(world + 1, 1)))):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    out["opts_ok"] = EngineOptions(mesh_shape=[world, 1]).mesh_shape
    return out if _lead() else None


# ------------------------------------------------------------ round -----

def _classifier(input_shape, hidden, dev, p0=None):
    """(params on ``dev``, loss_fn, accuracy fn) of a classifier: params
    from the numpy tree ``p0``, else drawn from a CPU generator seeded 0
    (the same on every rank and device)."""
    from repro_torch.configs.cefl_paper import ClassifierConfig
    from repro_torch.models import classifier as cls

    cfg = ClassifierConfig(input_shape=tuple(input_shape),
                           hidden=tuple(hidden))
    if p0 is None:
        params = cls.init_classifier_params(torch.Generator().manual_seed(
            0), cfg, device="cpu")
        params = tree_map(lambda v: v.to(dev), params)
    else:
        params = cls.params_from_numpy(p0, device=dev)
    return params, cls.classifier_loss, cls.classifier_accuracy


def round_datasets(G: int, examples: int, input_shape, seed: int = 0):
    """G numpy DPU datasets of ``examples`` normal images and labels."""
    rng = np.random.RandomState(seed)
    return [{"x": rng.normal(size=(examples,) + tuple(input_shape))
             .astype(np.float32),
             "y": rng.randint(0, 10, size=(examples,)).astype(np.int32)}
            for _ in range(G)]


def round_worker(device, *, meshes, G: int = 4, examples: int = 64,
                 input_shape=(10, 10, 1), hidden=(32,), gamma: int = 3,
                 m_frac: float = 0.25, eta: float = 0.05, mu: float = 0.1,
                 theta: float = 1.0, seed: int = 7, reduces=("exact",),
                 eval_examples: int = 0, staged=None, p0=None,
                 staged_meshes=()):
    """``local_round_plane_sharded`` at each mesh and ``reduces`` mode
    against ``fedprox.local_round_plane`` on the same datasets and the
    same generator seed: params and losses bitwise (and allclose, for
    psum), the eval accuracy when ``eval_examples``.  ``staged`` (numpy,
    the ten arguments of ``_plane_round_fn``) with ``p0`` (the numpy
    params): ``_sharded_round_fn`` at each of ``staged_meshes``, both
    modes, its outputs returned as numpy."""
    dev = torch.device(device)
    lead = _lead()
    params, loss_fn, acc_fn = _classifier(input_shape, hidden, dev, p0)
    data = [{k: _tensor(v, dev) for k, v in d.items()}
            for d in round_datasets(G, examples, input_shape)]
    eval_fn = None
    if eval_examples:
        ev = round_datasets(1, eval_examples, input_shape, seed=99)[0]
        ex, ey = _tensor(ev["x"], dev), _tensor(ev["y"], dev).long()

        def eval_fn(p):
            return acc_fn(p, ex, ey)

    kw = dict(gamma=gamma, m_frac=m_frac, eta=eta, mu=mu, theta=theta,
              eval_fn=eval_fn)

    def gen():
        return torch.Generator(device=dev).manual_seed(seed)

    ref = fedprox.local_round_plane(params, loss_fn, data, generator=gen(),
                                    **kw)
    report = {"G": G, "meshes": {}}
    for shape in meshes:
        m = plane_mesh(shape)
        for reduce in reduces:
            (new, losses, acc), c = counted(
                dev, lambda: shplane.local_round_plane_sharded(
                    params, loss_fn, data, generator=gen(), mesh=m,
                    reduce=reduce, **kw))
            c["params_bitwise"] = bitwise(new.data, ref[0].data)
            c["losses_bitwise"] = bool(np.array_equal(
                np.asarray(losses).view(np.uint32),
                np.asarray(ref[1]).view(np.uint32)))
            c["acc_equal"] = acc == ref[2]
            c.update(_rel_err(new.data, ref[0].data))
            report["meshes"][f"{tuple(shape)} {reduce}"] = c
    if staged is not None:
        plane = as_plane(params)
        args = _staged_tensors(staged, dev)
        single = fedprox._plane_round_fn(loss_fn, plane.spec)(*args)
        report["staged"] = {"single": [_np(single[0]), _np(single[1])]}
        for shape in staged_meshes:
            for reduce in shplane.REDUCE_MODES:
                run = shplane._sharded_round_fn(
                    loss_fn, plane.spec, plane_mesh(shape), reduce=reduce)
                (new, losses, _), c = counted(dev, lambda: run(*args))
                c["new"], c["losses"] = _np(new), _np(losses)
                report["staged"][f"{tuple(shape)} {reduce}"] = c
    return report if lead else None


def _staged_tensors(staged, dev):
    """The numpy ten-tuple of ``_plane_round_fn`` as tensors on ``dev``."""
    p0, anchor, data_stack, idx, weights, a, eta, mu, w_abs, te = staged
    return (_tensor(p0, dev), _tensor(anchor, dev),
            {k: _tensor(v, dev) for k, v in data_stack.items()},
            _tensor(idx, dev).long(), _tensor(weights, dev),
            _tensor(a, dev), float(eta), float(mu), _tensor(w_abs, dev),
            float(te))


def batch_count_worker(device, *, mesh, G: int = 8, examples: int = 64,
                       input_shape=(28, 28, 1), hidden=(200, 100),
                       gamma: int = 3, m_frac: float = 0.5,
                       eta: float = 0.05, mu: float = 0.1, seed: int = 7,
                       threads: Optional[int] = None):
    """Where the sharded round's bits come from at a 'dpu' split: the
    round at ``mesh`` against the single-device round, and the per-DPU
    gradients of the group's batched loss at its first local step taken
    at the two batch counts (all G DPUs in one ``loss_fn`` call, and in
    the rank's G/d-DPU slices).  The round may differ from the
    single-device one only if the gradients do.  ``threads``: the CPU
    threads of each rank meanwhile (a BLAS may block its products by
    thread count too)."""
    dev = torch.device(device)
    before = torch.get_num_threads()
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        out = _batch_count(dev, mesh, G, examples, input_shape, hidden,
                           gamma, m_frac, eta, mu, seed)
    finally:
        torch.set_num_threads(before)
    return out if _lead() else None


def _batch_count(dev, mesh, G, examples, input_shape, hidden, gamma, m_frac,
                 eta, mu, seed):
    m = plane_mesh(mesh)
    params, loss_fn, _ = _classifier(input_shape, hidden, dev)
    data = [{k: _tensor(v, dev) for k, v in d.items()}
            for d in round_datasets(G, examples, input_shape)]
    kw = dict(gamma=gamma, m_frac=m_frac, eta=eta, mu=mu, theta=1.0)

    def gen():
        return torch.Generator(device=dev).manual_seed(seed)

    ref = fedprox.local_round_plane(params, loss_fn, data, generator=gen(),
                                    **kw)
    new, losses, _ = shplane.local_round_plane_sharded(
        params, loss_fn, data, generator=gen(), mesh=m, **kw)
    # the first local step's batched gradient at both batch counts, on
    # the round's own staged inputs
    plane = as_plane(params)
    Ds, bucket = fedprox._group_layout(data, m_frac)
    stack, idx, wts = fedprox._stage_group_batches(
        data, gen(), Ds, bucket, gamma, m_frac, dev)
    p = plane.broadcast(G).data.contiguous()
    dpus = torch.arange(G, device=dev)[:, None]
    batch = {k: v[dpus, idx[0]] for k, v in stack.items()}

    def grads(sl):
        leaf = p[sl].detach().requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(plane.spec.unflatten_batched(leaf),
                           {k: v[sl] for k, v in batch.items()}, wts[0][sl])
            return torch.autograd.grad(loss.sum(), leaf)[0]

    whole = grads(slice(0, G))
    n = G // m.size(shmesh.DPU_AXIS)
    split = torch.cat([grads(slice(i, i + n)) for i in range(0, G, n)])
    out = {"G": G, "dpu_split": n, "round_bitwise": bitwise(new.data,
                                                            ref[0].data),
           "losses_bitwise": bool(np.array_equal(np.asarray(losses),
                                                 np.asarray(ref[1]))),
           "grads_bitwise": bitwise(whole, split),
           "grads_max_abs_err": float((whole - split).abs().max())}
    out.update(_rel_err(new.data, ref[0].data))
    return out


# ----------------------------------------------------------- engine -----

def make_world(dev, *, num_ue=4, num_bs=2, num_dc=2, pool=2000,
               input_shape=(10, 10, 1), hidden=(32,), eval_examples=300,
               net_seed=0, L=5.0, zeta1=2.0, zeta2=1.0):
    """A CE-FL world made from seeds on every rank alike: the network,
    the image pool, the classifier's initial params (drawn on the CPU)
    and an eval function on ``eval_examples`` held-out images."""
    from repro_torch.core.convergence import MLConstants
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.network.topology import NetworkConfig, make_network

    net = make_network(NetworkConfig(num_ue=num_ue, num_bs=num_bs,
                                     num_dc=num_dc, seed=net_seed))
    (trx, try_), (tex, tey) = make_image_dataset(pool, tuple(input_shape),
                                                 seed=0)
    params, loss_fn, acc_fn = _classifier(input_shape, hidden, dev)
    nd = num_ue + num_dc
    consts = MLConstants(L=L, theta_i=np.ones(nd) * 2,
                         sigma_i=np.ones(nd) * 3, zeta1=zeta1, zeta2=zeta2)
    ex = torch.from_numpy(tex[:eval_examples]).to(dev)
    ey = torch.from_numpy(tey[:eval_examples]).to(dev)

    def eval_fn(p):
        return acc_fn(p, ex, ey)

    return {"net": net, "train": (trx, try_), "p0": params,
            "loss_fn": loss_fn, "eval_fn": eval_fn, "consts": consts}


def _engine_run(dev, world, *, strategy, rounds, mean_arrivals,
                std_arrivals, executor=None, eta=0.05, **opts):
    from repro_torch.core.api import EngineOptions
    from repro_torch.core.engine import Engine
    from repro_torch.data.synthetic import make_online_ues
    from repro_torch.solver.objective import ObjectiveWeights

    trx, try_ = world["train"]
    eng = Engine(world["net"], strategy, consts=world["consts"],
                 ow=ObjectiveWeights(T=rounds),
                 opts=EngineOptions(rounds=rounds, seed=0, eta=eta, **opts),
                 executor=executor, device=dev)
    ues = make_online_ues(trx, try_, num_ue=world["net"].dims[0],
                          mean_arrivals=mean_arrivals,
                          std_arrivals=std_arrivals, seed=0)
    return eng.run(ues, init_params=world["p0"], loss_fn=world["loss_fn"],
                   eval_fn=world["eval_fn"])


def _params_plane(res) -> torch.Tensor:
    return ParamPlane.from_tree(res.params).data


def engine_worker(device, *, meshes, world=None, strategy="fednova",
                  rounds=3, mean_arrivals=200.0, std_arrivals=20.0,
                  eta=0.05):
    """The engine under ``strategy`` with ``EngineOptions(mesh_shape=...)``
    at each mesh against the single-device run: per-round accuracy and
    loss, final params (bitwise, else the largest error), the sharded
    fused rounds counted (``ROUNDS["fused"]``) and each rank's kernel
    launches."""
    dev = torch.device(device)
    w = make_world(dev, **(world or {}))
    kw = dict(strategy=strategy, rounds=rounds, mean_arrivals=mean_arrivals,
              std_arrivals=std_arrivals, eta=eta)
    ref, rc = counted(dev, lambda: _engine_run(dev, w, **kw))
    ref_plane = _params_plane(ref)
    report = {"single": {"acc": ref.series("acc"), "loss": ref.series("loss"),
                         "s": rc["s"], "launches": rc["launches"][0]},
              "meshes": {}}
    for shape in meshes:
        shplane.reset_rounds()
        res, c = counted(dev, lambda: _engine_run(dev, w, mesh_shape=shape,
                                                  **kw))
        plane = _params_plane(res)
        c.update(acc=res.series("acc"), loss=res.series("loss"),
                 fused_rounds=shplane.ROUNDS["fused"],
                 acc_equal=res.series("acc") == ref.series("acc"),
                 loss_equal=res.series("loss") == ref.series("loss"),
                 params_bitwise=bitwise(plane, ref_plane))
        c.update(_rel_err(plane, ref_plane))
        report["meshes"][str(tuple(shape))] = c
    return report if _lead() else None


def mesh_executor_worker(device, *, mesh, world=None, strategy="fixed:0",
                         rounds=2, mean_arrivals=120.0, std_arrivals=12.0,
                         eta=0.05, solver_outer=2):
    """``MeshExecutor(mesh_shape=mesh)`` against ``MeshExecutor()``: the
    loss series and final params (the reference's contract is allclose,
    atol 1e-5), the sharded steps counted (``ROUNDS["mesh"]``) and each
    rank's kernel launches."""
    from repro_torch.core.engine import MeshExecutor

    dev = torch.device(device)
    w = make_world(dev, **(world or {}))
    kw = dict(strategy=strategy, rounds=rounds, mean_arrivals=mean_arrivals,
              std_arrivals=std_arrivals, eta=eta, solver_outer=solver_outer)
    ref = _engine_run(dev, w, executor=MeshExecutor(), **kw)
    shplane.reset_rounds()
    res, c = counted(dev, lambda: _engine_run(
        dev, w, executor=MeshExecutor(mesh_shape=tuple(mesh)), **kw))
    got, want = _params_plane(res), _params_plane(ref)
    c.update(loss=res.series("loss"), ref_loss=ref.series("loss"),
             loss_max_abs_err=float(np.max(np.abs(
                 np.asarray(res.series("loss"))
                 - np.asarray(ref.series("loss"))))),
             params_max_abs_err=float((got - want).abs().max()),
             params_bitwise=bitwise(got, want),
             mesh_steps=shplane.ROUNDS["mesh"])
    return c if _lead() else None


def cli_worker(device, *, argvs):
    """``python -m repro_torch.experiments`` ``main(argv)`` for each argv
    of ``argvs`` on every rank; rank 0's standard output of each (the
    other ranks print nothing) and the sharded rounds each counted."""
    from repro_torch.experiments.__main__ import main

    outs = []
    for argv in argvs:
        shplane.reset_rounds()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            main(list(argv))
        outs.append({"stdout": buf.getvalue(),
                     "fused_rounds": shplane.ROUNDS["fused"],
                     "silent_ranks": all(
                         not s for s in _per_rank(buf.getvalue())[1:])})
    return outs if _lead() else None


# ----------------------------------------------------------- decode -----

def decode_worker(device, *, B=2, S=64, Hq=6, Hkv=2, D=32,
                  dtype="float32", cache_lens=(40, 64), window=None,
                  seed=3, inputs=None, keep_outputs=False):
    """``attention.decode_attention_seq_sharded`` with the (B, S, Hkv, D)
    caches split over the ranks of the default group, against the
    single-device decode on the whole caches: the plain version
    (``decode_attention_plain``) and the ``ops.swa_decode_attention``
    dispatch (the kernel on a CUDA tensor; only without ``window``).
    ``inputs``: numpy q, k, v; else drawn on the device from ``seed``.
    Reports per ``cache_len`` the outputs' max errors against the plain
    f32 result and each other, and the collectives (one MAX, two SUM per
    call); the outputs as numpy with ``keep_outputs``."""
    from repro_torch.models import attention as attn
    from repro_torch.models.common import ShardCtx

    dev = torch.device(device)
    dt = getattr(torch, dtype)
    if inputs is not None:
        q, k, v = (_tensor(inputs[n], dev).to(dt) for n in ("q", "k", "v"))
        B, S, Hkv, D = k.shape
    else:
        gen = torch.Generator(device=dev).manual_seed(seed)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                   for shape in ((B, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    report = {"B": B, "S": S, "Hq": q.shape[1], "Hkv": Hkv, "D": D,
              "dtype": dtype, "cases": {}}
    ctx = ShardCtx(mesh=dist.group.WORLD, seq_shard_decode=True)
    n = ctx.shards
    s_loc = S // n
    kl = k[:, ctx.shard * s_loc:(ctx.shard + 1) * s_loc].contiguous()
    vl = v[:, ctx.shard * s_loc:(ctx.shard + 1) * s_loc].contiguous()
    for cl in cache_lens:
        out, c = counted(dev, lambda: attn.decode_attention_seq_sharded(
            q, kl, vl, cl, ctx=ctx, window=window))
        if not _lead():
            continue
        plain = attn.decode_attention_plain(q, k, v, cl, window=window)
        plain32 = attn.decode_attention_plain(q.float(), k.float(),
                                              v.float(), cl, window=window)
        c["vs_plain_f32"] = float((out.float() - plain32).abs().max())
        c["plain_vs_plain_f32"] = float((plain.float() - plain32)
                                        .abs().max())
        c["vs_plain_bitwise"] = bitwise(out, plain)
        c["v_absmax"] = float(v.float().abs().max())
        if window is None:
            _sync(dev)
            ops.reset_launches()
            single = ops.swa_decode_attention(q, k, v, cl)
            _sync(dev)
            c["single_launches"] = dict(ops.LAUNCHES)
            c["single_vs_plain_f32"] = float((single.float() - plain32)
                                             .abs().max())
            c["vs_single"] = float((out.float() - single.float()).abs()
                                   .max())
            if keep_outputs:
                c["single"] = _np(single)
        if keep_outputs:
            c["out"], c["plain"], c["plain_f32"] = (_np(out), _np(plain),
                                                    _np(plain32))
        c["ok_shapes"] = tuple(out.shape) == (B, q.shape[1], D)
        report["cases"][cl] = c
    return report if _lead() else None


def lm_decode_worker(device, *, arch="starcoder2-15b", layers=None,
                     reduced_cfg=True, dtype="float32", batch=2,
                     prompt=40, cache_len=64, steps=3, seed=11,
                     logits_atol=5e-4):
    """``lm_decode_step(..., ctx=...)`` on the sequence-sharded cache
    (``lm.shard_cache`` of one prefill, split over the default group)
    against the single-device step,
    ``steps`` steps, both fed the single-device greedy token: the largest
    logit error (within ``logits_atol``?) and whether the greedy tokens
    agree where the margin exceeds 2 * ``logits_atol``; each rank's
    ``swa_decode_attention`` launches in the sharded steps (none: the
    sharded attention is plain torch)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduced
    from repro_torch.models import lm as L
    from repro_torch.models.common import ShardCtx

    dev = torch.device(device)
    cfg = get_config(arch)
    if reduced_cfg:
        cfg = reduced(cfg)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    ctx = ShardCtx(mesh=dist.group.WORLD, seq_shard_decode=True)
    dt = getattr(torch, dtype)
    params = L.init_lm_params(torch.Generator(device=dev).manual_seed(seed),
                              cfg, dt)
    prompts = torch.from_numpy(np.random.RandomState(seed + 1).randint(
        0, cfg.vocab_size, (batch, prompt))).to(dev)
    logits, cache = L.prefill(params, cfg, prompts, cache_len)
    sh_cache = L.shard_cache(cache, ctx)
    worst, clear, agree = 0.0, 0, True
    launches = []
    for _ in range(steps):
        tok = torch.argmax(logits, dim=-1)
        logits, cache = L.lm_decode_step(params, cfg, tok, cache)
        (sh_logits, sh_cache), c = counted(
            dev, lambda: L.lm_decode_step(params, cfg, tok, sh_cache,
                                          ctx=ctx))
        launches.append(c["launches"])
        err = float((sh_logits - logits).abs().max())
        worst = max(worst, err)
        top2 = torch.topk(logits, 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * logits_atol
        same = torch.argmax(sh_logits, dim=-1) == torch.argmax(logits,
                                                               dim=-1)
        agree = agree and bool(torch.all(same[sure]))
        clear += int(sure.sum())
    out = {"arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "dtype": dtype, "batch": batch, "prompt": prompt,
           "cache_rows": int(cache["blocks"]["layer_0"]["k"].shape[2]),
           "shards": ctx.shards, "steps": steps,
           "logits_max_abs_err": worst, "logits_atol": logits_atol,
           "ok": worst <= logits_atol and agree,
           "tokens_agree_where_clear": agree, "clear_margins": clear,
           "sharded_launches": launches,
           "finite": bool(torch.isfinite(sh_logits).all())}
    return out if _lead() else None
