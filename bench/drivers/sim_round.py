"""Driver ``sim_round``: the CE-FL simulation round at paper width, through
the program's ``Engine.begin_round`` / ``execute_round`` /
``finish_round``, rounds back to back (a closed loop).

Set-up makes the world from the seed (image pool, per-UE arrivals,
network, initial weights), estimates the constants as the program's
front door does, and drives the engine's first ``WARM`` rounds through
the same calls the window makes.  The reference follows the first three
of them from the initial weights and, for every round of the run,
replays the rate jitter and the offloading from the engine seed and
re-costs the round.
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from bench import inputs
from bench.reference import cefl as ref
from bench.reference.compare import change_norms, norm_gap, rel_gap

WARM = 4          # set-up rounds: two plans solved (t = 0 and the re-solve at 3)
FOLLOWED = 3      # set-up rounds the reference trains through
HOST_SPANS = ("decide", "offload", "device_round", "account")


def _dims(cfg):
    m = cfg["model"]
    return [int(np.prod(m["input_shape"]))] + list(m["hidden"]) \
        + [m["num_classes"]]


class SimRound:
    host_spans = HOST_SPANS

    def __init__(self, cfg: dict, wl: dict, seed: int, device, tracer):
        self.cfg, self.wl, self.device, self.tr = cfg, wl, device, tracer
        (self.pool_seed, self.ue_seed, self.engine_seed,
         self.weight_seed) = inputs.sub_seeds(seed, 4)
        self.records = []
        self.followed = []

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from repro_torch.core.engine import Engine
        from repro_torch.experiments import build, spec as S
        from repro_torch.models.classifier import (classifier_accuracy,
                                                   classifier_loss)
        from repro_torch.network.topology import Network, NetworkConfig
        from repro_torch.solver.objective import ObjectiveWeights

        c, dev = self.cfg, self.device
        m, d, net, e = c["model"], c["data"], c["network"], c["engine"]
        (trx, tr_y), (tex, te_y) = inputs.image_pool(
            d["pool"], tuple(m["input_shape"]), m["num_classes"],
            self.pool_seed)
        self.pool = (trx, tr_y)
        self.eval_xy = (torch.from_numpy(tex[:d["eval_examples"]]).to(dev),
                        torch.from_numpy(te_y[:d["eval_examples"]]).to(dev))
        self.ues = inputs.arrivals(
            trx, tr_y, num_ue=net["num_ue"], labels_per_ue=d["labels_per_ue"],
            mean=d["mean_arrivals"], std=d["std_arrivals"], seed=self.ue_seed)
        self.rates = inputs.network_rates(net)
        netcfg = NetworkConfig(**{k: tuple(v) if isinstance(v, list) else v
                                  for k, v in net.items()})
        world = Network(cfg=netcfg, **self.rates)
        p0 = inputs.classifier_weights(_dims(c), self.weight_seed, dev)
        spec = S.ExperimentSpec(
            model=S.ModelSpec(input_shape=tuple(m["input_shape"]),
                              hidden=tuple(m["hidden"]),
                              num_classes=m["num_classes"]),
            data=S.DataSpec(pool=d["pool"], mean_arrivals=d["mean_arrivals"],
                            std_arrivals=d["std_arrivals"],
                            labels_per_ue=d["labels_per_ue"],
                            eval_examples=d["eval_examples"]),
            network=S.NetworkSpec(num_ue=net["num_ue"], num_bs=net["num_bs"],
                                  num_dc=net["num_dc"],
                                  topology_seed=net["seed"]),
            consts=S.ConstsSpec(**c["consts"]),
            objective=S.ObjectiveSpec(**c["objective"]),
            engine=S.EngineSpec(**e), strategy=self.wl["strategy"],
            scenario=self.wl["scenario"], seeds=(self.engine_seed,))
        consts = build._build_consts(spec, p0, trx, tr_y, dev)
        o = spec.objective
        ow = ObjectiveWeights(xi1=o.xi1, xi2=o.xi2, xi3=o.xi3, drift=o.drift,
                              T=e["rounds"])
        ex, ey = self.eval_xy
        self.engine = Engine(world, consts=consts, ow=ow,
                             opts=spec.engine_options(self.engine_seed),
                             device=dev)
        self.state = self.engine.init_loop(
            self.ues, init_params=p0, loss_fn=classifier_loss,
            eval_fn=lambda p: classifier_accuracy(p, ex, ey))
        self._trace_decide()
        for _ in range(WARM):
            self.round()

    def _trace_decide(self) -> None:
        if not self.tr.enabled:
            return
        decide = self.engine.decide

        def traced(*a, **kw):
            with self.tr.span("decide", sync=True):
                return decide(*a, **kw)
        self.engine.decide = traced

    # ------------------------------------------------------------- round
    def round(self) -> bool:
        from repro_torch.core import fedprox
        from repro_torch.kernels.plane import as_tree
        eng, st, tr = self.engine, self.state, self.tr
        t0 = time.perf_counter()
        staged = eng.begin_round(st, self.ues)
        t1 = time.perf_counter()
        if tr.enabled:
            tr.add_span("offload", t0, t1)
            plan = staged.plan
            gam = np.maximum(np.rint(plan.gamma.numpy()), 1)
            ms = np.clip(plan.m.numpy(), 0.05, 1.0)
            tr.count("train_examples", float(sum(
                g * fedprox.batch_size(len(dd["y"]), mm)
                for g, mm, dd in zip(gam, ms, staged.datasets)
                if dd is not None and len(dd["y"]))))
        with tr.span("device_round", sync=True):
            loss, acc = eng.execute_round(st, staged)
        with tr.span("account"):
            rep = eng.finish_round(st, staged, loss, acc)
        self.records.append({
            "ue_idx": [u.last_idx.astype(np.int32) for u in self.ues],
            "plan": {k: v.numpy().copy()
                     for k, v in staged.plan.to_w().items()},
            "energy": rep.energy, "delay": rep.delay,
            "dc_points": tuple(rep.dc_points), "loss": rep.loss})
        if len(self.followed) < FOLLOWED:
            self.followed.append({k: v.detach().clone() for k, v in
                                  as_tree(st.params).items()})
        return bool(np.isfinite(rep.loss))

    # ----------------------------------------------------------- results
    def e2e(self, times, window_s: float) -> dict:
        return {"sim_round_s": window_s / len(times),
                "sim_round_p90_s": statistics.quantiles(times, n=10)[8]
                if len(times) > 1 else times[0]}

    def close_program(self) -> None:
        self.engine = self.state = None

    def _reference_trace(self, control: bool, batch_keep: float = 1.0):
        """The reference's own account of the run: every round's plan
        violations, DC points, energy and delay, and the first rounds'
        models and losses.  ``control`` runs it a precision
        below the configuration's: TF32 matmuls and bfloat16 costs."""
        c, dev = self.cfg, self.device
        net, e = c["network"], c["engine"]
        dims = (net["num_ue"], net["num_bs"], net["num_dc"])
        rng = np.random.RandomState(self.engine_seed)
        gen = torch.Generator(device=dev).manual_seed(self.engine_seed)
        p = inputs.classifier_weights(_dims(c), self.weight_seed, dev)
        px, py = self.pool
        cost_dtype = torch.bfloat16 if control else torch.float64
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = control
        out = []
        try:
            for t, rec in enumerate(self.records):
                w = rec["plan"]
                rates = ref.jitter_rates(self.rates, rng, e["rate_jitter"])
                sizes = np.array([len(i) for i in rec["ue_idx"]], float)
                dpu = ref.offload(rng, rec["ue_idx"], w["rho_nb"],
                                  w["rho_bs"])
                energy, delay = ref.round_costs(w, rates, sizes, net,
                                                cost_dtype)
                row = {"violations": ref.plan_violations(
                           w, dims, net["f_min"], net["f_max"]),
                       "dc_points": tuple(len(i) for i in dpu[dims[0]:]),
                       "energy": energy, "delay": delay}
                if t < FOLLOWED:
                    data = [(torch.from_numpy(px[i]).to(dev),
                             torch.from_numpy(py[i]).to(dev)) for i in dpu]
                    gam = np.maximum(np.rint(w["gamma"]), 1).astype(int)
                    ms = np.clip(w["m"].astype(np.float32), 0.05, 1.0)
                    p, loss = ref.fedprox_round(
                        p, data, gam, ms, gen, eta=e["eta"], mu=e["mu"],
                        batch_keep=batch_keep)
                    row.update(params={k: v.float() for k, v in p.items()},
                               loss=loss)
                out.append(row)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        return out

    def _program_trace(self):
        out = []
        for t, rec in enumerate(self.records):
            row = dict(rec)
            if t < FOLLOWED:
                row["params"] = self.followed[t]
            out.append(row)
        return out

    def readings(self, mode: str = "program") -> dict:
        """The numbers compared.  ``mode``: "program" judges the program's
        run; "control" the reference a precision lower in its place;
        "half_batch" the reference with half of each mini-batch left
        out."""
        sound = self._reference_trace(control=False)
        if mode == "program":
            got = self._program_trace()
        elif mode == "control":
            got = self._reference_trace(control=True)
        else:                       # "half_batch", a planted fault
            got = self._reference_trace(control=False, batch_keep=0.5)
        p0 = inputs.classifier_weights(_dims(self.cfg), self.weight_seed,
                                       self.device)
        return compare(got, sound, p0)


def compare(got, sound, p0) -> dict:
    """The compared numbers of a run ``got`` against the reference's
    ``sound`` account of it."""
    steps = [r for r in sound if "params" in r]

    def norms(params):
        return change_norms({k: params[k].to(v.device) - v
                             for k, v in p0.items()})

    grad1 = norm_gap(norms(got[0]["params"]), norms(steps[0]["params"]))
    change = norm_gap(norms(got[len(steps) - 1]["params"]),
                      norms(steps[-1]["params"]), keep=grad1["kept"])
    return {
        "loss_gap": max(rel_gap(g["loss"], s["loss"])
                        for g, s in zip(got, steps)),
        "grad1_gap": grad1["gap"],
        "change3_gap": change["gap"],
        "energy_gap": max(rel_gap(g["energy"], s["energy"])
                          for g, s in zip(got, sound)),
        "delay_gap": max(rel_gap(g["delay"], s["delay"])
                         for g, s in zip(got, sound)),
        "plan_violations": float(sum(s["violations"] for s in sound)),
        "offload_mismatch": float(sum(g["dc_points"] != s["dc_points"]
                                      for g, s in zip(got, sound))),
    }


def make(cfg, wl, seed, device, tracer):
    return SimRound(cfg, wl, seed, device, tracer)
