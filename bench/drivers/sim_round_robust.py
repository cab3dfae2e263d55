"""Driver ``sim_round_robust``: the CE-FL simulation round at paper width
under a threat scenario with a byzantine-robust aggregation, through the
same engine calls as ``sim_round`` (closed loop).

The workload's ``engine`` block is merged over the configuration's (the
robust aggregation, ``robust_agg`` and ``trim_frac``, is an engine
option).  The reference follows the first three rounds from the initial
weights through ``bench/reference/robust.py``: the compromised UEs'
sign-flipped updates and the trimmed mean in float64; every round of the
run is replayed for the plan's feasibility, the offloading, energy and
delay as in ``sim_round``, with the scenario's rate draws (radio links
at the engine's ``rate_jitter``, wired links at the scenario's own).
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from bench import inputs
from bench.drivers.sim_round import FOLLOWED, SimRound, _dims, compare
from bench.reference import cefl as ref
from bench.reference import robust

# the ``byzantine`` scenario: the compromised share, the flip's scale and
# the wired links' jitter (``repro_torch.scenario.presets``)
THREAT = {"byzantine": {"frac": 0.2, "scale": 4.0, "wired_jitter": 0.1}}


def merged(cfg: dict, wl: dict) -> dict:
    """The configuration with the workload's ``engine`` block merged over
    its own."""
    out = copy.deepcopy(cfg)
    out["engine"].update(wl.get("engine", {}))
    return out


class SimRoundRobust(SimRound):
    def __init__(self, cfg: dict, wl: dict, seed: int, device, tracer):
        super().__init__(merged(cfg, wl), wl, seed, device, tracer)

    def _reference_trace(self, control: bool, batch_keep: float = 1.0,
                         defence: bool = True, flip: bool = True):
        """The reference's own account of the run, as ``sim_round``'s,
        with the threat: ``defence`` False aggregates by eq. 11,
        ``flip`` False leaves the adversary out."""
        c, dev = self.cfg, self.device
        net, e = c["network"], c["engine"]
        threat = THREAT[self.wl["scenario"]]
        dims = (net["num_ue"], net["num_bs"], net["num_dc"])
        flipped = {u: threat["scale"] for u in
                   robust.compromised(net["num_ue"], threat["frac"])} \
            if flip else {}
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
                rates = robust.jitter_rates(self.rates, rng,
                                            e["rate_jitter"],
                                            threat["wired_jitter"])
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
                    p, loss = robust.robust_round(
                        p, data, gam, ms, gen, eta=e["eta"], mu=e["mu"],
                        flipped=flipped, trim_frac=e["trim_frac"],
                        defence=defence, batch_keep=batch_keep)
                    p = {k: v.float() for k, v in p.items()}
                    row.update(params=p, loss=loss)
                out.append(row)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        return out

    def readings(self, mode: str = "program") -> dict:
        """The numbers compared.  ``mode``: "program" judges the program's
        run; "control" the reference a precision lower in its place;
        "half_batch" the reference with half of each mini-batch left out;
        "no_defence" the reference aggregating by eq. 11; "no_flip" the
        reference without the adversary."""
        sound = self._reference_trace(control=False)
        if mode == "program":
            got = self._program_trace()
        else:
            got = self._reference_trace(
                control=mode == "control",
                batch_keep=0.5 if mode == "half_batch" else 1.0,
                defence=mode != "no_defence", flip=mode != "no_flip")
        p0 = inputs.classifier_weights(_dims(self.cfg), self.weight_seed,
                                       self.device)
        return compare(got, sound, p0)


def make(cfg, wl, seed, device, tracer):
    return SimRoundRobust(cfg, wl, seed, device, tracer)
