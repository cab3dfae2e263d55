"""Driver ``moonlight_train``: CE-FL training of Moonlight-16B-A3B's layers
(the chip's share: the leading dense layer and 5 MoE layers, 8 of 64
experts held) through the program's LM round step
(``repro_torch.experiments.lm.build_lm_step``), as ``nemotron_train``
drives Nemotron-H: one ``step(params, batch, meta)`` a round on the
(n_dpu, R, 1024) replica stack, rounds back to back.

Set-up draws the weights (``bench/moonlight_inputs.py``) and drives the
first ``FOLLOWED`` rounds through the window's own call and feed with the
program's recorder on, recording each MoE layer's choice of experts (the
program's ``moe.dropless_route``, forward passes only) and reading the
dropped pairs (``moe_dropped``), as ``nemotron_train`` does.  The
reference (``bench/reference/moonlight.py``) trains the same weights on
the same batches through those rounds, following the program's choice on
near-ties (``nemotron_train``'s tie rule, ``route_ties`` /
``route_mismatch``); loss, change after the first and after the third
round are compared as in ``lm_train``.
"""
from __future__ import annotations

import torch

from bench import moonlight_inputs
from bench.drivers.lm_train import FOLLOWED, _split_layers
from bench.drivers.nemotron_train import NemotronTrain
from bench.reference import moonlight as ref
from bench.reference.compare import change_norms, norm_gap, rel_gap
from bench.reference.mamba2 import _leaves, _rebuild

REF_ROWS = 1          # rows the reference takes at a time


class MoonlightTrain(NemotronTrain):
    def setup(self) -> None:
        from repro_torch import tracing
        from repro_torch.core.round_step import make_dpu_meta
        from repro_torch.experiments.lm import build_lm_step
        from repro_torch.experiments.spec import ModelSpec
        from repro_torch.kernels.plane import ParamPlane
        from repro_torch.models import moe

        c, wl, dev = self.cfg, self.wl, self.device
        tr = c["train"]
        model = moonlight_inputs.model_config(c)
        spec = ModelSpec(kind="lm", arch=c["name"], reduced=False,
                         batch=wl["batch"], seq=wl["seq"],
                         n_dpu=tr["n_dpu"], n_micro=1, gamma=wl["gamma"])
        self.step = build_lm_step(model, spec, eta=tr["eta"], mu=tr["mu"])
        self.meta = make_dpu_meta(tr["n_dpu"], gammas=[wl["gamma"]]
                                  * tr["n_dpu"], device=dev)
        start = ParamPlane.from_tree(
            moonlight_inputs.weights(c, self.weight_seed, dev))
        self.params = start.with_data(
            start.broadcast(tr["n_dpu"]).data.contiguous())
        n_e = moonlight_inputs.moe_layers(c)
        calls = []
        route = moe.dropless_route

        def recorded(router, h, m):
            r = route(router, h, m)
            if torch._C._current_graph_task_id() == -1:
                calls.append(r.ids.clone())
            return r
        moe.dropless_route = recorded
        tracing.clear()
        tracing.enable()
        try:
            for t in range(FOLLOWED):
                calls.clear()
                self.round()
                # forward calls in order: step k, DPU i, MoE layer j
                per = tr["n_dpu"] * n_e
                self.routes.append([[calls[k * per + i * n_e:
                                           k * per + (i + 1) * n_e]
                                     for i in range(tr["n_dpu"])]
                                    for k in range(wl["gamma"])])
                if t in (0, FOLLOWED - 1):
                    self.norms[t] = [
                        change_norms(_split_layers(start.spec.unflatten(
                            self.params.data[i] - start.data)))
                        for i in range(tr["n_dpu"])]
        finally:
            tracing.disable()
            moe.dropless_route = route
        self.dropped = sum(sp.attrs.get("moe_dropped", 0)
                           for sp in tracing.spans()
                           if sp.name == "moe.counts")
        tracing.clear()
        del start

    def _reference(self, control: bool = False, batch_keep: float = 1.0,
                   fault=None):
        """Losses of the followed rounds, the change norms after the
        first and the last, and the tie counts, by the plain reference.
        ``control`` turns TF32 on; ``fault`` plants one of
        ``moonlight.FAULTS``."""
        c, wl, dev = self.cfg, self.wl, self.device
        tr = c["train"]
        p0 = moonlight_inputs.weights(c, self.weight_seed, dev)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = control
        losses, norms = [], {}
        stats = {"ties": 0, "mismatch": 0}
        try:
            p = p0
            for t in range(FOLLOWED):
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in self.batch(t).items()}
                p, loss = ref.cefl_round(
                    p, batch, c, gamma=wl["gamma"], eta=tr["eta"],
                    mu=tr["mu"], rows=REF_ROWS, batch_keep=batch_keep,
                    routes=self.routes[t], fault=fault, stats=stats)
                losses.append(loss)
                if t in (0, FOLLOWED - 1):
                    diff = {k: v - s for (k, v), (_, s) in
                            zip(_leaves(p), _leaves(p0))}
                    norms[t] = change_norms(_split_layers(_rebuild(
                        list(diff), list(diff.values()))))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        return losses, norms, stats

    def readings(self, mode: str = "program") -> dict:
        """The numbers compared.  ``mode``: "program" judges the program's
        run (and reads its dropped pairs); "control" the reference with
        TF32 in its place; "half_batch" the reference with half of each
        DPU's positions left out; each of ``moonlight.FAULTS`` the
        reference with that fault planted."""
        if self._want is None:
            self._want = self._reference()
        want_loss, want, stats = self._want
        if mode == "program":
            got_loss, got = self.losses, self.norms
        else:
            got_loss, one, _ = self._reference(
                control=mode == "control",
                batch_keep=0.5 if mode == "half_batch" else 1.0,
                fault=mode if mode in ref.FAULTS else None)
            got = {t: [v] for t, v in one.items()}
        last = FOLLOWED - 1
        grad1 = [norm_gap(g, want[0]) for g in got[0]]
        kept = grad1[0]["kept"]
        change = [norm_gap(g, want[last], keep=kept) for g in got[last]]
        out = {
            "loss_gap": max(rel_gap(g, w) for g, w in zip(got_loss,
                                                          want_loss)),
            "grad1_gap": max(x["gap"] for x in grad1),
            "change3_gap": max(x["gap"] for x in change),
            "grad1_shape_gap": max(x["shape"] for x in grad1),
            "change3_shape_gap": max(x["shape"] for x in change),
            "route_ties": stats["ties"],
            "route_mismatch": stats["mismatch"],
        }
        if mode == "program":
            out["moe_dropped"] = self.dropped
        return out


def make(cfg, wl, seed, device, tracer):
    return MoonlightTrain(cfg, wl, seed, device, tracer)
