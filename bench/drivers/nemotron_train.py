"""Driver ``nemotron_train``: CE-FL training of a Nemotron-H period (the
chip's share of NVIDIA-Nemotron-3-Nano-30B-A3B) through the program's LM
round step (``repro_torch.experiments.lm.build_lm_step``), as
``lm_train`` drives mamba2: one ``step(params, batch, meta)`` a round on
the (n_dpu, R, 1024) replica stack, rounds back to back.

Set-up draws the weights (``bench/nemotron_inputs.py``) and drives the
first ``FOLLOWED`` rounds through the window's own call and feed,
recording, for the reference, each expert layer's choice of experts
(the program's ``moe.dropless_route``, forward passes only).  The
reference (``bench/reference/nemotron_h.py``) trains the same weights on
the same batches through those rounds; loss, change after the first and
after the third round are compared as in ``lm_train``.

The tie rule.  Routing is discrete: a token whose 6th and 7th expert
scores lie within rounding of each other may pick either, and the two
picks give changes that differ far beyond rounding.  Worse, a flip
cascades: the token's output then differs by a whole expert's, the SSD
and attention carry that to the later tokens, and their routers see
inputs that differ by far more than rounding.  So where the program's
choice differs from the reference's own and every expert the program
chose scores within 1e-3 (relative) of the reference's 6th score, the
reference follows the program, and counts the token (``route_ties``); a
choice that differs by more is the reference's own (``route_mismatch``).
1e-3 because the two runs' scores differ by up to 5e-5 by the second
round (their parameters differ by rounding after the first), and with a
window of 1e-5 the flips just outside it cascaded into choices 10 %
apart by the third (PERF.md §2).  No planted fault changes a choice:
a wrong router (softmax scores, gates without the 2.5 or unnormalised),
capacity dropping at 1.25 or TF32 changes the gates or the products of
every token, which no tie absorbs, and fails a number (the planted
faults of :meth:`NemotronTrain.readings`).

Dropped pairs.  The followed rounds run with the program's recorder on,
so the program reads, after each, the pairs its router sent to this
chip's experts and the rows its up-product kernel counted as written
(``models.moe.flush_counts``); ``moe_dropped``, their difference summed
over the rounds, is compared with a limit of 0.
"""
from __future__ import annotations

import torch

from bench import nemotron_inputs
from bench.drivers.lm_train import FOLLOWED, LMTrain, _split_layers
from bench.reference import nemotron_h as ref
from bench.reference.compare import change_norms, norm_gap, rel_gap
from bench.reference.mamba2 import _leaves, _rebuild

REF_ROWS = 2          # rows the reference takes at a time


class NemotronTrain(LMTrain):
    def __init__(self, cfg, wl, seed, device, tracer):
        super().__init__(cfg, wl, seed, device, tracer)
        self.routes = []          # [round][step][dpu] -> [(T, k) per layer]
        self._want = None         # the sound reference's run, once
        self.dropped = None       # pairs routed here and not computed

    def setup(self) -> None:
        from repro_torch.core.round_step import make_dpu_meta
        from repro_torch.experiments.lm import build_lm_step
        from repro_torch.experiments.spec import ModelSpec
        from repro_torch import tracing
        from repro_torch.kernels.plane import ParamPlane
        from repro_torch.models import moe

        c, wl, dev = self.cfg, self.wl, self.device
        tr = c["train"]
        model = nemotron_inputs.model_config(c)
        spec = ModelSpec(kind="lm", arch=c["name"], reduced=False,
                         batch=wl["batch"], seq=wl["seq"],
                         n_dpu=tr["n_dpu"], n_micro=1, gamma=wl["gamma"])
        self.step = build_lm_step(model, spec, eta=tr["eta"], mu=tr["mu"])
        self.meta = make_dpu_meta(tr["n_dpu"], gammas=[wl["gamma"]]
                                  * tr["n_dpu"], device=dev)
        start = ParamPlane.from_tree(
            nemotron_inputs.weights(c, self.weight_seed, dev))
        self.params = start.with_data(
            start.broadcast(tr["n_dpu"]).data.contiguous())
        n_e = nemotron_inputs.layer_kinds(c).count("E")
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
                # forward calls in order: step k, DPU i, expert layer j
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
                   fault=None, coefs=None):
        """Losses of the followed rounds, the change norms after the
        first and the last, and the tie counts, by the plain reference.
        ``control`` turns TF32 on; ``fault`` plants one of
        ``nemotron_h.FAULTS``; ``coefs`` replaces the round's a_k and
        their sum (``nemotron_h.cefl_round``)."""
        c, wl, dev = self.cfg, self.wl, self.device
        tr = c["train"]
        p0 = nemotron_inputs.weights(c, self.weight_seed, dev)
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
                    routes=self.routes[t], fault=fault, stats=stats,
                    coefs=coefs)
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
        DPU's rows left out; each of ``nemotron_h.FAULTS`` the reference
        with that fault planted; "a_l1_f32", a diagnostic, the reference
        with the program's float32 round coefficients
        (:func:`program_coefs`)."""
        if self._want is None:
            self._want = self._reference()
        want_loss, want, stats = self._want
        if mode == "program":
            got_loss, got = self.losses, self.norms
        else:
            tr, wl = self.cfg["train"], self.wl
            got_loss, one, _ = self._reference(
                control=mode == "control",
                batch_keep=0.5 if mode == "half_batch" else 1.0,
                fault=mode if mode in ref.FAULTS else None,
                coefs=program_coefs(wl["gamma"], tr["eta"], tr["mu"],
                                    self.device)
                if mode == "a_l1_f32" else None)
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


def program_coefs(gamma: int, eta: float, mu: float, device):
    """The round coefficients as the program computes them on ``device``
    (``core/round_step``: ``_a_k`` and ``a_l1``, float32 closed forms
    through log(1 - eta*mu)), written out here so the reference imports
    nothing of the program: (a_k for k < gamma, ||a||_1).  At eta*mu =
    3e-4, 1 - r^gamma cancels: one float32 ulp of exp near 1 moves
    ||a||_1 by about 1e-4 of itself."""
    f = torch.float32
    r = 1.0 - eta * mu
    log_r = torch.log(torch.tensor(r, dtype=f, device=device))
    a = [float(torch.exp(torch.tensor(gamma - 1.0 - k, dtype=f,
                                      device=device) * log_r))
         for k in range(gamma)]
    a_sum = float((1.0 - torch.exp(torch.tensor(float(gamma), dtype=f,
                                                device=device) * log_r))
                  / (1.0 - r))
    return a, a_sum


def make(cfg, wl, seed, device, tracer):
    return NemotronTrain(cfg, wl, seed, device, tracer)
