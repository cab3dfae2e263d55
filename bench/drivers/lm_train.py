"""Driver ``lm_train``: CE-FL training of a language model through the
program's LM round step (``repro_torch.experiments.lm.build_lm_step``),
one ``step(params, batch, meta)`` a round on the (n_dpu, R, 1024)
replica stack, rounds back to back.

Set-up draws the weights and builds the step, then drives its first
``FOLLOWED`` rounds through the window's own call and feed.  The
reference trains the same weights on the same batches through those
rounds; the loss of each, the change after the first (the aggregated
gradient as eq. 11 applies it) and the change after the third are
compared, leaf by leaf and replica by replica.
"""
from __future__ import annotations

import numpy as np
import torch

from bench import inputs
from bench.reference import mamba2 as ref
from bench.reference.compare import change_norms, norm_gap, rel_gap

FOLLOWED = 3
REF_ROWS = 2          # rows the reference takes at a time


def _split_layers(tree: dict) -> dict:
    """Leaves keyed by dotted path, each stacked block leaf cut into its
    layers."""
    out = {}
    for name, v in ref._leaves(tree):
        if name.startswith("blocks."):
            for i in range(v.shape[0]):
                out[f"{name}[{i}]"] = v[i]
        else:
            out[name] = v
    return out


class LMTrain:
    host_spans = ("step", "sync_wait")

    def __init__(self, cfg: dict, wl: dict, seed: int, device, tracer):
        self.cfg, self.wl, self.device, self.tr = cfg, wl, device, tracer
        self.weight_seed, self.token_seed = inputs.sub_seeds(seed, 2)
        self.t = 0
        self.losses = []
        self.norms = {}
        n = cfg["train"]["n_dpu"]
        self.mb = wl["batch"] // n
        self.tokens_per_round = wl["batch"] * wl["seq"] * wl["gamma"]

    def batch(self, t: int) -> dict:
        seed = int(np.random.SeedSequence([self.token_seed, t])
                   .generate_state(1)[0])
        return inputs.token_batch(self.cfg["vocab_size"],
                                  self.cfg["train"]["n_dpu"], self.mb,
                                  self.wl["seq"], seed)

    def setup(self) -> None:
        from repro_torch.configs.base import ModelConfig, SSMConfig
        from repro_torch.core.round_step import make_dpu_meta
        from repro_torch.experiments.lm import build_lm_step
        from repro_torch.experiments.spec import ModelSpec
        from repro_torch.kernels.plane import ParamPlane

        c, wl, dev = self.cfg, self.wl, self.device
        tr = c["train"]
        model = ModelConfig(
            name=c["name"], family="ssm", num_layers=c["n_layer"],
            d_model=c["d_model"], num_heads=0, num_kv_heads=0, d_ff=0,
            vocab_size=c["vocab_size"], layer_pattern="M",
            ssm=SSMConfig(state_dim=c["d_state"], head_dim=c["headdim"],
                          expand=c["expand"], chunk_size=c["chunk_size"],
                          conv_width=c["d_conv"], dt_min=c["dt_min"],
                          dt_max=c["dt_max"]),
            dtype="float32", norm_eps=c["norm_eps"],
            tie_embeddings=c["tie_embeddings"], source=c["source"])
        spec = ModelSpec(kind="lm", arch=c["name"], reduced=False,
                         batch=wl["batch"], seq=wl["seq"],
                         n_dpu=tr["n_dpu"], n_micro=1, gamma=wl["gamma"])
        self.step = build_lm_step(model, spec, eta=tr["eta"], mu=tr["mu"])
        self.meta = make_dpu_meta(tr["n_dpu"], gammas=[wl["gamma"]]
                                  * tr["n_dpu"], device=dev)
        start = ParamPlane.from_tree(
            inputs.mamba2_weights(c, self.weight_seed, dev))
        self.params = start.with_data(
            start.broadcast(tr["n_dpu"]).data.contiguous())
        for t in range(FOLLOWED):
            self.round()
            if t in (0, FOLLOWED - 1):
                self.norms[t] = [
                    change_norms(_split_layers(start.spec.unflatten(
                        self.params.data[i] - start.data)))
                    for i in range(tr["n_dpu"])]
        del start

    def round(self) -> bool:
        tr = self.tr
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in self.batch(self.t).items()}
        with tr.span("step"):
            self.params, metrics = self.step(self.params, batch, self.meta)
        with tr.span("sync_wait"):
            torch.cuda.synchronize(self.device) \
                if self.device.type == "cuda" else None
        loss = float(metrics["loss"])
        tr.count("tokens", self.tokens_per_round)
        if self.t < FOLLOWED:
            self.losses.append(loss)
        self.t += 1
        return bool(np.isfinite(loss))

    def e2e(self, times, window_s: float) -> dict:
        return {"lm_train_tokens_per_s":
                self.tokens_per_round * len(times) / window_s}

    def close_program(self) -> None:
        self.params = self.step = None

    def _reference(self, control: bool = False, batch_keep: float = 1.0):
        """Losses of the followed rounds and the change norms after the
        first and the last, by the plain reference.  ``control`` turns
        TF32 on, the precision below the configuration's."""
        c, wl, dev = self.cfg, self.wl, self.device
        tr = c["train"]
        p0 = inputs.mamba2_weights(c, self.weight_seed, dev)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = control
        losses, norms = [], {}
        try:
            p = p0
            for t in range(FOLLOWED):
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in self.batch(t).items()}
                p, loss = ref.cefl_round(p, batch, c, gamma=wl["gamma"],
                                         eta=tr["eta"], mu=tr["mu"],
                                         rows=REF_ROWS,
                                         batch_keep=batch_keep)
                losses.append(loss)
                if t in (0, FOLLOWED - 1):
                    diff = {k: v - s for (k, v), (_, s) in
                            zip(ref._leaves(p), ref._leaves(p0))}
                    norms[t] = change_norms(_split_layers(ref._rebuild(
                        list(diff), list(diff.values()))))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        return losses, norms

    def readings(self, mode: str = "program") -> dict:
        """The numbers compared.  ``mode``: "program" judges the program's
        run; "control" the reference with TF32 in its place;
        "half_batch" the reference with half of each DPU's rows left
        out."""
        want_loss, want = self._reference()
        if mode == "program":
            got_loss, got = self.losses, self.norms
        else:
            got_loss, one = self._reference(
                control=mode == "control",
                batch_keep=0.5 if mode == "half_batch" else 1.0)
            got = {t: [v] for t, v in one.items()}
        last = FOLLOWED - 1
        grad1 = [norm_gap(g, want[0]) for g in got[0]]
        kept = grad1[0]["kept"]
        change = [norm_gap(g, want[last], keep=kept) for g in got[last]]
        return {
            "loss_gap": max(rel_gap(g, w) for g, w in zip(got_loss,
                                                          want_loss)),
            "grad1_gap": max(x["gap"] for x in grad1),
            "change3_gap": max(x["gap"] for x in change),
            "grad1_shape_gap": max(x["shape"] for x in grad1),
            "change3_shape_gap": max(x["shape"] for x in change),
        }


def make(cfg, wl, seed, device, tracer):
    return LMTrain(cfg, wl, seed, device, tracer)
