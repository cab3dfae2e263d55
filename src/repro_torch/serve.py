"""Serve an LM of any of the repo's architectures to a batch of
requests: prefill the prompt batch, then step the batched decode loop
with greedy sampling (counterpart of ``examples/serve_lm.py`` and
``repro.launch.steps.build_prefill_step`` / ``build_serve_step``).  Every
decode step's attention (self- and, in an encoder-decoder, cross-
attention) runs the ``swa_decode_attention`` kernel on the card; a
Mamba-2 layer steps its recurrent state and an MoE routes the batch
drop-free in plain torch (no kernel).

    python -m repro_torch.serve --arch starcoder2-15b --batch 8 \\
        --prompt-len 512 --gen 32 --cache-len 4096        # on the card
    python -m repro_torch.serve --arch jamba-v0.1-52b --layers 16 \\
        --cache-len 1024                                  # on the card
    python -m repro_torch.serve --arch starcoder2-15b --reduced --device cpu
    python -m repro_torch.serve --arch whisper-medium --reduced --device cpu

``--reduced`` takes the config's smoke size (``configs.reduced``);
``--layers N`` cuts depth only, in whole periods (jamba's period is 8
layers, llama4's 2).  Weights are random, drawn from ``--seed``; prompts
are random token ids from the same seed, and an encoder-decoder's
encoder frames N(0, 0.1^2) from it too.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.device import require_device
from repro_torch.models import lm as L


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def encoder_frames(cfg: ModelConfig, batch: int, seed: int, dtype,
                   device) -> torch.Tensor:
    """Stub encoder frames (batch, encoder_seq, d_model), N(0, 0.1^2),
    drawn on ``device`` from ``seed`` and cast to ``dtype``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((batch, cfg.encoder_seq, cfg.d_model), generator=gen,
                    device=device)
    return (x * 0.1).to(dtype)


def serve(cfg: ModelConfig, prompts, *, gen: int, cache_len: int,
          params=None, seed: int = 0, enc_embed=None, device="cuda"):
    """Greedy generation of ``gen`` tokens for each row of ``prompts``
    ((B, P) token ids, array or tensor).  ``params``: the model's
    parameters on ``device`` (random from ``seed`` when None).  An
    encoder-decoder encodes ``enc_embed`` (B, encoder_seq, d), by default
    :func:`encoder_frames` of ``seed`` + 1.  A config with attention and
    without a sliding window needs P + gen - 1 <= cache_len; one with
    Mamba layers needs P a multiple of the chunk.

    Returns (tokens (B, gen) on ``device``, stats) with stats holding
    ``prefill_s`` (the encoder included), ``decode_step_s`` (host seconds
    per decode step, each ending in a synchronize) and ``logits_finite``
    (every step's logits finite, checked on the device and read once at
    the end).  The argmax tokens stay on the device between steps."""
    dev = require_device(device)
    prompts = torch.as_tensor(prompts, device=dev).long()
    P = prompts.shape[1]
    if not cfg.attn_free and cfg.sliding_window is None \
            and P + gen - 1 > cache_len:
        raise ValueError(f"prompt {P} + {gen} tokens do not fit a "
                         f"{cache_len}-position cache")
    if "M" in cfg.layer_pattern and P % cfg.ssm.chunk_size:
        raise ValueError(f"{cfg.name} prompts must be a multiple of the "
                         f"SSD chunk, {cfg.ssm.chunk_size} tokens, not {P}")
    if params is None:
        params = L.init_lm_params(
            torch.Generator(device=dev).manual_seed(seed), cfg)
    if cfg.is_encdec and enc_embed is None:
        enc_embed = encoder_frames(cfg, prompts.shape[0], seed + 1,
                                   params["embed"].dtype, dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = L.prefill(params, cfg, prompts, cache_len,
                              enc_embed=enc_embed)
    tok = torch.argmax(logits, dim=-1)
    finite = torch.isfinite(logits).all()
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    out = [tok]
    steps = []
    for _ in range(gen - 1):
        t0 = time.perf_counter()
        logits, cache = L.lm_decode_step(params, cfg, tok, cache)
        tok = torch.argmax(logits, dim=-1)
        finite &= torch.isfinite(logits).all()
        out.append(tok)
        _sync(dev)
        steps.append(time.perf_counter() - t0)
    return torch.stack(out, dim=1), {"prefill_s": prefill_s,
                                     "decode_step_s": steps,
                                     "logits_finite": bool(finite)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="starcoder2-15b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    prompts = np.random.RandomState(args.seed).randint(
        0, cfg.vocab_size, (args.batch, args.prompt_len))
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers, "
          f"{cfg.param_count() / 1e9:.2f} G params, batch {args.batch}, "
          f"prompt {args.prompt_len}, {args.gen} tokens, cache "
          f"{args.cache_len}, {args.device}")
    tokens, stats = serve(cfg, prompts, gen=args.gen,
                          cache_len=args.cache_len, seed=args.seed,
                          device=args.device)
    steps = stats["decode_step_s"]
    print(f"[serve] prefill {stats['prefill_s']:.3f} s")
    if steps:
        med = statistics.median(steps[1:] or steps)
        print(f"[serve] decode {med * 1e3:.2f} ms/step (median after the "
              f"first), {args.batch / med:.1f} tokens/s batched")
    print(f"[serve] logits finite: {stats['logits_finite']}")
    for b in range(min(2, args.batch)):
        print(f"  seq{b}: {tokens[b].tolist()}")
    return tokens, stats


if __name__ == "__main__":
    main()
