"""Serve a small LM with batched requests: prefill the prompt batch, then
step the batched decode loop (greedy sampling).  Counterpart of
``examples/serve_lm.py``; every attention layer's decode step runs the
``swa_decode_attention`` kernel on the card.

  python -m repro_torch.examples.serve_lm --arch mamba2-130m --reduced
  python -m repro_torch.examples.serve_lm --arch codeqwen1.5-7b   # full 7B
  python -m repro_torch.examples.serve_lm --reduced --device cpu

Weights are random float32, drawn on the device from seed 0; prompts from
seed 1 and an encoder-decoder's encoder frames from seed 2.
"""
import argparse

import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import require_device
from repro_torch.models import lm as L
from repro_torch.serve import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--device", default="cuda",
                    help="torch device (a CPU run must be asked for)")
    args = ap.parse_args(argv)

    dev = require_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    print(f"[serve] {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"batch={args.batch}")
    params = L.init_lm_params(torch.Generator(dev).manual_seed(0), cfg,
                              torch.float32)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len), device=dev,
                            generator=torch.Generator(dev).manual_seed(1))
    enc = None
    if cfg.is_encdec:
        enc = torch.randn((args.batch, cfg.encoder_seq, cfg.d_model),
                          device=dev,
                          generator=torch.Generator(dev).manual_seed(2)) * 0.1

    # prefill, then gen - 1 batched greedy decode steps
    # (models.lm.lm_decode_step), each ending in a synchronize
    toks, stats = serve(cfg, prompts, gen=args.gen,
                        cache_len=args.cache_len, params=params,
                        enc_embed=enc, device=dev)
    print(f"[serve] prefill {args.batch}x{args.prompt_len} tokens "
          f"in {stats['prefill_s']:.2f}s")
    dt = sum(stats["decode_step_s"])
    print(f"[serve] generated {args.gen} tokens/seq in {dt:.2f}s "
          f"({args.batch * args.gen / max(dt, 1e-9):.1f} tok/s batched)")
    for b in range(min(2, args.batch)):
        print(f"  seq{b}: {toks[b].tolist()}")
    return toks


if __name__ == "__main__":
    main()
