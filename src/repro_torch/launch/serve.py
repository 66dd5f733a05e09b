"""Serving entry point: prefill + batched autoregressive decode, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
        --batch 4 --prompt-len 16 --gen 32

Weights are random, drawn from --seed. --device cpu runs the plain path on
the CPU (use it with --smoke). An encoder-decoder (--arch whisper-base)
encodes ENC_FRAMES random frame embeddings per request, drawn from --seed,
before it decodes.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, get_smoke_config
from ..device import resolve_device
from ..models.transformer import Transformer
from ..serving.engine import ServeEngine

# frame embeddings per request of an encoder-decoder: Whisper's 30 s window
ENC_FRAMES = 1500


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    model = Transformer(cfg, device=dev, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    enc = None
    if cfg.is_encdec:
        enc = torch.as_tensor(rng.standard_normal(
            (args.batch, ENC_FRAMES, cfg.d_model)), dtype=cfg.dtype(),
            device=dev)
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, model, max_len=args.prompt_len + args.gen + 1,
                      device=dev, enc_inputs=enc)
    if enc is not None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        print(f"encoded {args.batch} x {ENC_FRAMES} frames in "
              f"{time.perf_counter() - t0:.3f}s")
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(args.batch, args.prompt_len)),
        device=dev)

    t0 = time.perf_counter()
    out = eng.generate(prompts, args.gen, temperature=args.temperature,
                       seed=args.seed)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = args.batch * args.gen
    print(f"generated {toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s, "
          f"prefill included) on {dev}")
    print("sample:", out[0, :24].tolist())
    return out


if __name__ == "__main__":
    main()
