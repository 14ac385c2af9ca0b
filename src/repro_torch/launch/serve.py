"""Batched token serving for the zoo: prefill a batch of prompts, then decode.

The counterpart of the reference's ``repro.launch.serve --arch`` path
(``serve_arch``).  Weights are random, drawn from a ``torch.Generator``
seeded with ``--seed`` on the serving device; the prompts are the
reference's (``numpy.random.default_rng(seed).integers(0, vocab, (B, S))``).
Decoding is greedy.

  python -m repro_torch.launch.serve --arch zamba2-1.2b [--batch 4 --seq 64
      --tokens 32 --seed 0] [--device cuda|cpu]

serves ``get_config(arch).reduced()``, as the reference does.  The device
defaults to the CUDA card (the hand-written kernels); ``--device cpu`` asks
for the plain PyTorch path by name.  The reference's ``--paper`` mode is
the fraud pipeline, which the port serves through
``repro_torch.serve.lambda_pipeline``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models.config import ArchConfig
from repro_torch.utils.device import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ArchConfig, batch: int, seq: int, tokens: int, seed: int = 0,
          device=None) -> dict:
    """Build ``cfg`` with random weights from ``seed`` on ``device``
    (default: CUDA), prefill ``batch`` random prompts of ``seq`` tokens and
    greedily decode ``tokens`` tokens.

    Returns host-clock timings of the prefill and of the decode loop (each
    ends in a device synchronize), ``token_ids`` [B, tokens + 1] (the token
    after the prompt, then one per decode step) and ``all_finite``, whether
    every logit was finite."""
    dev = resolve_device(device)
    params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq))).to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = prefill(params, cfg, prompts, seq + tokens)
        finite = torch.isfinite(logits).all()
        tok = logits.argmax(-1)
        _sync(dev)
        t1 = time.perf_counter()
        generated = [tok]
        for _ in range(tokens):
            logits, cache = decode_step(params, cfg, tok, cache)
            finite &= torch.isfinite(logits).all()
            tok = logits.argmax(-1)
            generated.append(tok)
        _sync(dev)
    decode_s = time.perf_counter() - t1
    return {
        "batch": batch, "prompt_len": seq, "tokens": tokens,
        "prefill_s": t1 - t0, "decode_s": decode_s,
        "ms_per_step": decode_s / max(tokens, 1) * 1e3,
        "tokens_per_s": tokens * batch / decode_s if tokens else 0.0,
        "token_ids": torch.stack(generated, 1).cpu(),
        "all_finite": bool(finite),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (the plain path)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch).reduced()
    out = serve(cfg, args.batch, args.seq, args.tokens, args.seed, device=args.device)
    print(f"prefill {args.batch}x{args.seq}: {out['prefill_s']:.2f}s")
    print(f"decoded {args.tokens} tokens x {args.batch} seqs in {out['decode_s']:.2f}s "
          f"({out['tokens_per_s']:.1f} tok/s, {out['ms_per_step']:.1f} ms/step)")
    print("sample ids:", out["token_ids"][0][:16].numpy())


if __name__ == "__main__":
    main()
