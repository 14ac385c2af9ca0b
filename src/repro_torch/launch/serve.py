"""Serving launcher, the counterpart of the reference's ``repro.launch.serve``.

* ``--paper`` (also what runs when no ``--arch`` is given): the Lambda
  fraud-scoring pipeline (``serve_paper``) — a batch-layer refresh, the
  split-equivalence check, then one speed-layer call per checkout request,
  with latency percentiles.
* ``--arch <id>``: batched token serving for the zoo (``serve``): prefill a
  batch of prompts, then decode greedily.  Weights are random, drawn from a
  ``torch.Generator`` seeded with ``--seed`` on the serving device; the
  prompts are the reference's
  (``numpy.random.default_rng(seed).integers(0, vocab, (B, S))``), and so
  are a vlm's vision embeddings and an audio model's frames, drawn next
  from the same generator.  It serves ``get_config(arch).reduced()``, as
  the reference does.

  python -m repro_torch.launch.serve [--paper] [--users 400 --requests 200]
  python -m repro_torch.launch.serve --arch zamba2-1.2b [--batch 4 --seq 64
      --tokens 32] [--seed 0] [--device cuda|cpu]

The device defaults to the CUDA card (the hand-written kernels) and raises
without one; ``--device cpu`` asks for the plain PyTorch path by name.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.lnn import LNNConfig, lnn_init
from repro_torch.data import (SynthConfig, build_communities, generate_transactions,
                              make_split_masks, standardize_features)
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models.config import ArchConfig
from repro_torch.serve import (BatchLayer, KVStore, SpeedLayer, history_requests,
                               split_equivalence_check)
from repro_torch.utils.device import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_paper(users: int = 400, requests: int = 200, seed: int = 0, device=None,
                params=None) -> dict:
    """The paper's serving path on ``device`` (default: CUDA): synthetic
    transactions of ``users`` users (seed ``seed``), standardized features,
    DDS communities of 256 nodes, an ``LNNConfig(num_gnn_layers=3,
    hidden_dim=64)`` with weights from a ``torch.Generator`` seeded with
    ``seed`` (or ``params``, a tree of that shape on ``device``);
    ``BatchLayer.refresh`` fills the KV store, ``split_equivalence_check``
    bounds the two-stage scores against the monolithic forward, and one
    ``SpeedLayer.score`` call per request scores the first ``requests``
    orders with history, each call timed on the host clock (it ends in the
    copy of its probabilities to the host).

    Returns the refresh's stats, the equivalence gap, ``scores`` [R] and
    the per-request latencies' p50/p95/p99 in ms."""
    dev = resolve_device(device)
    g, _ = generate_transactions(SynthConfig(num_users=users, num_rings=6, feature_noise=0.8,
                                             seed=seed))
    split = make_split_masks(g.order_snapshot)
    g.order_features, _ = standardize_features(g.order_features, split == 0)
    batches = build_communities(g, community_size=256, max_deg=24)
    cfg = LNNConfig(num_gnn_layers=3, hidden_dim=64, feat_dim=g.order_features.shape[1])
    if params is None:
        params = lnn_init(torch.Generator().manual_seed(seed), cfg, device=dev)
    store = KVStore(cfg.hidden_dim)
    refresh = BatchLayer(params, cfg, store, device=dev).refresh(batches)
    speed = SpeedLayer(params, cfg, store, k_max=8, device=dev)
    gap = split_equivalence_check(speed.score, params, cfg, batches, device=dev)
    reqs = history_requests(batches)[:requests]
    speed.score(reqs[:1])
    lat, scores = [], []
    for r in reqs:
        t0 = time.perf_counter()
        scores.append(speed.score([r])[0])
        lat.append((time.perf_counter() - t0) * 1e3)
    p50, p95, p99 = np.percentile(lat, (50, 95, 99))
    return {"refresh": refresh, "equivalence_gap": gap, "requests": len(reqs),
            "scores": np.asarray(scores, np.float32),
            "latency_ms": {"p50": float(p50), "p95": float(p95), "p99": float(p99)}}


def serve_inputs(cfg: ArchConfig, batch: int, seq: int, seed: int = 0, frames: int = 32,
                 device=None):
    """The reference's ``serve_arch`` inputs on ``device`` (default: CUDA):
    ``batch`` prompts of ``seq`` token ids, then ``extra`` from the same
    ``numpy.random.default_rng(seed)``: ``vision`` [B, num_vision_tokens,
    d] for a vlm config, ``frames`` [B, frames, d] for an audio one, f32.
    Returns (prompts, extra)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, seq))).to(dev)
    extra = {}
    if cfg.arch_type == "vlm":
        shape = (batch, cfg.num_vision_tokens, cfg.d_model)
        extra["vision"] = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    if cfg.arch_type == "audio":
        shape = (batch, frames, cfg.d_model)
        extra["frames"] = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
    return prompts, extra


def serve(cfg: ArchConfig, batch: int, seq: int, tokens: int, seed: int = 0,
          device=None, frames: int = 32) -> dict:
    """Build ``cfg`` with random weights from ``seed`` on ``device``
    (default: CUDA), prefill ``batch`` random prompts of ``seq`` tokens
    (with a vlm's vision tokens or an audio model's ``frames`` frames,
    :func:`serve_inputs`) and greedily decode ``tokens`` tokens.

    Returns host-clock timings of the prefill and of the decode loop (each
    ends in a device synchronize), ``token_ids`` [B, tokens + 1] (the token
    after the prompt, then one per decode step) and ``all_finite``, whether
    every logit was finite."""
    dev = resolve_device(device)
    params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg, device=dev)
    prompts, extra = serve_inputs(cfg, batch, seq, seed, frames, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = prefill(params, cfg, prompts, seq + tokens, extra)
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
    ap.add_argument("--paper", action="store_true",
                    help="the fraud pipeline (the default when no --arch is given)")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--users", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (the plain path)")
    args = ap.parse_args(argv)
    if args.paper or not args.arch:
        out = serve_paper(args.users, args.requests, args.seed, device=args.device)
        print("batch layer refresh:", out["refresh"])
        print("split equivalence:", out["equivalence_gap"])
        lat = out["latency_ms"]
        print(f"speed layer over {out['requests']} checkouts: p50={lat['p50']:.2f}ms "
              f"p95={lat['p95']:.2f}ms p99={lat['p99']:.2f}ms")
        return
    cfg = get_config(args.arch).reduced()
    out = serve(cfg, args.batch, args.seq, args.tokens, args.seed, device=args.device)
    print(f"prefill {args.batch}x{args.seq}: {out['prefill_s']:.2f}s")
    print(f"decoded {args.tokens} tokens x {args.batch} seqs in {out['decode_s']:.2f}s "
          f"({out['tokens_per_s']:.1f} tok/s, {out['ms_per_step']:.1f} ms/step)")
    print("sample ids:", out["token_ids"][0][:16].numpy())


if __name__ == "__main__":
    main()
