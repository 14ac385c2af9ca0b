"""Training launcher, the counterpart of the reference's ``repro.launch.train``.

Two modes:
  * ``--paper`` (also what runs when no ``--arch`` is given): train the
    paper's LNN fraud model on the synthetic transaction graph: the GBDT
    baseline, its leaf-value encoding appended to the order features, DDS
    communities, ``train_lnn`` and ``evaluate_lnn``; the best parameters go
    to ``checkpoints/lnn_<gnn>.npz``.
  * ``--arch <id>``: train a zoo configuration with
    ``launch.steps.make_train_step`` (``forward_train``, AdamW) over random
    batches drawn from ``numpy.random.default_rng(seed)`` (tokens, and a
    vlm's vision embeddings or an audio model's frames), printing the loss
    and gradient norm as the reference does; the parameters go to
    ``checkpoints/<arch>.npz``.  Weights are random, drawn from a
    ``torch.Generator`` seeded with ``--seed`` on the training device.  It
    trains ``get_config(arch).reduced()``, as the reference does
    (``--reduced`` is always on there too; ``train_arch`` takes an args
    namespace whose ``reduced`` is False for the published widths).

  python -m repro_torch.launch.train [--paper] [--gnn gcn] [--epochs 40]
  python -m repro_torch.launch.train --arch zamba2-1.2b [--steps 100
      --batch 4 --seq 128 --lr 3e-4] [--seed 0] [--device cuda|cpu]

The device defaults to the CUDA card (the hand-written kernels, forward and
backward) and raises without one; ``--device cpu`` asks for the plain path.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.baselines import GBDTConfig, train_gbdt
from repro_torch.configs import get_config
from repro_torch.core.lnn import LNNConfig
from repro_torch.data import (SynthConfig, build_communities, generate_transactions,
                              make_split_masks, standardize_features)
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.params import save_npz
from repro_torch.train.loop import evaluate_lnn, train_lnn
from repro_torch.train.optim import adamw
from repro_torch.utils.device import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_paper(args) -> dict:
    """The reference's ``train_paper`` on ``args.device`` (default: CUDA).
    Returns the test metrics."""
    dev = resolve_device(getattr(args, "device", None))
    scfg = SynthConfig(num_users=args.users, num_rings=args.rings, feature_noise=0.8,
                       seed=args.seed)
    g, _ = generate_transactions(scfg)
    split = make_split_masks(g.order_snapshot)
    feats, _ = standardize_features(g.order_features, split == 0)

    gbdt = train_gbdt(feats[split == 0], g.labels[split == 0], GBDTConfig(),
                      feats[split == 1], g.labels[split == 1])
    enc = np.concatenate([feats, gbdt.leaf_value_features(feats)], 1)
    mu, sd = enc[split == 0].mean(0), enc[split == 0].std(0) + 1e-6
    g.order_features = ((enc - mu) / sd).astype(np.float32)

    batches = build_communities(g, community_size=256, max_deg=24, seed=args.seed)
    cfg = LNNConfig(gnn_type=args.gnn, num_gnn_layers=3, hidden_dim=64,
                    feat_dim=g.order_features.shape[1], pos_weight=3.0)
    print(f"training LNN({args.gnn}) on {len(batches)} communities "
          f"({g.num_orders} orders, fraud rate {g.labels.mean():.3f})")
    res = train_lnn(batches, split, cfg, epochs=args.epochs, verbose=True, seed=args.seed,
                    device=dev)
    metrics = evaluate_lnn(res.params, cfg, batches, split, 2, device=dev)
    print(f"test: {metrics}")
    os.makedirs("checkpoints", exist_ok=True)
    save_npz(f"checkpoints/lnn_{args.gnn}.npz", res.params, step=res.best_epoch)
    print(f"checkpoint saved to checkpoints/lnn_{args.gnn}.npz")
    return metrics


def arch_batch(cfg, batch: int, seq: int, rng: np.random.Generator, device) -> dict:
    """One random batch as the reference's ``train_arch`` draws it from
    ``rng``: ``seq + 1`` token ids a row, split into tokens and labels, then
    a vlm's ``vision`` [B, num_vision_tokens, d] or an audio model's
    ``frames`` [B, min(seq, 64), d], f32 normals."""
    toks = rng.integers(0, cfg.vocab_size, (batch, seq + 1))
    out = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)).to(device),
           "labels": torch.from_numpy(toks[:, 1:].astype(np.int32)).to(device)}
    if cfg.arch_type == "vlm":
        shape = (batch, cfg.num_vision_tokens, cfg.d_model)
        out["vision"] = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)
    if cfg.arch_type == "audio":
        shape = (batch, min(seq, 64), cfg.d_model)
        out["frames"] = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(device)
    return out


def train_arch(args) -> dict:
    """The reference's ``train_arch`` on ``args.device`` (default: CUDA):
    ``args.steps`` steps of ``make_train_step(cfg, use_remat=False)`` at
    ``args.batch`` x ``args.seq`` of ``get_config(args.arch)``, reduced when
    ``args.reduced``.  Each step is timed on the host clock, ended by a
    synchronize.  Returns the losses, gradient norms and learning rates of
    every step (floats), the steps' seconds and the checkpoint's path."""
    dev = resolve_device(getattr(args, "device", None))
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    step_fn = make_train_step(cfg, use_remat=False, lr=args.lr)
    params = init_params(torch.Generator(device=dev).manual_seed(args.seed), cfg, device=dev)
    init_fn, _ = adamw(args.lr)
    opt = init_fn(params)
    rng = np.random.default_rng(args.seed)
    out = {"loss": [], "grad_norm": [], "lr": [], "step_s": []}
    for step in range(args.steps):
        batch = arch_batch(cfg, args.batch, args.seq, rng, dev)
        _sync(dev)
        t0 = time.perf_counter()
        params, opt, aux = step_fn(params, opt, batch)
        _sync(dev)
        out["step_s"].append(time.perf_counter() - t0)
        for key in ("loss", "grad_norm", "lr"):
            out[key].append(float(aux[key]))
        if step % max(args.steps // 20, 1) == 0:
            print(f"step {step}: loss={out['loss'][-1]:.4f} "
                  f"gnorm={out['grad_norm'][-1]:.3f} {out['step_s'][-1]:.2f}s")
    os.makedirs("checkpoints", exist_ok=True)
    out["checkpoint"] = save_npz(f"checkpoints/{args.arch.replace('.', '_')}.npz", params,
                                 step=args.steps)
    print(f"final loss {out['loss'][-1]:.4f}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--paper", action="store_true", help="train the LNN fraud model")
    ap.add_argument("--gnn", default="gcn", choices=["gcn", "gat", "sage"])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--users", type=int, default=600)
    ap.add_argument("--rings", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (the plain path)")
    args = ap.parse_args(argv)
    if args.paper or not args.arch:
        train_paper(args)
    else:
        train_arch(args)


if __name__ == "__main__":
    main()
