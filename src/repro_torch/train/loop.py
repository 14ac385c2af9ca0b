"""ClusterGCN-style community training loop for the LNN (paper §4.2), the
port of the reference's ``repro.train.loop``.

Trains end-to-end (stage1 ∘ stage2) over per-community padded DDS graphs,
with snapshot-based train/val/test masks and early stopping on validation
average precision — the paper's protocol ("middle 10% used as validation
set for early stopping").  Gradients come from torch autograd in the place
of ``jax.value_and_grad``; on the card the graph aggregations' gradients
come from their backward kernels.  Every community graph moves to the
device once per call, a training graph with its reverse-slot index
(``PaddedGraph.with_rev``), and a step copies
nothing back to the host: the loss is summed on the device and read once
per epoch.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.lnn import LNNConfig, lnn_forward, lnn_init, lnn_loss
from repro_torch.params import tree_map
from repro_torch.train.metrics import average_precision, roc_auc
from repro_torch.train.optim import adamw, cosine_schedule, grad_step
from repro_torch.utils.device import resolve_device


@dataclass
class TrainResult:
    params: object
    history: list      # per epoch: train_loss, val_ap and host seconds (eval included)
    best_epoch: int


def collect_scores(params, cfg: LNNConfig, batches, split, which: int, graphs):
    """Gather (y_true, y_score) for orders in split ``which`` across batches;
    ``graphs`` are the batches' graphs on the parameters' device."""
    ys, ss = [], []
    with torch.no_grad():
        for b, graph in zip(batches, graphs):
            n_orders = b.global_order_ids.size
            sel = split[b.global_order_ids] == which
            if sel.any():
                logits = lnn_forward(params, cfg, graph)[:n_orders].cpu().numpy()
                ys.append(np.asarray(b.graph.label[:n_orders])[sel])
                ss.append(logits[sel])
    if not ys:
        return np.zeros(0), np.zeros(0)
    return np.concatenate(ys), np.concatenate(ss)


def train_masks(batches, split) -> list:
    """Per batch, the host-side float32 mask of its train-split orders with
    a valid label (``label_mask``)."""
    masks = []
    for b in batches:
        m = np.zeros(b.graph.num_nodes, np.float32)
        sel = split[b.global_order_ids] == 0
        m[np.arange(b.global_order_ids.size)[sel]] = 1.0
        masks.append(m * np.asarray(b.graph.label_mask))
    return masks


def train_lnn(
    batches,
    split: np.ndarray,
    cfg: LNNConfig,
    epochs: int = 60,
    lr: float = 3e-3,
    patience: int = 8,
    seed: int = 0,
    verbose: bool = False,
    device=None,
) -> TrainResult:
    """Train an LNN from ``lnn_init`` (seeded ``torch.Generator``) on
    ``device`` (default: CUDA; ``"cpu"`` runs the plain path).  A community
    with no train label is skipped, decided on the host."""
    dev = resolve_device(device)
    params = lnn_init(torch.Generator().manual_seed(seed), cfg, device=dev)
    init_fn, update_fn = adamw(
        cosine_schedule(lr, total_steps=epochs * max(len(batches), 1), warmup_steps=10),
        weight_decay=1e-4,
    )
    state = init_fn(params)

    graphs = [b.graph.to(dev) for b in batches]
    # each community's graph with its train mask in place of label_mask, or
    # None where the mask is empty (the step is skipped)
    train_graphs = [g.with_rev()._replace(label_mask=torch.from_numpy(m).to(dev))
                    if m.sum() else None
                    for g, m in zip(graphs, train_masks(batches, split))]

    rng = np.random.default_rng(seed)
    best_ap, best_params, best_epoch, stall = -1.0, params, 0, 0
    history = []
    for epoch in range(epochs):
        t0 = time.perf_counter()
        order = rng.permutation(len(batches))
        tot = torch.zeros((), dtype=torch.float64, device=dev)
        for i in order:
            if train_graphs[i] is None:
                continue
            graph = train_graphs[i]
            params, state, loss = grad_step(lambda p: lnn_loss(p, cfg, graph), params, state,
                                            update_fn)
            tot += loss
        yv, sv = collect_scores(params, cfg, batches, split, 1, graphs)
        ap = average_precision(yv, sv) if yv.size and 0 < yv.sum() < yv.size else 0.0
        history.append({"epoch": epoch, "train_loss": float(tot) / max(len(batches), 1),
                        "val_ap": ap, "seconds": time.perf_counter() - t0})
        if verbose:
            print(f"epoch {epoch}: loss={history[-1]['train_loss']:.4f} val_ap={ap:.4f}")
        if ap > best_ap + 1e-5:
            best_ap, best_params, best_epoch, stall = ap, params, epoch, 0
        else:
            stall += 1
            if stall >= patience:
                break
    return TrainResult(params=best_params, history=history, best_epoch=best_epoch)


def evaluate_lnn(params, cfg: LNNConfig, batches, split, which: int = 2, device=None) -> dict:
    """ROC-AUC and AP of ``params`` over the orders of split ``which``, on
    ``device`` (default: CUDA), with the parameters moved there."""
    dev = resolve_device(device)
    params = tree_map(lambda t: t.to(dev), params)
    graphs = [b.graph.to(dev) for b in batches]
    y, s = collect_scores(params, cfg, batches, split, which, graphs)
    return {
        "roc_auc": roc_auc(y, s),
        "average_precision": average_precision(y, s),
        "n": int(y.size),
        "pos": int(y.sum()),
    }
