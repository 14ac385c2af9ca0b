"""MLP baseline (paper Table 3 row 1) on the GBDT-encoded checkout features,
the port of the reference's ``repro.baselines.mlp``.

The same model, loss, optimizer (``train.optim.adamw``) and host loop:
minibatches sliced from a numpy permutation per epoch, early stopping on
the validation loss.  Parameters are a list of ``{"w", "b"}`` dicts of
tensors in the reference's ``x @ W`` layout, so a reference tree crosses
through ``params.from_numpy``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.params import tree_leaves
from repro_torch.train.optim import adamw, grad_step
from repro_torch.utils.device import resolve_device


@dataclass(frozen=True)
class MLPConfig:
    hidden_dims: tuple = (64, 32)
    lr: float = 1e-3
    epochs: int = 200
    batch_size: int = 512
    pos_weight: float = 1.0
    patience: int = 20
    seed: int = 0


def mlp_init(rng: torch.Generator, in_dim: int, cfg: MLPConfig, device=None):
    """He-normal weights and zero biases on ``device`` (default: CUDA).
    ``rng`` is a CPU ``torch.Generator``: the draws are made on the host, so
    one seed gives the same weights on every device (not the reference's,
    which draws from ``jax.random``)."""
    dev = resolve_device(device)
    dims = (in_dim,) + tuple(cfg.hidden_dims) + (1,)
    params = []
    for i in range(len(dims) - 1):
        scale = math.sqrt(2.0 / dims[i])
        params.append({
            "w": (scale * torch.randn((dims[i], dims[i + 1]), generator=rng)).to(dev),
            "b": torch.zeros((dims[i + 1],), device=dev),
        })
    return params


def mlp_forward(params, x):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i + 1 < len(params):
            x = torch.relu(x)
    return x[..., 0]


def _bce(params, x, y, pos_weight):
    logits = mlp_forward(params, x)
    return -(pos_weight * y * F.logsigmoid(logits) + (1 - y) * F.logsigmoid(-logits)).mean()


def train_mlp(
    x: np.ndarray,
    y: np.ndarray,
    x_val: np.ndarray,
    y_val: np.ndarray,
    cfg: MLPConfig = MLPConfig(),
    device=None,
):
    """Mini-batch AdamW training with early stopping on val loss, on
    ``device`` (default: CUDA; ``"cpu"`` runs on the host).  The data moves
    to the device once; a minibatch is a slice of the epoch's permutation
    there."""
    dev = resolve_device(device)
    params = mlp_init(torch.Generator().manual_seed(cfg.seed), x.shape[1], cfg, device=dev)
    init_fn, update_fn = adamw(cfg.lr, weight_decay=1e-4)
    state = init_fn(params)

    def on_dev(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

    xt, yt, xv, yv = on_dev(x), on_dev(y), on_dev(x_val), on_dev(y_val)
    n = x.shape[0]
    best_val, best_params, stall = np.inf, params, 0
    perm_rng = np.random.default_rng(cfg.seed)
    for _ in range(cfg.epochs):
        perm = torch.from_numpy(perm_rng.permutation(n)).to(dev)
        for i in range(0, n, cfg.batch_size):
            sl = perm[i : i + cfg.batch_size]
            xb, yb = xt[sl], yt[sl]
            params, state, _ = grad_step(lambda p: _bce(p, xb, yb, cfg.pos_weight), params,
                                         state, update_fn)
        with torch.no_grad():
            vl = float(_bce(params, xv, yv, cfg.pos_weight))
        if vl < best_val - 1e-6:
            best_val, best_params, stall = vl, params, 0
        else:
            stall += 1
            if stall >= cfg.patience:
                break
    return best_params


def predict_mlp(params, x: np.ndarray) -> np.ndarray:
    """Fraud probabilities of ``x`` as float32 numpy, computed on the
    parameters' device."""
    dev = tree_leaves(params)[0].device
    with torch.no_grad():
        xt = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
        return torch.sigmoid(mlp_forward(params, xt)).cpu().numpy()
