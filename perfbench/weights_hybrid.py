"""The weights of a granite_hybrid cell (granite-4.0-h-small), made from
``--seed``: ``weights.py``'s tree layout (the port's ``init_params`` on the
meta device), its per-leaf seeds and its scale rules (``weights._fill``),
and for the leaves that rule has none for, the published initialisations
of Mamba2's vectors (``mamba_ssm``'s ``Mamba2``), one row a layer:

* ``a_log``: log U(1, 16), so A = -exp(a_log) lies in [-16, -1];
* ``dt_bias``: the inverse softplus of dt, dt log-uniform in [1e-3, 0.1];
* ``d_skip``: 1;
* ``conv_b`` and the gated norm's ``norm_scale`` (used as ``1 + scale``):
  N(0, 0.1²), small, as ``weights.py`` draws the other norms' scales.

The head is tied to ``embed`` (N(0, 0.02²), the vocabulary's padding
zeros), so the tree has no ``head``.  The reference is handed the same
tensors (``make`` again with the same seed gives the same bits).
"""
from __future__ import annotations

import math

import torch

from perfbench import weights

#: the leaves drawn here, by name; every other leaf takes ``weights._fill``
MAMBA_VECTORS = ("a_log", "dt_bias", "d_skip", "conv_b", "norm_scale")
DT_MIN, DT_MAX = 1e-3, 0.1
A_MIN, A_MAX = 1.0, 16.0


def _fill_vector(name: str, shape, dtype, gen, device):
    def uniform(lo: float, hi: float):
        return torch.rand(shape, generator=gen, device=device, dtype=torch.float32) \
            .mul_(hi - lo).add_(lo)

    if name == "a_log":
        w = uniform(A_MIN, A_MAX).log_()
    elif name == "dt_bias":
        dt = uniform(math.log(DT_MIN), math.log(DT_MAX)).exp_()
        w = dt + torch.log(-torch.expm1(-dt))        # softplus(w) = dt
    elif name == "d_skip":
        w = torch.ones(shape, device=device)
    else:
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32).mul_(0.1)
    return w.to(dtype)


def make(cfg, seed: int, device, dtype=None):
    """The parameter tree of ``cfg`` from ``seed`` on ``device``; ``dtype``
    (default: each leaf's own) casts every leaf."""
    tree: dict = {}
    device = torch.device(device)
    for i, (path, shape, leaf_dtype) in enumerate(weights._layout(cfg)):
        gen = torch.Generator(device=device).manual_seed(weights.leaf_seed(seed, i))
        if path[-1] in MAMBA_VECTORS:
            w = _fill_vector(path[-1], shape, leaf_dtype, gen, device)
        else:
            w = weights._fill(path[-1], shape, leaf_dtype, gen, device, cfg.vocab_size)
        weights._set(tree, path, w if dtype is None else w.to(dtype))
    return tree
