"""The weights of a cell, made from ``--seed``.

The tree's key paths, shapes and dtypes are the port's: its
``init_params`` on the ``meta`` device, which draws nothing.  Each leaf
is then filled with its own generator (seeded from the run's seed and the
leaf's position in the tree) and its own scale rule, on the device, in
one call a leaf, in the type it is served in.  The reference is handed
the same tensors (``make`` again with the same seed gives the same bits).

Scale rules, by the leaf's name:

* ``embed``: N(0, 0.02²);
* matrices ``[.., in, out]``: N(0, 1/in);
* norm scales (used as ``1 + scale``): N(0, 0.01);
* the padding of the vocabulary (rows of ``embed``, columns of ``head``
  past ``vocab_size``): zeros, as a checkpoint padded for the card holds.
"""
from __future__ import annotations

import functools

import torch

NORMS = ("ln1", "ln2", "final_ln")


def leaf_paths(tree, prefix=()):
    """``[(path, tensor)]`` in a fixed order (sorted keys)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaf_paths(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _fill(name: str, shape, dtype, gen, device, vocab: int):
    def randn():
        # drawn in the leaf's own type: no f32 copy of a multi-GB leaf
        return torch.randn(shape, generator=gen, device=device, dtype=dtype)

    if name == "embed":
        w = randn().mul_(0.02)
        w[vocab:] = 0.0
    elif name == "head":
        w = randn().mul_(shape[-2] ** -0.5)
        w[..., vocab:] = 0.0
    elif name in NORMS:
        w = randn().mul_(0.1)
    elif len(shape) >= 2:
        w = randn().mul_(shape[-2] ** -0.5)
    else:
        raise ValueError(f"no scale rule for the leaf {name!r} of shape {tuple(shape)}")
    return w.to(dtype)


def leaf_seed(seed: int, index: int) -> int:
    return (int(seed) * 1_000_003 + 7919 * (index + 1)) % (2**63 - 1)


@functools.lru_cache(maxsize=4)
def _layout(cfg) -> tuple:
    """((key path, shape, dtype), ...) of ``cfg``'s tree: the port's
    ``init_params`` on the meta device (seconds at full depth, so once)."""
    from repro_torch.models import init_params

    tree = init_params(torch.Generator(), cfg, device="meta")
    return tuple((path, tuple(t.shape), t.dtype) for path, t in leaf_paths(tree))


def make(cfg, seed: int, device, dtype=None):
    """The parameter tree of ``cfg`` (an ``ArchConfig``) from ``seed`` on
    ``device``; ``dtype`` (default: each leaf's own) casts every leaf, as
    the reference takes them in f32."""
    tree: dict = {}
    device = torch.device(device)
    for i, (path, shape, leaf_dtype) in enumerate(_layout(cfg)):
        gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, i))
        w = _fill(path[-1], shape, leaf_dtype, gen, device, cfg.vocab_size)
        _set(tree, path, w if dtype is None else w.to(dtype))
    return tree


def dtypes(cfg) -> dict:
    """{"/"-joined key path: dtype} of every leaf of ``cfg``'s tree."""
    return {"/".join(path): dtype for path, _, dtype in _layout(cfg)}
