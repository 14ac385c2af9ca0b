"""Helpers over the port's parameter trees: nested dicts, lists, tuples and
NamedTuples with tensor leaves (``params.tree_map``'s trees), the
counterpart of the reference's ``repro.utils.tree``."""
from __future__ import annotations

import math

import torch

from repro_torch.params import tree_leaves, tree_map


def tree_size(tree) -> int:
    """Total number of elements of the leaves (anything with a ``shape``;
    a leaf without one counts 1, as a scalar)."""
    return sum(math.prod(getattr(leaf, "shape", ())) for leaf in tree_leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes of the tensor leaves (meta tensors too)."""
    return sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(tree))


def tree_zeros_like(tree):
    """The tree with every tensor leaf replaced by zeros of its shape, dtype
    and device."""
    return tree_map(torch.zeros_like, tree)


def tree_map_with_path(fn, tree, _prefix: str = ""):
    """Map ``fn(path, leaf)`` over ``tree``; ``path`` is the ``/``-joined
    dict keys, list positions and NamedTuple field names from the root (the
    npz layout of ``params.save_npz``)."""
    def join(key):
        return f"{_prefix}/{key}" if _prefix else str(key)

    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, join(f))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, join(i)) for i, v in enumerate(tree)]
    return fn(_prefix, tree)
