"""Carry parameter trees across: numpy trees and ``.npz`` files to tensors.

A tree is nested dicts and lists with array leaves, as ``lnn_init`` builds
it.  The file layout is the reference's checkpoint layout
(``repro.train.checkpoint``): one npz entry per leaf, named by its
``/``-joined key path such as ``gnn/0/w_self``; an optional ``__step__``
entry is ignored here.  List positions are decimal keys, so a tree is rebuilt
from the names alone.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from repro_torch.utils.device import resolve_device

_STEP_KEY = "__step__"
#: how an npz holds a bfloat16 leaf: its raw 2-byte values, numpy dtype |V2
_BF16_BITS = np.dtype("V2")


def tree_map(fn, tree, *rest):
    """``tree`` with ``fn`` applied to every leaf (dicts, lists and
    NamedTuples kept; other tuples become lists).  With ``rest``, trees of
    the same structure, ``fn`` takes the leaf of each at the same key path
    (dicts are matched by key, not by order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in :func:`tree_map`'s (and
    :func:`flatten_paths`') order."""
    return [leaf for _, leaf in flatten_paths(tree)]


def tree_unflatten(like, leaves):
    """A tree of ``like``'s structure (as :func:`tree_map` builds it) holding
    ``leaves`` in :func:`tree_leaves`' order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def _is_bf16(dtype: np.dtype) -> bool:
    """A numpy bfloat16 (``ml_dtypes``, what ``np.asarray`` of a JAX bf16
    array gives, recognised by name so ``ml_dtypes`` is never imported), or
    the 2-byte void form an npz holds it in."""
    return dtype.name == "bfloat16" or dtype == _BF16_BITS


def _leaf_to_tensor(x) -> torch.Tensor:
    arr = np.array(x, copy=True)
    if _is_bf16(arr.dtype):
        # torch.from_numpy refuses ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def from_numpy(tree, device=None):
    """The tree with every leaf (a numpy array, or anything ``np.asarray``
    takes) as a tensor on ``device`` (default: CUDA), dtype kept; bfloat16
    leaves keep their bits."""
    dev = resolve_device(device)
    return tree_map(lambda x: _leaf_to_tensor(x).to(dev), tree)


def to_numpy(tree):
    """The tree with every tensor leaf as a numpy array on the host.  numpy
    has no bfloat16 of its own, so a bfloat16 leaf comes back as its bits in
    a 2-byte void array, the form ``np.savez`` gives an ``ml_dtypes``
    bfloat16 array and ``load_npz`` reads back as bfloat16."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy().view(_BF16_BITS)
        return t.numpy()
    return tree_map(leaf, tree)


def flatten_paths(tree, prefix=""):
    """Yield ``(path, leaf)`` pairs of ``tree``, paths ``/``-joined: dict
    keys, list positions and a NamedTuple's field names, as JAX names them."""
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from flatten_paths(v, f"{prefix}/{k}" if prefix else k)


def save_npz(path: str, tree, step: int | None = None) -> str:
    """Atomically write ``tree`` to ``path`` in the ``/``-joined layout, and
    ``step``, where given, under ``__step__`` (the layout of the reference's
    ``save_checkpoint``): into a temporary file of the same directory, then
    renamed.  A tensor leaf is written as :func:`to_numpy` gives it."""
    payload = {k: np.asarray(to_numpy(v) if isinstance(v, torch.Tensor) else v)
               for k, v in flatten_paths(tree)}
    if step is not None:
        payload[_STEP_KEY] = np.asarray(step, np.int64)
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def _listify(node):
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        if sorted(int(k) for k in node) != list(range(len(node))):
            raise ValueError(f"list positions {sorted(node)} are not 0..{len(node) - 1}")
        return [node[str(i)] for i in range(len(node))]
    return node


def load_npz(path: str, device=None):
    """Read a tree written by :func:`save_npz` (or by the reference's
    ``save_checkpoint``) onto ``device`` (default: CUDA).  A 2-byte void
    entry is a bfloat16 leaf (how ``np.savez`` stores one)."""
    root: dict = {}
    with np.load(path) as data:
        for key in data.files:
            if key == _STEP_KEY:
                continue
            *parents, leaf = key.split("/")
            node = root
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    return from_numpy(_listify(root), device)
