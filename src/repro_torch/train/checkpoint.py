"""Checkpointing: save/restore a tree of tensors to a single ``.npz`` file,
in the layout of the reference's ``repro.train.checkpoint``.

Leaves are flattened with ``/``-joined key paths as npz keys
(``params.flatten_paths``: dict keys, list positions, a NamedTuple's field
names, as JAX names them), plus an optional ``__step__``; the structure is
rebuilt from the example tree passed to :func:`load_checkpoint`.  A file
either package writes, the other reads.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.params import _STEP_KEY, flatten_paths, from_numpy, save_npz, tree_unflatten


def save_checkpoint(path: str, tree, step: int | None = None) -> str:
    """Atomically write ``tree`` to ``path`` (.npz) (``params.save_npz``)."""
    return save_npz(path, tree, step)


def load_checkpoint(path: str, like):
    """Restore a tree saved by ``save_checkpoint`` (of either package) into
    the structure of ``like``.  A tensor leaf of ``like`` comes back as a
    tensor on its device, in the file's dtype; any other leaf as a numpy
    array.  Raises ``KeyError`` for a leaf missing from the file and
    ``ValueError`` for one whose shape differs from ``like``'s.

    Returns (tree, step) where step is None if absent.
    """
    with np.load(path) as data:
        step = int(data[_STEP_KEY]) if _STEP_KEY in data else None
        leaves = []
        for key, leaf in flatten_paths(like):
            if key not in data:
                raise KeyError(f"checkpoint {path!r} missing key {key!r}")
            arr = data[key]
            want = tuple(getattr(leaf, "shape", arr.shape))
            if tuple(arr.shape) != want:
                raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {want}")
            leaves.append(from_numpy(arr, leaf.device) if isinstance(leaf, torch.Tensor)
                          else arr)
    return tree_unflatten(like, leaves), step
