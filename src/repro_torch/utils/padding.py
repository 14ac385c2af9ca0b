"""Shape-padding helpers.

TPU/XLA strongly prefer static, hardware-aligned shapes (MXU tiles are
128x128, VPU lanes 8x128).  Everything ragged in this codebase (graph
neighborhoods, vocab tables, head counts) is padded with these helpers so
the padding policy lives in one place.
"""
from __future__ import annotations

import numpy as np


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``n``."""
    if m <= 0:
        raise ValueError(f"multiple must be positive, got {m}")
    return ceil_div(n, m) * m


def pad_axis_to(x: np.ndarray, size: int, axis: int, fill=0) -> np.ndarray:
    """Pad numpy array ``x`` along ``axis`` up to ``size`` with ``fill``."""
    cur = x.shape[axis]
    if cur > size:
        raise ValueError(f"axis {axis} already {cur} > target {size}")
    if cur == size:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, size - cur)
    return np.pad(x, widths, mode="constant", constant_values=fill)
