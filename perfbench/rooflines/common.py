"""Shared arithmetic of the kernels' roofline counts: tensor bytes from
shapes and types, and the bound over the card's peaks."""
from __future__ import annotations

from math import prod

from perfbench.peaks import DTYPE_BYTES, bound_s


def nbytes(shape, dtype: str) -> int:
    return prod(shape) * DTYPE_BYTES[dtype]


def bound(tensors, flops: float, dtype: str) -> tuple[float, str]:
    """``bound_s`` of reading or writing each of ``tensors`` ((shape, dtype)
    pairs) once and doing ``flops`` on inputs of ``dtype``."""
    return bound_s(sum(nbytes(s, t) for s, t in tensors), flops, dtype)
