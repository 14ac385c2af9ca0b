"""The table of peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit) and the roofline bound over them.

A bound is the least time the card could take for a piece of work: the
larger of its bytes over the HBM's rate and its operations over the rate
of the type its inputs are in (bf16 on the tensor cores; f32 outside
them)."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # HBM3
BF16_FLOP_PER_S = 989.4e12    # bf16 and fp16 on the tensor cores, dense
F32_FLOP_PER_S = 67e12        # f32 outside the tensor cores
HBM_BYTES = 80e9

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int32": 4, "int64": 8}


def flop_rate(dtype: str) -> float:
    return BF16_FLOP_PER_S if dtype in ("bfloat16", "float16") else F32_FLOP_PER_S


def bound_s(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """The least seconds for moving ``nbytes`` and doing ``flops`` on inputs
    of ``dtype``, and which of the two bounds it (``"bytes"`` or
    ``"operations"``)."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / flop_rate(dtype)
    return max(tb, tf), ("bytes" if tb >= tf else "operations")
