"""Mamba2 SSD scan on the card (the prefill hot loop of every Mamba2 block).

Wrapper of the CUDA kernel ``csrc/ssd_scan.cu``, the port of the TPU kernel
``repro.kernels.ssd_scan.ssd_scan_pallas``.  Its plain versions are
``kernels.ref.ssd_chunked_ref`` and ``ssd_scan_ref``; ``kernels.ops.ssd_scan``
picks between kernel and plain version by the tensor's device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import (check_aligned, check_launch, check_tensor, load_library,
                                       stream_ptr)

_DTYPES = (torch.float32, torch.bfloat16)
_BF16_N = (64, 128)   # the state widths the bf16 kernel is built for


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor,
                  d_skip: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel.  ``x`` [B, S, H, P], ``b``/``c`` [B, S, N], all
    float32 or all bfloat16; ``dt`` [B, S, H], ``a`` [H] and ``d_skip`` [H]
    float32; all contiguous on one CUDA device.  Any S (the last chunk is
    padded with exact no-op rows).  float32 takes any N and P; bfloat16 (the
    tensor-core kernel) takes N in (64, 128) and P a multiple of 8, with x,
    b and c on 16-byte boundaries.  Returns y [B, S, H, P] in x's dtype,
    with ``d_skip * x`` added when ``d_skip`` is given."""
    check_tensor(x, "x", _DTYPES)
    if x.dim() != 4:
        raise ValueError(f"x must be [B, S, H, P], got shape {tuple(x.shape)}")
    bsz, s, h, p = x.shape
    if b.dim() != 3 or tuple(b.shape[:2]) != (bsz, s):
        raise ValueError(f"b must be [{bsz}, {s}, N], got {tuple(b.shape)}")
    n = b.shape[2]
    check_tensor(b, "b", (x.dtype,), (bsz, s, n), x.device)
    check_tensor(c, "c", (x.dtype,), (bsz, s, n), x.device)
    check_tensor(dt, "dt", (torch.float32,), (bsz, s, h), x.device)
    check_tensor(a, "a", (torch.float32,), (h,), x.device)
    if d_skip is not None:
        check_tensor(d_skip, "d_skip", (torch.float32,), (h,), x.device)
    if x.dtype == torch.bfloat16:
        if n not in _BF16_N or p % 8:
            raise ValueError(f"the bf16 ssd_scan kernel takes N in {_BF16_N} and P a "
                             f"multiple of 8, got N={n}, P={p}")
        check_aligned("ssd_scan", x, b, c)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    lib = load_library().lib
    fn = lib.ssd_scan_f32 if x.dtype == torch.float32 else lib.ssd_scan_bf16
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                None if d_skip is None else d_skip.data_ptr(), y.data_ptr(),
                bsz, s, h, p, n, stream_ptr(x))
    check_launch(rc, "ssd_scan")
    return y
