"""Prefill attention on the card: online softmax, GQA, causal and window.

Wrapper of the CUDA kernel ``csrc/flash_attention.cu``, the port of the TPU
kernel ``repro.kernels.flash_attention.flash_attention_pallas``.  Its plain
version is ``models.common.blockwise_attention`` (``kernels.ref.mha_ref``
is the O(S^2) oracle); ``kernels.ops.flash_attention`` picks between kernel
and plain version by the tensor's device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import (check_aligned, check_launch, check_tensor,
                                       load_library, stream_ptr)

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (64, 128)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int | None = None) -> torch.Tensor:
    """Launch the kernel.  ``q`` [B, Hq, Sq, Dh], ``k``/``v`` [B, Hkv, Sk, Dh]
    with Hq % Hkv == 0 and Dh in {64, 128}, all float32 or all bfloat16,
    contiguous on one CUDA device.  q rows are aligned to the end of the
    keys.  Returns [B, Hq, Sq, Dh] in q's dtype."""
    check_tensor(q, "q", _DTYPES)
    if q.dim() != 4:
        raise ValueError(f"q must be [B, Hq, Sq, Dh], got shape {tuple(q.shape)}")
    bsz, hq, sq, dh = q.shape
    if k.dim() != 4 or k.shape[0] != bsz or k.shape[3] != dh:
        raise ValueError(f"k must be [{bsz}, Hkv, Sk, {dh}], got {tuple(k.shape)}")
    hkv, sk = k.shape[1], k.shape[2]
    check_tensor(k, "k", (q.dtype,), (bsz, hkv, sk, dh), q.device)
    check_tensor(v, "v", (q.dtype,), (bsz, hkv, sk, dh), q.device)
    if hkv == 0 or hq % hkv:
        raise ValueError(f"q heads ({hq}) must be a multiple of kv heads ({hkv})")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not supported; the kernel takes {HEAD_DIMS}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if q.dtype == torch.bfloat16:   # the tensor-core kernel's 16-byte copies
        check_aligned("flash_attention", q, k, v)
    out = torch.empty_like(q)
    if out.numel() == 0 or sk == 0:
        return out.zero_()
    lib = load_library().lib
    fn = lib.flash_attention_f32 if q.dtype == torch.float32 else lib.flash_attention_bf16
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bsz, hq, hkv,
                sq, sk, dh, int(causal), window or 0, dh ** -0.5, stream_ptr(q))
    check_launch(rc, "flash_attention")
    return out
