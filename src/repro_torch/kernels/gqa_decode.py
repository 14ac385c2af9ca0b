"""Single-token GQA decode attention over the KV cache, on the card.

Wrapper of the CUDA kernel ``csrc/gqa_decode.cu``, the port of the TPU
kernel ``repro.kernels.gqa_decode.gqa_decode_pallas``.  Its plain version
is ``kernels.ref.gqa_decode_ref``; ``kernels.ops.gqa_decode`` picks between
them by the tensor's device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import (check_aligned, check_launch, check_tensor,
                                       load_library, stream_ptr)

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (64, 128)
MAX_REP = 16     # q heads per kv head the kernel holds (csrc/gqa_decode.cu)
CHUNK = 64       # cache rows per split of the first pass (csrc/gqa_decode.cu)


def gqa_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: torch.Tensor | None = None,
                    window: int | None = None, scale: float | None = None) -> torch.Tensor:
    """Launch the kernel.  ``q`` [B, Hq, Dh], ``k``/``v`` [B, Hkv, S, Dh]
    (the cache) with Hq / Hkv <= 16 and Dh in {64, 128}, all float32 or all
    bfloat16; ``kv_len`` [B] int32 valid lengths (None: all S); all
    contiguous on one CUDA device; the logits scaled by ``scale`` (default
    ``Dh ** -0.5``).  Returns [B, Hq, Dh] in q's dtype.

    Two kernels run, counted as one launch: per-split partials into f32
    scratch, then their combine.  ``kv_len`` is read only on the card."""
    check_tensor(q, "q", _DTYPES)
    if q.dim() != 3:
        raise ValueError(f"q must be [B, Hq, Dh], got shape {tuple(q.shape)}")
    bsz, hq, dh = q.shape
    if k.dim() != 4 or k.shape[0] != bsz or k.shape[3] != dh:
        raise ValueError(f"k must be [{bsz}, Hkv, S, {dh}], got {tuple(k.shape)}")
    hkv, s = k.shape[1], k.shape[2]
    check_tensor(k, "k", (q.dtype,), (bsz, hkv, s, dh), q.device)
    check_tensor(v, "v", (q.dtype,), (bsz, hkv, s, dh), q.device)
    if hkv == 0 or hq % hkv or hq // hkv > MAX_REP:
        raise ValueError(f"q heads ({hq}) must be 1..{MAX_REP} times the kv heads ({hkv})")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not supported; the kernel takes {HEAD_DIMS}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if kv_len is None:
        kv_len = torch.full((bsz,), s, dtype=torch.int32, device=q.device)
    check_tensor(kv_len, "kv_len", (torch.int32,), (bsz,), q.device)
    check_aligned("gqa_decode", k, v)
    out = torch.empty_like(q)
    if out.numel() == 0 or s == 0:
        return out.zero_()
    n_split = -(-s // CHUNK)   # from the buffer, never from kv_len
    scratch = torch.empty(bsz * hq * n_split * (dh + 2), dtype=torch.float32,
                          device=q.device)
    lib = load_library().lib
    fn = lib.gqa_decode_f32 if q.dtype == torch.float32 else lib.gqa_decode_bf16
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), bsz, hkv, hq // hkv, s, dh, n_split, window or 0,
                dh ** -0.5 if scale is None else scale, stream_ptr(q))
    check_launch(rc, "gqa_decode")
    return out
