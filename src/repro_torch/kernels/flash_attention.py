"""Prefill attention on the card: online softmax, GQA, causal and window.

Wrapper of the CUDA kernel ``csrc/flash_attention.cu``, the port of the TPU
kernel ``repro.kernels.flash_attention.flash_attention_pallas``.  Its plain
version is ``kernels.ref.blockwise_attention`` (``kernels.ref.mha_ref``
is the O(S^2) oracle); ``kernels.ops.flash_attention`` picks between kernel
and plain version by the tensor's device.

Training: :class:`FlashAttention` is the ``torch.autograd.Function`` that
``kernels.ops`` takes when a gradient is wanted.  Its forward also keeps
each q row's logsumexp (the kernel writes it under grad; on the CPU
``kernels.ref.attention_lse_ref``), and its backward is the closed form
of ``kernels.ref.flash_attention_bwd_ref``: on the card the backward kernel
of the same source (:func:`flash_attention_bwd_cuda`, one launch a call,
counted under ``flash_attention_bwd``), on the CPU the plain version.  The
reference has no backward kernel: it differentiates its XLA path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import (check_aligned, check_launch, check_tensor,
                                       load_library, stream_ptr)

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (64, 128)


def _check_qkv(q, k, v, window):
    """(B, Hq, Hkv, Sq, Sk, Dh) of the attention's inputs, or raise."""
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
    return bsz, hq, hkv, sq, sk, dh


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, window: int | None = None,
                         save_lse: bool = False, scale: float | None = None):
    """Launch the kernel.  ``q`` [B, Hq, Sq, Dh], ``k``/``v`` [B, Hkv, Sk, Dh]
    with Hq % Hkv == 0 and Dh in {64, 128}, all float32 or all bfloat16,
    contiguous on one CUDA device.  q rows are aligned to the end of the
    keys; the logits are scaled by ``scale`` (default ``Dh ** -0.5``).
    Returns [B, Hq, Sq, Dh] in q's dtype; with ``save_lse`` also
    each row's logsumexp [B, Hq, Sq] f32 (``ref.attention_lse_ref``), which
    the kernel then writes beside the output (the output's bits do not
    change)."""
    bsz, hq, hkv, sq, sk, dh = _check_qkv(q, k, v, window)
    if q.dtype == torch.bfloat16:   # the tensor-core kernel's 16-byte copies
        check_aligned("flash_attention", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((bsz, hq, sq), dtype=torch.float32, device=q.device) if save_lse else None
    if out.numel() == 0 or sk == 0:
        out.zero_()
        return (out, lse.fill_(float("-inf"))) if save_lse else out
    lib = load_library().lib
    fn = lib.flash_attention_f32 if q.dtype == torch.float32 else lib.flash_attention_bf16
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), bsz, hq, hkv, sq, sk, dh,
                int(causal), window or 0, dh ** -0.5 if scale is None else scale,
                stream_ptr(q))
    check_launch(rc, "flash_attention")
    return (out, lse) if save_lse else out


def flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal: bool = True,
                             window: int | None = None, scale: float | None = None):
    """Launch the backward kernel: (dq, dk, dv) in the dtypes of q, k, v from
    the forward's inputs, its output ``out``, the output's gradient ``dout``
    (both [B, Hq, Sq, Dh] in q's dtype) and the row logsumexp ``lse``
    [B, Hq, Sq] f32 that :func:`flash_attention_cuda` saved.  One C call:
    ``delta = rowsum(dout * out)``, then dk and dv (a block per key tile,
    summing over the kv head's q heads in order), then dq; no atomics, so
    two calls give the same bits.  float32 runs the CUDA-core kernels;
    bfloat16 the tensor-core ones, whose roundings
    ``ref.flash_attention_bwd_mma_ref`` models, with q, k, v and dout on
    16-byte boundaries."""
    bsz, hq, hkv, sq, sk, dh = _check_qkv(q, k, v, window)
    check_tensor(out, "out", (q.dtype,), q.shape, q.device)
    check_tensor(dout, "dout", (q.dtype,), q.shape, q.device)
    check_tensor(lse, "lse", (torch.float32,), (bsz, hq, sq), q.device)
    if q.dtype == torch.bfloat16:   # the tensor-core kernels' 16-byte copies
        check_aligned("flash_attention_bwd", q, k, v, dout)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((bsz, hq, sq), dtype=torch.float32, device=q.device)
    lib = load_library().lib
    fn = lib.flash_attention_bwd_f32 if q.dtype == torch.float32 else \
        lib.flash_attention_bwd_bf16
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                bsz, hq, hkv, sq, sk, dh, int(causal), window or 0,
                dh ** -0.5 if scale is None else scale, stream_ptr(q))
    check_launch(rc, "flash_attention_bwd")
    return dq, dk, dv


def flash_attention_plain(q, k, v, causal: bool = True, window: int | None = None,
                          scale: float | None = None):
    """The plain version: the reference's XLA path, ``ref.blockwise_attention``
    over key blocks of min(512, Sk)."""
    return ref.blockwise_attention(q, k, v, causal=causal, window=window,
                                   block_k=min(512, k.shape[2]), scale=scale)


class FlashAttention(torch.autograd.Function):
    """Prefill attention with a backward: the kernel saving the row
    logsumexp and :func:`flash_attention_bwd_cuda` (``cuda``), or the plain
    version, ``ref.attention_lse_ref`` and ``ref.flash_attention_bwd_ref``.
    The forward's output is the no-grad path's, bit for bit."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cuda, scale=None):
        if cuda:
            out, lse = flash_attention_cuda(q, k, v, causal, window, save_lse=True, scale=scale)
        else:
            out = flash_attention_plain(q, k, v, causal, window, scale)
            lse = ref.attention_lse_ref(q, k, causal, window, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mode = (causal, window, cuda, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        causal, window, cuda, scale = ctx.mode
        fn = flash_attention_bwd_cuda if cuda else ref.flash_attention_bwd_ref
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = fn(q, k, v, out, dout.contiguous(), lse, causal, window, scale)
        return dq, dk, dv, None, None, None, None
