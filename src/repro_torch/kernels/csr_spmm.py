"""Weighted neighbour gather-sum on the card (the GCN/SAGE hot loop).

    out[i, :] = sum_d weights[i, d] * h[nbr_idx[i, d], :]

and its per-edge-type mean, GCN's aggregation, in one launch:

    out[e, i, :] = sum_d (mask * [etype == e])[i, d] / cnt[i, e] * h[nbr_idx[i, d], :]

Wrappers of the CUDA kernels of ``csrc/csr_spmm.cu``, the port of the TPU
kernel ``repro.kernels.csr_spmm.csr_spmm_pallas``.  Their plain versions
are ``kernels.ref.csr_spmm_ref`` and ``kernels.ref.csr_spmm_etype_mean_ref``;
``kernels.ops`` picks between kernel and plain version by the tensor's
device.  Both count their launches under ``csr_spmm``.

Training: :class:`CsrSpmm` and :class:`CsrSpmmEtypeMean` are the
``torch.autograd.Function``s that ``kernels.ops`` takes when a gradient with
respect to ``h`` is wanted.  Their backward is the closed form over the
graph's reverse-slot index, which sums into each source row in a fixed
order: on the card the backward kernels of the same source, one launch a
call, counted under ``csr_spmm_bwd``; on the CPU the plain versions
``kernels.ref.csr_spmm_bwd_ref`` and ``csr_spmm_etype_mean_bwd_ref``, which
give the same bits at any thread count (autograd of the plain forward's
gather would add with atomics).  Under grad the per-type forward kernel
also writes each slot's weight ``mask / cnt[type]``, which its backward
reads.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import (check_differentiable, check_launch, check_rev,
                                        check_tensor, load_library, stream_ptr)

MAX_TYPES = 4    # edge types the per-type kernel holds (csr_spmm.cu's kMaxTypes)


def _check_graph(h, nbr_idx):
    """(N, H, D) of ``h`` [N, H] and ``nbr_idx`` [N, D] int32, or raise."""
    check_tensor(h, "h", (torch.float32, torch.bfloat16))
    if h.dim() != 2:
        raise ValueError(f"h must be [N, H], got shape {tuple(h.shape)}")
    n, hdim = h.shape
    if nbr_idx.dim() != 2 or nbr_idx.shape[0] != n:
        raise ValueError(f"nbr_idx must be [{n}, D], got {tuple(nbr_idx.shape)}")
    d = nbr_idx.shape[1]
    check_tensor(nbr_idx, "nbr_idx", (torch.int32,), (n, d), h.device)
    return n, hdim, d


def csr_spmm_cuda(h: torch.Tensor, nbr_idx: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """Launch the kernel.  ``h`` [N, H] float32 or bfloat16, ``nbr_idx``
    [N, D] int32, ``weights`` [N, D] float32, all contiguous on one CUDA
    device.  Returns [N, H] in ``h``'s dtype, accumulated in float32."""
    n, hdim, d = _check_graph(h, nbr_idx)
    check_tensor(weights, "weights", (torch.float32,), (n, d), h.device)
    out = torch.empty_like(h)
    if n == 0 or hdim == 0:
        return out
    lib = load_library().lib
    fn = lib.csr_spmm_f32 if h.dtype == torch.float32 else lib.csr_spmm_bf16
    with torch.cuda.device(h.device):
        rc = fn(h.data_ptr(), nbr_idx.data_ptr(), weights.data_ptr(),
                out.data_ptr(), n, d, hdim, stream_ptr(h))
    check_launch(rc, "csr_spmm")
    return out


def csr_spmm_etype_mean_cuda(h: torch.Tensor, nbr_idx: torch.Tensor, nbr_mask: torch.Tensor,
                             nbr_etype: torch.Tensor, num_types: int,
                             save_weights: bool = False):
    """Launch the per-edge-type kernel.  ``h`` [N, H] float32 or bfloat16,
    ``nbr_idx`` and ``nbr_etype`` [N, D] int32, ``nbr_mask`` [N, D] float32,
    all contiguous on one CUDA device; 1 <= ``num_types`` <= 4.  Returns
    [num_types, N, H] in ``h``'s dtype, accumulated in float32.  With
    ``save_weights`` (float32 ``h``) returns ``(out, wslot)``: the same
    launch also writes each slot's weight mask / cnt[type] (0 for a type
    outside [0, num_types)), [N, D] float32, which the backward reads."""
    n, hdim, d = _check_graph(h, nbr_idx)
    check_tensor(nbr_mask, "nbr_mask", (torch.float32,), (n, d), h.device)
    check_tensor(nbr_etype, "nbr_etype", (torch.int32,), (n, d), h.device)
    if not 1 <= num_types <= MAX_TYPES:
        raise ValueError(f"num_types must be in [1, {MAX_TYPES}], got {num_types}")
    if save_weights and h.dtype != torch.float32:
        raise TypeError(f"the slot weights are saved for a float32 h, got {h.dtype}")
    out = torch.empty((num_types, n, hdim), dtype=h.dtype, device=h.device)
    wslot = torch.empty((n, d), dtype=torch.float32, device=h.device) if save_weights else None
    if n == 0 or hdim == 0:      # the backward gives zeros here and reads no weights
        return (out, wslot.zero_()) if save_weights else out
    lib = load_library().lib
    with torch.cuda.device(h.device):
        if h.dtype == torch.float32:
            rc = lib.csr_spmm_etype_mean_f32(
                h.data_ptr(), nbr_idx.data_ptr(), nbr_mask.data_ptr(), nbr_etype.data_ptr(),
                out.data_ptr(), wslot.data_ptr() if save_weights else None, n, d, hdim,
                num_types, stream_ptr(h))
        else:
            rc = lib.csr_spmm_etype_mean_bf16(
                h.data_ptr(), nbr_idx.data_ptr(), nbr_mask.data_ptr(), nbr_etype.data_ptr(),
                out.data_ptr(), n, d, hdim, num_types, stream_ptr(h))
    check_launch(rc, "csr_spmm")
    return (out, wslot) if save_weights else out


def csr_spmm_bwd_cuda(dout: torch.Tensor, weights: torch.Tensor, rev_ptr: torch.Tensor,
                      rev_slot: torch.Tensor) -> torch.Tensor:
    """Launch the backward kernel: dh[j] = sum over j's reverse slots (i, d)
    of weights[i, d] * dout[i].  ``dout`` [N, H] and ``weights`` [N, D]
    float32, the reverse-slot index of the graph (``weights`` zero outside
    its slots), all contiguous on one CUDA device.  Returns dh [N, H]."""
    check_tensor(dout, "dout", (torch.float32,))
    if dout.dim() != 2:
        raise ValueError(f"dout must be [N, H], got shape {tuple(dout.shape)}")
    n, hdim = dout.shape
    if weights.dim() != 2 or weights.shape[0] != n:
        raise ValueError(f"weights must be [{n}, D], got {tuple(weights.shape)}")
    d = weights.shape[1]
    check_tensor(weights, "weights", (torch.float32,), (n, d), dout.device)
    check_rev(rev_ptr, rev_slot, n, dout.device)
    dh = torch.empty_like(dout)
    if n == 0 or hdim == 0 or d == 0:
        return dh.zero_()
    lib = load_library().lib
    with torch.cuda.device(dout.device):
        rc = lib.csr_spmm_bwd_f32(dout.data_ptr(), weights.data_ptr(), rev_ptr.data_ptr(),
                                  rev_slot.data_ptr(), dh.data_ptr(), n, d, hdim,
                                  stream_ptr(dout))
    check_launch(rc, "csr_spmm_bwd")
    return dh


def csr_spmm_etype_mean_bwd_cuda(dout: torch.Tensor, wslot: torch.Tensor,
                                 nbr_etype: torch.Tensor, rev_ptr: torch.Tensor,
                                 rev_slot: torch.Tensor) -> torch.Tensor:
    """Launch the per-edge-type backward, one kernel: dh[j] = sum over j's
    reverse slots (i, d) of wslot[i, d] * dout[etype[i, d], i].  ``dout``
    [E, N, H] float32; ``wslot`` [N, D] float32, the weights the forward
    wrote (:func:`csr_spmm_etype_mean_cuda` with ``save_weights``);
    ``nbr_etype`` [N, D] int32 and the graph's reverse-slot index.  Returns
    dh [N, H]."""
    check_tensor(dout, "dout", (torch.float32,))
    if dout.dim() != 3:
        raise ValueError(f"dout must be [E, N, H], got shape {tuple(dout.shape)}")
    num_types, n, hdim = dout.shape
    if not 1 <= num_types <= MAX_TYPES:
        raise ValueError(f"num_types must be in [1, {MAX_TYPES}], got {num_types}")
    if wslot.dim() != 2 or wslot.shape[0] != n:
        raise ValueError(f"wslot must be [{n}, D], got {tuple(wslot.shape)}")
    d = wslot.shape[1]
    check_tensor(wslot, "wslot", (torch.float32,), (n, d), dout.device)
    check_tensor(nbr_etype, "nbr_etype", (torch.int32,), (n, d), dout.device)
    check_rev(rev_ptr, rev_slot, n, dout.device)
    dh = torch.empty((n, hdim), dtype=dout.dtype, device=dout.device)
    if n == 0 or hdim == 0 or d == 0:
        return dh.zero_()
    lib = load_library().lib
    with torch.cuda.device(dout.device):
        rc = lib.csr_spmm_etype_mean_bwd_f32(
            dout.data_ptr(), wslot.data_ptr(), nbr_etype.data_ptr(), rev_ptr.data_ptr(),
            rev_slot.data_ptr(), dh.data_ptr(), n, d, hdim, num_types, stream_ptr(dout))
    check_launch(rc, "csr_spmm_bwd")
    return dh


class CsrSpmm(torch.autograd.Function):
    """:func:`csr_spmm_cuda` (``cuda``) or its plain version, with the
    gradient with respect to ``h`` in closed form over the reverse-slot
    index: :func:`csr_spmm_bwd_cuda` or ``ref.csr_spmm_bwd_ref``.  The
    weights get none."""

    @staticmethod
    def forward(ctx, h, nbr_idx, weights, rev_ptr, rev_slot, cuda):
        ctx.cuda, ctx.dtype = cuda, h.dtype
        ctx.save_for_backward(weights, rev_ptr, rev_slot)
        if cuda:
            return csr_spmm_cuda(h, nbr_idx, weights)
        return ref.csr_spmm_ref(h, nbr_idx, weights)

    @staticmethod
    def backward(ctx, dout):
        weights, rev_ptr, rev_slot = ctx.saved_tensors
        if ctx.cuda:
            dh = csr_spmm_bwd_cuda(dout.contiguous(), weights, rev_ptr, rev_slot)
        else:
            dh = ref.csr_spmm_bwd_ref(dout, weights, rev_ptr, rev_slot)
        return dh.to(ctx.dtype), None, None, None, None, None


class CsrSpmmEtypeMean(torch.autograd.Function):
    """:func:`csr_spmm_etype_mean_cuda` (``cuda``; saving the slot weights)
    or its plain version, with the gradient with respect to ``h`` from
    :func:`csr_spmm_etype_mean_bwd_cuda` or
    ``ref.csr_spmm_etype_mean_bwd_ref``."""

    @staticmethod
    def forward(ctx, h, nbr_idx, nbr_mask, nbr_etype, num_types, rev_ptr, rev_slot, cuda):
        ctx.cuda, ctx.dtype = cuda, h.dtype
        if cuda:
            out, wslot = csr_spmm_etype_mean_cuda(h, nbr_idx, nbr_mask, nbr_etype, num_types,
                                                  save_weights=True)
            ctx.save_for_backward(wslot, nbr_etype, rev_ptr, rev_slot)
            return out
        ctx.save_for_backward(nbr_mask, nbr_etype, rev_ptr, rev_slot)
        return ref.csr_spmm_etype_mean_ref(h, nbr_idx, nbr_mask, nbr_etype, num_types)

    @staticmethod
    def backward(ctx, dout):
        if ctx.cuda:
            dh = csr_spmm_etype_mean_bwd_cuda(dout.contiguous(), *ctx.saved_tensors)
        else:
            dh = ref.csr_spmm_etype_mean_bwd_ref(dout, *ctx.saved_tensors)
        return dh.to(ctx.dtype), None, None, None, None, None, None, None


def csr_spmm_autograd(h, nbr_idx, weights, rev, cuda: bool):
    """:class:`CsrSpmm` on the graph's reverse-slot index ``rev``.  On the
    card it raises where the backward kernel cannot give the gradient
    autograd wants; on the CPU a missing ``rev`` is built from the weights'
    non-zero slots."""
    if cuda:
        check_differentiable("csr_spmm", h, rev, weights=weights)
    elif rev is None:
        rev = ref.reverse_slots_ref(nbr_idx, weights != 0)
    return CsrSpmm.apply(h, nbr_idx, weights, *rev, cuda)


def csr_spmm_etype_mean_autograd(h, nbr_idx, nbr_mask, nbr_etype, num_types, rev,
                                 cuda: bool):
    """:class:`CsrSpmmEtypeMean` on the graph's reverse-slot index ``rev``,
    as :func:`csr_spmm_autograd` (a missing ``rev`` built from the mask)."""
    if cuda:
        check_differentiable("csr_spmm", h, rev, nbr_mask=nbr_mask)
    elif rev is None:
        rev = ref.reverse_slots_ref(nbr_idx, nbr_mask)
    return CsrSpmmEtypeMean.apply(h, nbr_idx, nbr_mask, nbr_etype, num_types, *rev, cuda)
