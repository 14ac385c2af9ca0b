"""Weighted neighbour gather-sum on the card (the GCN/SAGE hot loop).

    out[i, :] = sum_d weights[i, d] * h[nbr_idx[i, d], :]

and its per-edge-type mean, GCN's aggregation, in one launch:

    out[e, i, :] = sum_d (mask * [etype == e])[i, d] / cnt[i, e] * h[nbr_idx[i, d], :]

Wrappers of the CUDA kernels of ``csrc/csr_spmm.cu``, the port of the TPU
kernel ``repro.kernels.csr_spmm.csr_spmm_pallas``.  Their plain versions
are ``kernels.ref.csr_spmm_ref`` and ``kernels.ref.csr_spmm_etype_mean_ref``;
``kernels.ops`` picks between kernel and plain version by the tensor's
device.  Both count their launches under ``csr_spmm``.

Training: the gradient with respect to ``h`` comes from the backward
kernels of the same source (plain versions ``kernels.ref.csr_spmm_bwd_ref``
and ``csr_spmm_etype_mean_bwd_ref``), which sum into source rows over the
graph's reverse-slot index; :class:`CsrSpmm` and :class:`CsrSpmmEtypeMean`
are the ``torch.autograd.Function``s that ``kernels.ops`` takes on the
card when a gradient is wanted.  The backward wrappers count under
``csr_spmm_bwd`` (the per-type one: two kernels a call).
"""
from __future__ import annotations

import torch

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
                             nbr_etype: torch.Tensor, num_types: int) -> torch.Tensor:
    """Launch the per-edge-type kernel.  ``h`` [N, H] float32 or bfloat16,
    ``nbr_idx`` and ``nbr_etype`` [N, D] int32, ``nbr_mask`` [N, D] float32,
    all contiguous on one CUDA device; 1 <= ``num_types`` <= 4.  Returns
    [num_types, N, H] in ``h``'s dtype, accumulated in float32."""
    n, hdim, d = _check_graph(h, nbr_idx)
    check_tensor(nbr_mask, "nbr_mask", (torch.float32,), (n, d), h.device)
    check_tensor(nbr_etype, "nbr_etype", (torch.int32,), (n, d), h.device)
    if not 1 <= num_types <= MAX_TYPES:
        raise ValueError(f"num_types must be in [1, {MAX_TYPES}], got {num_types}")
    out = torch.empty((num_types, n, hdim), dtype=h.dtype, device=h.device)
    if n == 0 or hdim == 0:
        return out
    lib = load_library().lib
    fn = lib.csr_spmm_etype_mean_f32 if h.dtype == torch.float32 else lib.csr_spmm_etype_mean_bf16
    with torch.cuda.device(h.device):
        rc = fn(h.data_ptr(), nbr_idx.data_ptr(), nbr_mask.data_ptr(), nbr_etype.data_ptr(),
                out.data_ptr(), n, d, hdim, num_types, stream_ptr(h))
    check_launch(rc, "csr_spmm")
    return out


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


def csr_spmm_etype_mean_bwd_cuda(dout: torch.Tensor, nbr_idx: torch.Tensor,
                                 nbr_mask: torch.Tensor, nbr_etype: torch.Tensor,
                                 rev_ptr: torch.Tensor, rev_slot: torch.Tensor) -> torch.Tensor:
    """Launch the per-edge-type backward (two kernels: each slot's weight
    mask / cnt[type] into a scratch [N, D], then the sum over the reverse
    index): dh[j] = sum over j's slots (i, d) of that weight times
    dout[etype[i, d], i].  ``dout`` [E, N, H] float32, the graph as for
    :func:`csr_spmm_etype_mean_cuda` and its reverse-slot index (``nbr_mask``
    zero outside its slots).  Returns dh [N, H]."""
    check_tensor(dout, "dout", (torch.float32,))
    if dout.dim() != 3:
        raise ValueError(f"dout must be [E, N, H], got shape {tuple(dout.shape)}")
    num_types, n, hdim = dout.shape
    if not 1 <= num_types <= MAX_TYPES:
        raise ValueError(f"num_types must be in [1, {MAX_TYPES}], got {num_types}")
    if nbr_idx.dim() != 2 or nbr_idx.shape[0] != n:
        raise ValueError(f"nbr_idx must be [{n}, D], got {tuple(nbr_idx.shape)}")
    d = nbr_idx.shape[1]
    check_tensor(nbr_idx, "nbr_idx", (torch.int32,), (n, d), dout.device)
    check_tensor(nbr_mask, "nbr_mask", (torch.float32,), (n, d), dout.device)
    check_tensor(nbr_etype, "nbr_etype", (torch.int32,), (n, d), dout.device)
    check_rev(rev_ptr, rev_slot, n, dout.device)
    dh = torch.empty((n, hdim), dtype=dout.dtype, device=dout.device)
    if n == 0 or hdim == 0 or d == 0:
        return dh.zero_()
    wslot = torch.empty((n, d), dtype=torch.float32, device=dout.device)
    lib = load_library().lib
    with torch.cuda.device(dout.device):
        rc = lib.csr_spmm_etype_mean_bwd_f32(
            dout.data_ptr(), nbr_idx.data_ptr(), nbr_mask.data_ptr(), nbr_etype.data_ptr(),
            rev_ptr.data_ptr(), rev_slot.data_ptr(), wslot.data_ptr(), dh.data_ptr(),
            n, d, hdim, num_types, stream_ptr(dout))
    check_launch(rc, "csr_spmm_bwd")
    return dh


class CsrSpmm(torch.autograd.Function):
    """:func:`csr_spmm_cuda` with its gradient with respect to ``h`` from
    :func:`csr_spmm_bwd_cuda`; the weights get none."""

    @staticmethod
    def forward(ctx, h, nbr_idx, weights, rev_ptr, rev_slot):
        ctx.save_for_backward(weights, rev_ptr, rev_slot)
        return csr_spmm_cuda(h, nbr_idx, weights)

    @staticmethod
    def backward(ctx, dout):
        weights, rev_ptr, rev_slot = ctx.saved_tensors
        return csr_spmm_bwd_cuda(dout.contiguous(), weights, rev_ptr, rev_slot), None, None, \
            None, None


class CsrSpmmEtypeMean(torch.autograd.Function):
    """:func:`csr_spmm_etype_mean_cuda` with its gradient with respect to
    ``h`` from :func:`csr_spmm_etype_mean_bwd_cuda`."""

    @staticmethod
    def forward(ctx, h, nbr_idx, nbr_mask, nbr_etype, num_types, rev_ptr, rev_slot):
        ctx.save_for_backward(nbr_idx, nbr_mask, nbr_etype, rev_ptr, rev_slot)
        return csr_spmm_etype_mean_cuda(h, nbr_idx, nbr_mask, nbr_etype, num_types)

    @staticmethod
    def backward(ctx, dout):
        dh = csr_spmm_etype_mean_bwd_cuda(dout.contiguous(), *ctx.saved_tensors)
        return dh, None, None, None, None, None, None


def csr_spmm_autograd(h, nbr_idx, weights, rev):
    """:class:`CsrSpmm` on the graph's reverse-slot index ``rev``; raises
    where the backward kernel cannot give the gradient autograd wants."""
    check_differentiable("csr_spmm", h, rev, weights=weights)
    return CsrSpmm.apply(h, nbr_idx, weights, *rev)


def csr_spmm_etype_mean_autograd(h, nbr_idx, nbr_mask, nbr_etype, num_types, rev):
    """:class:`CsrSpmmEtypeMean` on the graph's reverse-slot index ``rev``;
    raises as :func:`csr_spmm_autograd` does."""
    check_differentiable("csr_spmm", h, rev, nbr_mask=nbr_mask)
    return CsrSpmmEtypeMean.apply(h, nbr_idx, nbr_mask, nbr_etype, num_types, *rev)
