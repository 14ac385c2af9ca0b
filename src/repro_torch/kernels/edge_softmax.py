"""GAT edge softmax + weighted aggregation on the card.

    logits[i,d] = leaky_relu(s_src[nbr_idx[i,d]] + s_dst[i] + etype_bias[i,d])
    attn        = softmax over valid d  (masked by nbr_mask)
    out[i, :]   = sum_d attn[i,d] * z[nbr_idx[i,d], :]

Wrapper of the CUDA kernel ``csrc/edge_softmax.cu``, the port of the TPU
kernel ``repro.kernels.edge_softmax.edge_softmax_agg_pallas``.  Its plain
version is ``kernels.ref.edge_softmax_agg_ref``.

Training: the gradients with respect to ``z``, ``s_src``, ``s_dst`` and
``etype_bias`` come from the backward kernels of the same source (two a
call, counted once under ``edge_softmax_bwd``; plain version
``kernels.ref.edge_softmax_agg_bwd_ref``); :class:`EdgeSoftmaxAgg` is the
``torch.autograd.Function`` that ``kernels.ops`` takes on the card when a
gradient is wanted.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import (check_differentiable, check_launch, check_rev,
                                        check_tensor, load_library, stream_ptr)


def _check_inputs(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias):
    """(N, H, D) of the forward's inputs, or raise."""
    f32 = (torch.float32,)
    check_tensor(z, "z", f32)
    if z.dim() != 2:
        raise ValueError(f"z must be [N, H], got shape {tuple(z.shape)}")
    n, hdim = z.shape
    if nbr_idx.dim() != 2 or nbr_idx.shape[0] != n:
        raise ValueError(f"nbr_idx must be [{n}, D], got {tuple(nbr_idx.shape)}")
    d = nbr_idx.shape[1]
    check_tensor(s_src, "s_src", f32, (n,), z.device)
    check_tensor(s_dst, "s_dst", f32, (n,), z.device)
    check_tensor(nbr_idx, "nbr_idx", (torch.int32,), (n, d), z.device)
    check_tensor(nbr_mask, "nbr_mask", f32, (n, d), z.device)
    check_tensor(etype_bias, "etype_bias", f32, (n, d), z.device)
    return n, hdim, d


def edge_softmax_agg_cuda(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias):
    """Launch the kernel.  ``z`` [N, H], ``s_src``/``s_dst`` [N],
    ``nbr_mask``/``etype_bias`` [N, D] float32 and ``nbr_idx`` [N, D] int32,
    all contiguous on one CUDA device.  Returns [N, H] float32."""
    n, hdim, d = _check_inputs(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias)
    out = torch.empty_like(z)
    if n == 0 or hdim == 0:
        return out
    lib = load_library().lib
    with torch.cuda.device(z.device):
        rc = lib.edge_softmax_agg_f32(
            z.data_ptr(), s_src.data_ptr(), s_dst.data_ptr(), nbr_idx.data_ptr(),
            nbr_mask.data_ptr(), etype_bias.data_ptr(), out.data_ptr(),
            n, d, hdim, stream_ptr(z))
    check_launch(rc, "edge_softmax")
    return out


def edge_softmax_agg_bwd_cuda(dout, z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias,
                              rev_ptr, rev_slot):
    """Launch the backward kernels: ``(dz [N, H], ds_src [N], ds_dst [N],
    d_etype_bias [N, D])``, all float32, for ``dout`` [N, H] float32, the
    forward's inputs as :func:`edge_softmax_agg_cuda` takes them and the
    graph's reverse-slot index (``nbr_mask`` zero outside its slots)."""
    n, hdim, d = _check_inputs(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias)
    check_tensor(dout, "dout", (torch.float32,), (n, hdim), z.device)
    check_rev(rev_ptr, rev_slot, n, z.device)
    dz, ds_src, ds_dst = torch.empty_like(z), torch.empty_like(s_src), torch.empty_like(s_dst)
    dbias = torch.empty_like(etype_bias)
    if n == 0 or hdim == 0 or d == 0:
        return dz.zero_(), ds_src.zero_(), ds_dst.zero_(), dbias.zero_()
    alpha = torch.empty_like(etype_bias)     # scratch: each slot's p * mask
    lib = load_library().lib
    with torch.cuda.device(z.device):
        rc = lib.edge_softmax_agg_bwd_f32(
            dout.data_ptr(), z.data_ptr(), s_src.data_ptr(), s_dst.data_ptr(),
            nbr_idx.data_ptr(), nbr_mask.data_ptr(), etype_bias.data_ptr(),
            rev_ptr.data_ptr(), rev_slot.data_ptr(), alpha.data_ptr(), dz.data_ptr(),
            ds_src.data_ptr(), ds_dst.data_ptr(), dbias.data_ptr(), n, d, hdim,
            stream_ptr(z))
    check_launch(rc, "edge_softmax_bwd")
    return dz, ds_src, ds_dst, dbias


class EdgeSoftmaxAgg(torch.autograd.Function):
    """:func:`edge_softmax_agg_cuda` with its gradients with respect to
    ``z``, ``s_src``, ``s_dst`` and ``etype_bias`` from
    :func:`edge_softmax_agg_bwd_cuda`; the mask gets none."""

    @staticmethod
    def forward(ctx, z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias, rev_ptr, rev_slot):
        ctx.save_for_backward(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias, rev_ptr,
                              rev_slot)
        return edge_softmax_agg_cuda(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias)

    @staticmethod
    def backward(ctx, dout):
        dz, ds_src, ds_dst, dbias = edge_softmax_agg_bwd_cuda(dout.contiguous(),
                                                              *ctx.saved_tensors)
        return dz, ds_src, ds_dst, None, None, dbias, None, None


def edge_softmax_agg_autograd(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias, rev):
    """:class:`EdgeSoftmaxAgg` on the graph's reverse-slot index ``rev``;
    raises where the backward kernels cannot give the gradient autograd
    wants (a mask that requires grad, no index, a type other than f32)."""
    check_differentiable("edge_softmax", z, rev, nbr_mask=nbr_mask)
    return EdgeSoftmaxAgg.apply(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias, *rev)
