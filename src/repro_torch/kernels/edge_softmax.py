"""GAT edge softmax + weighted aggregation on the card.

    logits[i,d] = leaky_relu(s_src[nbr_idx[i,d]] + s_dst[i] + etype_bias[i,d])
    attn        = softmax over valid d  (masked by nbr_mask)
    out[i, :]   = sum_d attn[i,d] * z[nbr_idx[i,d], :]

Wrapper of the CUDA kernel ``csrc/edge_softmax.cu``, the port of the TPU
kernel ``repro.kernels.edge_softmax.edge_softmax_agg_pallas``.  Its plain
version is ``kernels.ref.edge_softmax_agg_ref``.

Training: :class:`EdgeSoftmaxAgg` is the ``torch.autograd.Function`` that
``kernels.ops`` takes when a gradient is wanted.  Its backward is the
closed form over the graph's reverse-slot index, summed in a fixed order:
on the card one launch of the backward kernel of the same source
(:func:`edge_softmax_agg_bwd_cuda`, counted under ``edge_softmax_bwd``),
which reads the forward's output and each row's softmax max and sum (the
forward kernel writes them under grad; plain mirror
``kernels.ref.edge_softmax_agg_bwd_saved_ref``); on the CPU
``kernels.ref.edge_softmax_agg_bwd_ref``, the same bits at any thread count.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
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


def edge_softmax_agg_cuda(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias,
                          save_stats: bool = False):
    """Launch the kernel.  ``z`` [N, H], ``s_src``/``s_dst`` [N],
    ``nbr_mask``/``etype_bias`` [N, D] float32 and ``nbr_idx`` [N, D] int32,
    all contiguous on one CUDA device.  Returns [N, H] float32; with
    ``save_stats``, ``(out, stats)``: the same launch also writes each row's
    softmax max and sum, [N, 2] float32, which the backward reads."""
    n, hdim, d = _check_inputs(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias)
    out = torch.empty_like(z)
    stats = torch.empty((n, 2), dtype=torch.float32, device=z.device) if save_stats else None
    if n == 0 or hdim == 0:      # the backward gives zeros here and reads no stats
        return (out, stats.zero_()) if save_stats else out
    lib = load_library().lib
    with torch.cuda.device(z.device):
        rc = lib.edge_softmax_agg_f32(
            z.data_ptr(), s_src.data_ptr(), s_dst.data_ptr(), nbr_idx.data_ptr(),
            nbr_mask.data_ptr(), etype_bias.data_ptr(), out.data_ptr(),
            stats.data_ptr() if save_stats else None, n, d, hdim, stream_ptr(z))
    check_launch(rc, "edge_softmax")
    return (out, stats) if save_stats else out


def edge_softmax_agg_bwd_cuda(dout, out, stats, z, s_src, s_dst, nbr_idx, nbr_mask,
                              etype_bias, rev_ptr, rev_slot):
    """Launch the backward kernel (one launch): ``(dz [N, H], ds_src [N],
    ds_dst [N], d_etype_bias [N, D])``, all float32, for ``dout`` [N, H]
    float32, the forward's output ``out`` [N, H] and row statistics
    ``stats`` [N, 2] (:func:`edge_softmax_agg_cuda` with ``save_stats``), its
    inputs as that function takes them and the graph's reverse-slot index
    (``nbr_mask`` zero outside its slots)."""
    n, hdim, d = _check_inputs(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias)
    check_tensor(dout, "dout", (torch.float32,), (n, hdim), z.device)
    check_tensor(out, "out", (torch.float32,), (n, hdim), z.device)
    check_tensor(stats, "stats", (torch.float32,), (n, 2), z.device)
    check_rev(rev_ptr, rev_slot, n, z.device)
    dz, ds_src, ds_dst = torch.empty_like(z), torch.empty_like(s_src), torch.empty_like(s_dst)
    dbias = torch.empty_like(etype_bias)
    if n == 0 or hdim == 0 or d == 0:
        return dz.zero_(), ds_src.zero_(), ds_dst.zero_(), dbias.zero_()
    lib = load_library().lib
    with torch.cuda.device(z.device):
        rc = lib.edge_softmax_agg_bwd_f32(
            dout.data_ptr(), out.data_ptr(), stats.data_ptr(), z.data_ptr(), s_src.data_ptr(),
            s_dst.data_ptr(), nbr_idx.data_ptr(), nbr_mask.data_ptr(), etype_bias.data_ptr(),
            rev_ptr.data_ptr(), rev_slot.data_ptr(), dz.data_ptr(), ds_src.data_ptr(),
            ds_dst.data_ptr(), dbias.data_ptr(), n, d, hdim, stream_ptr(z))
    check_launch(rc, "edge_softmax_bwd")
    return dz, ds_src, ds_dst, dbias


class EdgeSoftmaxAgg(torch.autograd.Function):
    """:func:`edge_softmax_agg_cuda` (``cuda``; saving the row statistics)
    or its plain version, with the gradients with respect to ``z``,
    ``s_src``, ``s_dst`` and ``etype_bias`` from
    :func:`edge_softmax_agg_bwd_cuda` or ``ref.edge_softmax_agg_bwd_ref``;
    the mask gets none."""

    @staticmethod
    def forward(ctx, z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias, rev_ptr, rev_slot, cuda):
        ctx.cuda = cuda
        ctx.dtypes = (z.dtype, s_src.dtype, s_dst.dtype, etype_bias.dtype)
        graph = (z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias, rev_ptr, rev_slot)
        if cuda:
            out, stats = edge_softmax_agg_cuda(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias,
                                               save_stats=True)
            ctx.save_for_backward(out, stats, *graph)
            return out
        ctx.save_for_backward(*graph)
        return ref.edge_softmax_agg_ref(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias)

    @staticmethod
    def backward(ctx, dout):
        if ctx.cuda:
            grads = edge_softmax_agg_bwd_cuda(dout.contiguous(), *ctx.saved_tensors)
        else:
            grads = ref.edge_softmax_agg_bwd_ref(dout, *ctx.saved_tensors)
        dz, ds_src, ds_dst, dbias = (g.to(t) for g, t in zip(grads, ctx.dtypes))
        return dz, ds_src, ds_dst, None, None, dbias, None, None, None


def edge_softmax_agg_autograd(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias, rev,
                              cuda: bool):
    """:class:`EdgeSoftmaxAgg` on the graph's reverse-slot index ``rev``.  On
    the card it raises where the backward kernel cannot give the gradient
    autograd wants (a mask that requires grad, no index, a type other than
    f32); on the CPU a missing ``rev`` is built from the mask."""
    if cuda:
        check_differentiable("edge_softmax", z, rev, nbr_mask=nbr_mask)
    elif rev is None:
        rev = ref.reverse_slots_ref(nbr_idx, nbr_mask)
    return EdgeSoftmaxAgg.apply(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias, *rev, cuda)
