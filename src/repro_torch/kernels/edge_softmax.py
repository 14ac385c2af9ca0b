"""GAT edge softmax + weighted aggregation on the card.

    logits[i,d] = leaky_relu(s_src[nbr_idx[i,d]] + s_dst[i] + etype_bias[i,d])
    attn        = softmax over valid d  (masked by nbr_mask)
    out[i, :]   = sum_d attn[i,d] * z[nbr_idx[i,d], :]

Wrapper of the CUDA kernel ``csrc/edge_softmax.cu``, the port of the TPU
kernel ``repro.kernels.edge_softmax.edge_softmax_agg_pallas``.  Its plain
version is ``kernels.ref.edge_softmax_agg_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import check_launch, check_tensor, load_library, stream_ptr


def edge_softmax_agg_cuda(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias):
    """Launch the kernel.  ``z`` [N, H], ``s_src``/``s_dst`` [N],
    ``nbr_mask``/``etype_bias`` [N, D] float32 and ``nbr_idx`` [N, D] int32,
    all contiguous on one CUDA device.  Returns [N, H] float32."""
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
