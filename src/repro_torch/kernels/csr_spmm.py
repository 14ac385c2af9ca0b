"""Weighted neighbour gather-sum on the card (the GCN/SAGE hot loop).

    out[i, :] = sum_d weights[i, d] * h[nbr_idx[i, d], :]

and its per-edge-type mean, GCN's aggregation, in one launch:

    out[e, i, :] = sum_d (mask * [etype == e])[i, d] / cnt[i, e] * h[nbr_idx[i, d], :]

Wrappers of the CUDA kernels of ``csrc/csr_spmm.cu``, the port of the TPU
kernel ``repro.kernels.csr_spmm.csr_spmm_pallas``.  Their plain versions
are ``kernels.ref.csr_spmm_ref`` and ``kernels.ref.csr_spmm_etype_mean_ref``;
``kernels.ops`` picks between kernel and plain version by the tensor's
device.  Both count their launches under ``csr_spmm``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import check_launch, check_tensor, load_library, stream_ptr

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
