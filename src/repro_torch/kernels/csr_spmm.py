"""Weighted neighbour gather-sum on the card (the GCN/SAGE hot loop).

    out[i, :] = sum_d weights[i, d] * h[nbr_idx[i, d], :]

Wrapper of the CUDA kernel ``csrc/csr_spmm.cu``, the port of the TPU kernel
``repro.kernels.csr_spmm.csr_spmm_pallas``.  Its plain version is
``kernels.ref.csr_spmm_ref``; ``kernels.ops.csr_spmm`` picks between them by
the tensor's device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import check_launch, check_tensor, load_library, stream_ptr


def csr_spmm_cuda(h: torch.Tensor, nbr_idx: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """Launch the kernel.  ``h`` [N, H] float32 or bfloat16, ``nbr_idx``
    [N, D] int32, ``weights`` [N, D] float32, all contiguous on one CUDA
    device.  Returns [N, H] in ``h``'s dtype, accumulated in float32."""
    check_tensor(h, "h", (torch.float32, torch.bfloat16))
    if h.dim() != 2:
        raise ValueError(f"h must be [N, H], got shape {tuple(h.shape)}")
    n, hdim = h.shape
    if nbr_idx.dim() != 2 or nbr_idx.shape[0] != n:
        raise ValueError(f"nbr_idx must be [{n}, D], got {tuple(nbr_idx.shape)}")
    d = nbr_idx.shape[1]
    check_tensor(nbr_idx, "nbr_idx", (torch.int32,), (n, d), h.device)
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
