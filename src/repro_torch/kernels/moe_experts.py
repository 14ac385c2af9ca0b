"""The MoE's expert products on the card, grouped over the experts.

The dropless MoE (``models.moe.moe_apply_dropless``) sorts its T·k
assignments by expert, so each expert's rows of the gathered tokens are one
contiguous segment, which ends at ``ends[e]`` (the inclusive prefix sum of
the experts' counts, int32, on the card).  Each of the three SwiGLU
products is then one grouped GEMM over the segments, ``torch._grouped_mm``
(PyTorch's CUTLASS grouped kernel for sm_90: bf16 operands, f32
accumulation, bf16 out), which reads the segment ends on the card, so the
host never waits for the counts: gate and up ``[rows, d] x [E, d, f]``,
then down ``[rows, f] x [E, f, d]``.  SiLU in f32 and cast back, as
``models.common.ffn_apply``.  A call is counted once under ``moe_experts``
in ``_build.LAUNCHES``.  The plain version is ``kernels.ref.moe_experts_ref``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels._build import check_tensor, count_launch


def moe_experts_cuda(xs: torch.Tensor, ends: torch.Tensor, w_gate: torch.Tensor,
                     w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """``xs`` [rows, d] bf16 (the assignments' tokens, sorted by expert),
    ``ends`` [E] int32 (each expert's segment end, the last = rows),
    ``w_gate``/``w_up`` [E, d, f] and ``w_down`` [E, f, d] bf16, contiguous
    on one CUDA device, d and f multiples of 8.  Returns [rows, d] bf16:
    each row through its expert's SwiGLU."""
    if xs.dim() != 2 or w_gate.dim() != 3:
        raise ValueError(f"xs must be [rows, d] and w_gate [E, d, f], got "
                         f"{tuple(xs.shape)} and {tuple(w_gate.shape)}")
    e, d, f = w_gate.shape
    check_tensor(xs, "xs", (torch.bfloat16,), (xs.shape[0], d))
    check_tensor(ends, "ends", (torch.int32,), (e,), xs.device)
    check_tensor(w_gate, "w_gate", (torch.bfloat16,), (e, d, f), xs.device)
    check_tensor(w_up, "w_up", (torch.bfloat16,), (e, d, f), xs.device)
    check_tensor(w_down, "w_down", (torch.bfloat16,), (e, f, d), xs.device)
    if d % 8 or f % 8:
        raise ValueError(f"the grouped products take d and f multiples of 8, got {d}, {f}")
    g = torch._grouped_mm(xs, w_gate, offs=ends)
    u = torch._grouped_mm(xs, w_up, offs=ends)
    h = F.silu(g.float()).to(xs.dtype) * u
    y = torch._grouped_mm(h, w_down, offs=ends)
    count_launch("moe_experts")
    return y
