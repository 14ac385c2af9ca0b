"""Rotary position embedding on the card: one kernel launch a rotated tensor.

Wrapper of the CUDA kernel ``csrc/rope.cu``, which replaces no TPU kernel
(the reference leaves RoPE to XLA, which fuses it).  Its plain version,
``kernels.ref.rope_ref``, is an eager chain of ~17 kernels a call;
``kernels.ops.rope`` picks between them by the tensor's device.

Training: :class:`Rope` is the ``torch.autograd.Function`` that
``kernels.ops`` takes when a gradient is wanted.  The rotation is
orthogonal, so its backward is the same rotation by the negated angles: on
the card the same kernel (counted under ``rope_bwd``), writing the gradient
in the layout the input came in, on the CPU ``ref.rope_ref(...,
inverse=True)``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import check_launch, check_tensor, load_library, stream_ptr

_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256


@functools.cache
def freq_table(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """``ref.rope_freqs``, built once per ``(Dh, theta, device)``."""
    return ref.rope_freqs(head_dim, theta, device)


def rope_cuda(x: torch.Tensor, pos0: int, theta: float, inverse: bool = False,
              out_stride: tuple | None = None) -> torch.Tensor:
    """Launch the kernel.  ``x`` [B, H, S, Dh] float32 or bfloat16 on a CUDA
    device, Dh even and at most 256, any strides with Dh's 1 (the
    projection's transposed view is read as it is); positions ``pos0`` ..
    ``pos0 + S - 1``.  Returns the rotated tensor in x's dtype, contiguous,
    or laid out by ``out_stride`` (the backward writes the gradient in the
    layout its input came in).  ``inverse`` rotates by the negated angles."""
    check_tensor(x, "x", _DTYPES, contiguous=False)
    if x.dim() != 4:
        raise ValueError(f"x must be [B, H, S, Dh], got shape {tuple(x.shape)}")
    bsz, heads, seq, dh = x.shape
    if dh % 2 or not 2 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} not supported; the kernel takes an even Dh "
                         f"up to {MAX_HEAD_DIM}")
    if x.stride(-1) != 1:
        x = x.contiguous()
    if out_stride is None or out_stride[-1] != 1:
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    else:
        out = torch.empty_strided(x.shape, out_stride, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    table = freq_table(dh, float(theta), x.device)
    # a dimension of size 1 is never stepped over: its stride does not matter
    ins, outs = ([0 if n == 1 else st for n, st in zip(x.shape[:3], t.stride()[:3])]
                 for t in (x, out))
    lib = load_library().lib
    fn = lib.rope_f32 if x.dtype == torch.float32 else lib.rope_bf16
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), table.data_ptr(), out.data_ptr(), bsz, heads, seq, dh, *ins,
                *outs, int(pos0), int(inverse), stream_ptr(x))
    check_launch(rc, "rope_bwd" if inverse else "rope")
    return out


class Rope(torch.autograd.Function):
    """RoPE with a backward: the kernel (``cuda``) or the plain version
    forward, the rotation by the negated angles backward.  The forward's
    output is the no-grad path's, bit for bit."""

    @staticmethod
    def forward(ctx, x, pos0, theta, cuda):
        ctx.mode = (pos0, theta, cuda)
        # x's layout for the gradient (dense layouts keep their strides), not its values
        ctx.layout = torch.empty_like(x, device="meta").stride()
        return rope_cuda(x, pos0, theta) if cuda else ref.rope_ref(x, pos0, theta)

    @staticmethod
    def backward(ctx, dy):
        pos0, theta, cuda = ctx.mode
        if cuda:
            return rope_cuda(dy, pos0, theta, inverse=True, out_stride=ctx.layout), \
                None, None, None
        return ref.rope_ref(dy, pos0, theta, inverse=True), None, None, None
