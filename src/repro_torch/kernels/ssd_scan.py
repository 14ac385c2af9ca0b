"""Mamba2 SSD scan on the card (the prefill hot loop of every Mamba2 block).

Wrapper of the CUDA kernel ``csrc/ssd_scan.cu``, the port of the TPU kernel
``repro.kernels.ssd_scan.ssd_scan_pallas``.  Its plain versions are
``kernels.ref.ssd_chunked_ref`` and ``ssd_scan_ref``; ``kernels.ops.ssd_scan``
picks between kernel and plain version by the tensor's device.

Training: :class:`SsdScan` is the ``torch.autograd.Function`` that
``kernels.ops`` takes when a gradient is wanted.  Its forward is the
no-grad path's and saves only its inputs; its backward recomputes the
state before each chunk and carries the state's gradient in reverse, in
closed form (``kernels.ref.ssd_scan_bwd_ref``): on the card the backward
kernel of the same source (:func:`ssd_scan_bwd_cuda`, one launch a
call, counted under ``ssd_scan_bwd``), on the CPU the plain version.  The
reference has no backward kernel: it differentiates its XLA path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import (check_aligned, check_launch, check_tensor, load_library,
                                       stream_ptr)

_DTYPES = (torch.float32, torch.bfloat16)
_BF16_N = (64, 128)   # the state widths the bf16 kernel is built for
CHUNK = 64            # the kernels' chunk
SMEM_OPTIN = 232448   # shared memory a block can use on the H100


def _check_inputs(x, dt, a, b, c, d_skip):
    """(B, S, H, P, N) of the scan's inputs, or raise."""
    check_tensor(x, "x", _DTYPES)
    if x.dim() != 4:
        raise ValueError(f"x must be [B, S, H, P], got shape {tuple(x.shape)}")
    bsz, s, h, p = x.shape
    if b.dim() != 3 or tuple(b.shape[:2]) != (bsz, s):
        raise ValueError(f"b must be [{bsz}, {s}, N], got {tuple(b.shape)}")
    n = b.shape[2]
    check_tensor(b, "b", (x.dtype,), (bsz, s, n), x.device)
    check_tensor(c, "c", (x.dtype,), (bsz, s, n), x.device)
    check_tensor(dt, "dt", (torch.float32,), (bsz, s, h), x.device)
    check_tensor(a, "a", (torch.float32,), (h,), x.device)
    if d_skip is not None:
        check_tensor(d_skip, "d_skip", (torch.float32,), (h,), x.device)
    return bsz, s, h, p, n


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor,
                  d_skip: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel.  ``x`` [B, S, H, P], ``b``/``c`` [B, S, N], all
    float32 or all bfloat16; ``dt`` [B, S, H], ``a`` [H] and ``d_skip`` [H]
    float32; all contiguous on one CUDA device.  Any S (the last chunk is
    padded with exact no-op rows).  float32 takes any N and P; bfloat16 (the
    tensor-core kernel) takes N in (64, 128) and P a multiple of 8, with x,
    b and c on 16-byte boundaries.  Returns y [B, S, H, P] in x's dtype,
    with ``d_skip * x`` added when ``d_skip`` is given."""
    bsz, s, h, p, n = _check_inputs(x, dt, a, b, c, d_skip)
    if x.dtype == torch.bfloat16:
        if n not in _BF16_N or p % 8:
            raise ValueError(f"the bf16 ssd_scan kernel takes N in {_BF16_N} and P a "
                             f"multiple of 8, got N={n}, P={p}")
        check_aligned("ssd_scan", x, b, c)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    lib = load_library().lib
    fn = lib.ssd_scan_f32 if x.dtype == torch.float32 else lib.ssd_scan_bf16
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                None if d_skip is None else d_skip.data_ptr(), y.data_ptr(),
                bsz, s, h, p, n, stream_ptr(x))
    check_launch(rc, "ssd_scan")
    return y


def bwd_smem_bytes(n: int, p: int) -> int:
    """Shared memory of one f32 backward block, as its launcher asks: x, dy
    (rows of P + 1), b, c (rows of N + 1), the state and its gradient (N
    rows of P + 1), three chunk-square matrices (rows of 65) and eight
    vectors of the chunk, f32."""
    q = CHUNK
    return 4 * (2 * q * (p + 1) + 2 * q * (n + 1) + 2 * n * (p + 1) + 3 * q * (q + 1) + 8 * q)


def bwd_mma_smem_bytes(n: int, p: int) -> int:
    """Shared memory the bf16 backward asks for, the larger of its two
    blocks' (``csrc/ssd_scan.cu``: ``StLayout``, ``CgSmem``): the states
    block's two stages of b or c (rows of N + 8), x or dy (rows of 72, bf16)
    and three f32 vectors; the chunk block's x, dy (rows of P rounded up to
    16, + 8), b, c (rows of N + 8), H, R (N rows as x's) and two chunk-square
    factors (rows of 72), bf16, and 14 f32 vectors of the chunk."""
    q = CHUNK
    states = 2 * (2 * q * (n + 8) + 2 * q * 72 + 4 * 3 * q)
    ldp = -(-p // 16) * 16 + 8
    chunk = 2 * (2 * q * ldp + 2 * q * (n + 8) + 2 * n * ldp + 2 * q * (q + 8)) + 4 * 14 * q
    return max(states, chunk)


def ssd_scan_bwd_cuda(x, dt, a, b, c, d_skip, dy):
    """Launch the backward kernel: (dx, ddt, da, db, dc, dd) of the scan in
    the dtypes of its inputs (dd None without ``d_skip``), from its inputs
    (as :func:`ssd_scan_cuda` takes them) and the output's gradient ``dy``
    [B, S, H, P] in x's dtype.  One C call; no atomics, so two calls give
    the same bits.  float32 (any N and P whose block fits shared memory,
    :func:`bwd_smem_bytes`): a block per (head, sequence) recomputes the
    state before each chunk of 64 (into scratch), then walks the chunks in
    reverse on the CUDA cores.  bfloat16 (N in (64, 128), P a multiple of 8
    within :func:`bwd_mma_smem_bytes`, x, b, c and dy on 16-byte
    boundaries): the state before each chunk and the state's gradient after
    it (into scratch), then a block per (chunk, head, sequence) on the
    tensor cores, whose roundings ``ref.ssd_scan_bwd_mma_ref`` models.  db
    and dc (shared by the heads) and da and dd (shared by the sequences)
    are written per head or per sequence (bf16: per (sequence, chunk)) and
    summed by a last kernel in a fixed order."""
    bsz, s, h, p, n = _check_inputs(x, dt, a, b, c, d_skip)
    check_tensor(dy, "dy", (x.dtype,), x.shape, x.device)
    mma = x.dtype == torch.bfloat16
    if mma:
        if n not in _BF16_N or p % 8:
            raise ValueError(f"the bf16 ssd_scan backward kernel takes N in {_BF16_N} and P a "
                             f"multiple of 8, got N={n}, P={p}")
        check_aligned("ssd_scan_bwd", x, b, c, dy)
    smem = (bwd_mma_smem_bytes if mma else bwd_smem_bytes)(n, p)
    if smem > SMEM_OPTIN:
        raise ValueError(f"the ssd_scan backward kernel holds N={n}, P={p} in {smem} bytes "
                         f"of shared memory, more than {SMEM_OPTIN}")
    dx, ddt, db, dc = (torch.empty_like(t) for t in (x, dt, b, c))
    da = torch.empty_like(a)
    dd = None if d_skip is None else torch.empty_like(d_skip)
    if x.numel() == 0 or b.numel() == 0:
        for t in (dx, ddt, da, db, dc) + (() if dd is None else (dd,)):
            t.zero_()
        return dx, ddt, da, db, dc, dd
    nc = -(-s // CHUNK)
    f32 = dict(dtype=torch.float32, device=x.device)
    # the state before each chunk (bf16: and the state's gradient after it)
    states = torch.empty((2,) * mma + (bsz, h, nc, n, p), **f32)
    db_part, dc_part = torch.empty((bsz, h, s, n), **f32), torch.empty((bsz, h, s, n), **f32)
    # da and dd per sequence (bf16: per sequence and chunk) and head
    sums = torch.empty((2, bsz) + (nc,) * mma + (h,), **f32)
    lib = load_library().lib
    fn = lib.ssd_scan_bwd_f32 if x.dtype == torch.float32 else lib.ssd_scan_bwd_bf16
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                None if d_skip is None else d_skip.data_ptr(), dy.data_ptr(),
                dx.data_ptr(), ddt.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
                None if dd is None else dd.data_ptr(), states.data_ptr(),
                db_part.data_ptr(), dc_part.data_ptr(), sums.data_ptr(),
                bsz, s, h, p, n, stream_ptr(x))
    check_launch(rc, "ssd_scan_bwd")
    return dx, ddt, da, db, dc, dd


def ssd_scan_plain(x, dt, a, b, c, d_skip=None, chunk: int = 64,
                   compute_dtype=torch.float32):
    """The plain version, the reference's XLA path (``models/mamba.py`` with
    ``use_pallas=False``): the chunked form at ``chunk`` where it divides S
    (a whole sequence shorter than 64 is one chunk), else the sequential
    recurrence; ``compute_dtype`` is the chunked form's intra-chunk dtype."""
    s = x.shape[1]
    if s % chunk:
        chunk = s if s < 64 else 1
    if chunk > 1:
        return ref.ssd_chunked_ref(x, dt, a, b, c, d_skip, chunk=chunk,
                                   compute_dtype=compute_dtype)
    return ref.ssd_scan_ref(x, dt, a, b, c, d_skip)


class SsdScan(torch.autograd.Function):
    """The SSD scan with a backward: :func:`ssd_scan_cuda` and
    :func:`ssd_scan_bwd_cuda` (``cuda``), or :func:`ssd_scan_plain` and
    ``ref.ssd_scan_bwd_ref`` at the forward's chunk (64, padded, where the
    forward took the sequential recurrence).  The forward's output is the
    no-grad path's, bit for bit."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, d_skip, chunk, compute_dtype, cuda):
        if cuda:
            y = ssd_scan_cuda(x, dt, a, b, c, d_skip)
        else:
            y = ssd_scan_plain(x, dt, a, b, c, d_skip, chunk, compute_dtype)
        ctx.save_for_backward(x, dt, a, b, c, d_skip)
        ctx.cuda = cuda
        ctx.chunk = chunk if x.shape[1] % chunk == 0 else CHUNK
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, a, b, c, d_skip = ctx.saved_tensors
        if ctx.cuda:
            grads = ssd_scan_bwd_cuda(x, dt, a, b, c, d_skip, dy.contiguous())
        else:
            grads = ref.ssd_scan_bwd_ref(x, dt, a, b, c, d_skip, dy, chunk=ctx.chunk)
        return (*grads, None, None, None)
