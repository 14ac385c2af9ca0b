"""Shared building blocks of the zoo: init, norms, RoPE, FFNs, and the plain
blockwise attention.

The reference's ``repro.models.common`` with tensors in place of jax
arrays.  Parameters are plain dicts of tensors in the reference's ``x @ W``
``[in, out]`` layout.  Every init function takes an explicit
``torch.Generator`` (draws are made on the generator's device, in float32)
and the ``device`` the tensor is moved to; shapes, dtypes and scales are the
reference's, the values are not (the reference draws from ``jax.random``).
On the meta device nothing is drawn (``dense_init``): an abstract tree.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import is_dtensor
from repro_torch.utils.padding import pad_to_multiple

NEG_INF = -1e30


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"bfloat16"``, ``"float32"``)."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, shape, dtype, scale=None, device=None):
    """Normal weights of ``shape`` scaled by ``fan_in ** -0.5`` (or ``scale``).

    On the meta device (an abstract tree: shapes and dtypes only) nothing is
    drawn: the result is ``torch.empty`` on meta and ``gen`` is not touched."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    if scale is None:
        scale = shape[0] ** -0.5
    w = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return (w * scale).to(dtype=dtype, device=device)


def wide(x):
    """``x`` in the type the plain path computes in: f32, or f64 for an f64
    tensor (an f64 evaluation of a model is the anchor that f32 rounding is
    measured against)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x, scale=None, eps=1e-6):
    x32 = wide(x)
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    if scale is not None:
        y = y * (1.0 + scale.to(x32.dtype))
    return y.to(x.dtype)


def layernorm_nonparametric(x, eps=1e-5):
    """OLMo's non-parametric LayerNorm: no learnable scale or bias, the
    statistics in f32 (the population variance, as ``jnp.var``)."""
    x32 = wide(x)
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    # theta filled on the device: a copy from the host would wait for it
    return torch.pow(torch.full((), theta, dtype=torch.float32, device=device), exps)


def apply_rope(x, positions, theta: float = 10_000.0):
    """x: [..., S, Dh]; positions: broadcastable to [..., S]."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)               # [Dh/2]
    angles = positions[..., None].float() * freqs                   # [..., S, Dh/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = wide(x).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def ffn_init(gen, d_model, d_ff, ffn_type, dtype, device=None):
    if ffn_type == "swiglu":
        return {
            "w_gate": dense_init(gen, (d_model, d_ff), dtype, device=device),
            "w_up": dense_init(gen, (d_model, d_ff), dtype, device=device),
            "w_down": dense_init(gen, (d_ff, d_model), dtype, device=device),
        }
    return {
        "w_up": dense_init(gen, (d_model, d_ff), dtype, device=device),
        "w_down": dense_init(gen, (d_ff, d_model), dtype, device=device),
    }


def ffn_apply(params, x, ffn_type):
    if ffn_type == "swiglu":
        g = F.silu(wide(x @ params["w_gate"])).to(x.dtype)
        return (g * (x @ params["w_up"])) @ params["w_down"]
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(wide(x @ params["w_up"]), approximate="tanh").to(x.dtype)
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# Blockwise (flash-style) attention with plain tensor ops: the plain version
# of the prefill attention kernel (``kernels.ops.flash_attention`` takes it
# for CPU tensors), the reference's XLA path op for op.
# ---------------------------------------------------------------------------

def blockwise_attention(q, k, v, *, causal=True, window=None, block_k=512,
                        q_offset=None, scale=None):
    """q: [B, Hq, Sq, Dh]; k/v: [B, Hkv, Sk, Dh].  GQA via head grouping
    (no K/V repetition is materialized).  Returns [B, Hq, Sq, Dh].

    Online softmax over key blocks of ``block_k``, logits and sums in f32,
    ``-1e30`` for masked logits and ``/ max(l, 1e-30)`` at the end, as the
    reference.  ``q_offset``: absolute position of q row 0 (default aligns
    q to the end of the kv sequence, the prefill/train convention).
    ``scale``: the logits' scale (default ``Dh ** -0.5``).
    """
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = dh ** -0.5 if scale is None else scale
    if q_offset is None:
        q_offset = sk - sq
    kv_valid = sk
    if sk % block_k:
        # ragged KV: zero-pad and mask the tail
        pad = pad_to_multiple(sk, block_k) - sk
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        sk += pad
    dev = q.device
    qg = wide(q.reshape(b, hkv, rep, sq, dh))
    acc_t = qg.dtype
    qpos = q_offset + torch.arange(sq, device=dev)

    m = torch.full((b, hkv, rep, sq), NEG_INF, dtype=acc_t, device=dev)
    denom = torch.zeros((b, hkv, rep, sq), dtype=acc_t, device=dev)
    acc = torch.zeros((b, hkv, rep, sq, dh), dtype=acc_t, device=dev)
    for j in range(sk // block_k):
        kj = wide(k[:, :, j * block_k:(j + 1) * block_k])
        vj = v[:, :, j * block_k:(j + 1) * block_k]
        logits = torch.einsum("bgrsd,bgkd->bgrsk", qg, kj) * scale
        kpos = j * block_k + torch.arange(block_k, device=dev)
        mask = (kpos[None, :] < kv_valid).expand(sq, block_k)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m - m_new)
        denom = denom * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bgrsk,bgkd->bgrsd", wide(p.to(vj.dtype)), wide(vj))
        m = m_new
    out = acc / denom.clamp_min(1e-30)[..., None]
    return out.reshape(b, hq, sq, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits, labels, mask=None):
    """logits: [..., V] (any float dtype); labels: [...] int.  The mean of
    logsumexp(logits) - logits[label] in f32, over the ``mask`` (a masked
    mean divided by max(mask sum, 1)) where given.

    The gold logit is a plain gather on one device.  On the dry-run's
    vocabulary-sharded logits (a ``DTensor``) it is the reference's
    iota-compare reduction, which keeps the vocabulary sharded (a partial
    sum and a small all-reduce) where a gather would all-gather the logits;
    the two give the same value."""
    logits = wide(logits)
    logz = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):
        iota = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.where(iota == labels.long()[..., None], logits, 0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
