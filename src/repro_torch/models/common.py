"""Shared building blocks of the zoo: init, norms, FFNs and the loss.  RoPE
and the plain blockwise attention are the kernels' plain versions
(``kernels.ref.rope_ref``, ``kernels.ref.blockwise_attention``).

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
