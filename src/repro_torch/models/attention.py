"""GQA attention with RoPE: prefill path + cached decode path.

The reference's ``repro.models.attention`` with tensors.  Prefill attention
goes through ``kernels.ops.flash_attention``, the decode step's online
softmax over the cache through ``kernels.ops.gqa_decode`` and RoPE through
``kernels.ops.rope`` (the CUDA kernels for CUDA tensors, the reference's
XLA paths on the CPU).

Physical head padding (``cfg.physical_heads``/``physical_kv_heads``) is kept
as the reference has it: padded q heads are computed heads whose ``w_o``
rows are zero; padded kv heads are tied replicas of logical kv heads (or
zero heads when the padding is ragged).

A NoPE layer (granite-4.0-h-small's) passes ``use_rope=False`` in prefill
and decode, and a softmax scale other than ``Dh ** -0.5`` goes to the
kernels as ``scale`` (q is not rescaled, so it is rounded once).

Cross attention (``kv_x`` in prefill, ``cross=True`` in decode) takes K and
V from another sequence (vision tokens, encoder frames): no mask, no
window, RoPE on q only; in decode the cache holds that sequence's K/V,
every slot valid, and is never written.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, torch_dtype


def attn_init(gen: torch.Generator, cfg, cross: bool = False, device=None):
    """The projections of one attention layer.  ``cross`` is the
    reference's flag: a cross layer initialises as a self layer does."""
    dtype = torch_dtype(cfg.dtype)
    hq, hkv, dh, d = cfg.physical_heads, cfg.physical_kv_heads, cfg.head_dim, cfg.d_model
    wq = dense_init(gen, (d, cfg.num_heads, dh), dtype, device=device)
    wk = dense_init(gen, (d, cfg.num_kv_heads, dh), dtype, device=device)
    wv = dense_init(gen, (d, cfg.num_kv_heads, dh), dtype, device=device)
    wo = dense_init(gen, (hq * dh, d), dtype, device=device)
    if hkv > cfg.num_kv_heads:
        if hkv % cfg.num_kv_heads == 0:
            # kv tying: tile logical heads to physical (TP replication)
            rep = hkv // cfg.num_kv_heads
            wk = wk.repeat_interleave(rep, dim=1)
            wv = wv.repeat_interleave(rep, dim=1)
        else:
            # ragged pad: zero kv heads whose q heads have zeroed w_o rows
            pad = wk.new_zeros((d, hkv - cfg.num_kv_heads, dh))
            wk = torch.cat([wk, pad], dim=1)
            wv = torch.cat([wv, pad], dim=1)
    if hq > cfg.num_heads:
        wq = torch.cat([wq, wq.new_zeros((d, hq - cfg.num_heads, dh))], dim=1)
        # zero the wo rows of padded heads so they contribute nothing
        wo = wo.reshape(hq, dh, d)
        wo[cfg.num_heads:] = 0.0
        wo = wo.reshape(hq * dh, d)
    p = {
        "wq": wq.reshape(d, hq * dh),
        "wk": wk.reshape(d, hkv * dh),
        "wv": wv.reshape(d, hkv * dh),
        "wo": wo,
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq * dh,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((hkv * dh,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((hkv * dh,), dtype=dtype, device=device)
    return p


def _project_qkv(params, cfg, x, kv_x=None):
    """q [B, Hq, S, Dh], k/v [B, Hkv, Sk, Dh] (views of the projections), K
    and V from ``kv_x`` [B, Sk, d] where given, else from ``x``.

    A ``kv_x`` of another dtype than the weights (the f32 vision embeddings
    of a bf16 model) is projected in the promoted dtype, as the reference's
    type promotion does, and K/V are then rounded once to ``x``'s dtype:
    the values the reference's decode cache holds."""
    hq, hkv, dh = cfg.physical_heads, cfg.physical_kv_heads, cfg.head_dim
    b, s, _ = x.shape
    src = x if kv_x is None else kv_x
    sk = src.shape[1]
    q = x @ params["wq"]
    if cfg.qkv_bias:
        q = q + params["bq"]
    ct = torch.promote_types(src.dtype, params["wk"].dtype)
    kv = []
    for w, bias in (("wk", "bk"), ("wv", "bv")):
        t = src.to(ct) @ params[w].to(ct)
        if cfg.qkv_bias:
            t = t + params[bias].to(ct)
        kv.append(t.to(x.dtype).reshape(b, sk, hkv, dh).transpose(1, 2))
    return q.reshape(b, s, hq, dh).transpose(1, 2), kv[0], kv[1]


def attn_apply(params, cfg, x, *, kv_x=None, causal=True, use_rope=True,
               scale: float | None = None):
    """Full-sequence attention (prefill).  x: [B, S, d].

    ``kv_x`` [B, Sk, d] switches to cross attention: K/V from ``kv_x``, RoPE
    (with ``use_rope``) on q only, no causal mask and no window; the
    kernel takes q rows against all Sk keys.  Returns (out [B, S, d], (k,
    v)) with k/v [B, Hkv, Sk, Dh] for the cache.

    The attention is ``kernels.ops.flash_attention`` with the config's
    window, in place of both of the reference's XLA paths (``"blockwise"``
    and the band-only ``"banded"``): the card's kernel visits only the key
    tiles inside the band, and the plain version masks the same band.
    ``scale``: the softmax's (default ``Dh ** -0.5``)."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(params, cfg, x, kv_x)
    if use_rope:
        q = ops.rope(q, 0, cfg.rope_theta)
        if kv_x is None:
            k = ops.rope(k, 0, cfg.rope_theta)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    self_attn = kv_x is None
    out = ops.flash_attention(q, k, v, causal=causal and self_attn,
                              window=cfg.window if self_attn else None, scale=scale)
    out = out.transpose(1, 2).reshape(b, s, -1)
    return out @ params["wo"], (k, v)


def attn_decode(params, cfg, x1, cache, pos: int, *, cross: bool = False,
                use_rope: bool = True, scale: float | None = None):
    """Single-token decode.  x1: [B, 1, d]; cache: dict(k, v) with
    k/v: [B, Hkv, S_max, Dh]; pos: the current position (a Python int, the
    same for every sequence of the batch).

    The new k/v row is written into the cache tensors IN PLACE (a slice
    assignment at ``pos``, or ``pos % S_max`` for a ring cache), where the
    reference returns an updated copy; the cache dict is returned for the
    same call shape.  The attention over the cache is
    ``kernels.ops.gqa_decode`` with ``kv_len = pos + 1`` for every sequence
    (the ring's fill level for a ring cache) and the config's window.

    ``cross=True``: the cache holds the static K/V of the encoder frames or
    vision tokens; q gets no RoPE, nothing is written, and the attention
    runs over every slot (``kv_len`` None, no window).  ``use_rope=False``
    (a NoPE layer): neither q nor the new key is rotated.  ``scale``: the
    softmax's (default ``Dh ** -0.5``).
    Returns (out [B, 1, d], cache).
    """
    hq, hkv, dh = cfg.physical_heads, cfg.physical_kv_heads, cfg.head_dim
    b = x1.shape[0]
    q = x1 @ params["wq"]
    if cfg.qkv_bias:
        q = q + params["bq"]
    q = q.reshape(b, 1, hq, dh).transpose(1, 2)
    if cross:
        out = ops.gqa_decode(q[:, :, 0].contiguous(), cache["k"], cache["v"], scale=scale)
        return out.reshape(b, 1, hq * dh) @ params["wo"], cache
    k1 = x1 @ params["wk"]
    v1 = x1 @ params["wv"]
    if cfg.qkv_bias:
        k1 = k1 + params["bk"]
        v1 = v1 + params["bv"]
    k1 = k1.reshape(b, 1, hkv, dh).transpose(1, 2)
    if use_rope:
        q = ops.rope(q, pos, cfg.rope_theta)
        k1 = ops.rope(k1, pos, cfg.rope_theta)
    v1 = v1.reshape(b, 1, hkv, dh).transpose(1, 2)
    k, v = cache["k"], cache["v"]
    cache_len = k.shape[2]
    ring = bool(cfg.ring_kv_cache and cfg.window and cache_len <= cfg.window)
    write_pos = pos % cache_len if ring else pos
    k[:, :, write_pos] = k1[:, :, 0].to(k.dtype)
    v[:, :, write_pos] = v1[:, :, 0].to(v.dtype)
    kv_len = torch.full((b,), min(pos + 1, cache_len) if ring else pos + 1,
                        dtype=torch.int32, device=x1.device)
    # a ring buffer holds exactly the last `window` positions, so every
    # valid slot attends (softmax is permutation-invariant, RoPE was applied
    # at absolute positions before the write)
    out = ops.gqa_decode(q[:, :, 0].contiguous(), k, v, kv_len=kv_len,
                         window=None if ring else cfg.window, scale=scale)
    return out.reshape(b, 1, hq * dh) @ params["wo"], cache
