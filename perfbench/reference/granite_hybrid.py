"""The plain f32 reference of granite-4.0-h-small (``granitemoehybrid``).

Written from the published model's equations (its ``config.json``, the
Granite 4.0-H model card, Mamba2's SSD [arXiv:2405.21060]), independent
of the program: plain PyTorch, no kernel, no cache, no batching beyond
the sequences it is handed.  It reads the parameter tree by key path (the
layout the benchmark's weights are made in, ``groups/granite_hybrid/...``)
and the configuration's JSON file, and computes one layer at a time,
casting only that layer's weights (an expert's, in the MoE) to f32.

    h = 12 · embed[tokens]
    for each layer i, its mixer as ``layer_pattern`` (M Mamba2, A attention)
    orders them:
        h += 0.22 · mixer_i(rms(h)·(1+ln1_i))
        x = rms(h)·(1+ln2_i);   h += 0.22 · (moe_i(x) + shared_i(x))
    logits = (rms(h)·(1+final_ln)) @ embedᵀ / 16

* Mamba2: ``[z | xBC | dt] = x @ w_in``; ``xBC`` through the depthwise
  causal conv (a sum of K shifted products, tap K-1 the current step,
  plus ``conv_b``) and SiLU, split into x [H, P], B and C [N] (one group);
  ``dt = softplus(dt + dt_bias)``, ``A = -exp(a_log)``; the SSD
  ``S_t = exp(dt_t A) S_{t-1} + dt_t B_t ⊗ x_t``, ``y_t = S_tᵀ C_t + D x_t``;
  ``y = rms(y · silu(z))·(1+norm_scale) @ w_out``.
* attention: GQA (Hq / Hkv), no positional embedding, causal, the softmax
  at ``attention_multiplier`` (1/128).
* MoE: the router's logits ``x @ router``, their top k, the softmax over
  those k; each expert's SwiGLU ``(silu(x W_g) · x W_u) W_d`` over its own
  tokens, no capacity; the shared expert the same SwiGLU at its width.
* ``rms`` is x/sqrt(mean(x²) + rms_norm_eps), eps 1e-5.

Departures from the published model, none of which changes the function:

* every norm's scale is held as ``1 + scale`` (the program's layout), where
  the published checkpoint holds the product;
* the SSD is evaluated in its exact chunked closed form (the paper's
  ``ssd_minimal_discrete``) in chunks of 256, the published
  ``mamba_chunk_size``; a sequence is padded to whole chunks with steps
  that change nothing (dt = 0, x = B = C = 0);
* the router's weights are read in f32, as the program holds them.

``Precision`` and ``no_tf32`` are ``reference/model.py``'s: f32 with TF32
off, or the fp8 control.  ``Keep`` collects what a prefill caches, at
chosen places.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.model import Precision, no_tf32  # noqa: F401  (re-exported)

#: the SSD's chunk: the published ``mamba_chunk_size``
CHUNK = 256
#: attention heads, Mamba2 heads a pass of the SSD at a time (memory only)
HEAD_BLOCK = 32


class Keep:
    """What a prefill caches, at chosen places, in the order the layers
    run: each attention layer's keys and values [B, Hkv, P, Dh] at
    ``positions``, each Mamba2 layer's final SSM state [B, h, N, P] over
    ``heads``."""

    def __init__(self, positions, heads):
        self.positions, self.heads = positions, heads
        self.k, self.v, self.ssm = [], [], []


def rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale.float())


def causal_conv(x, w, bias):
    """x [B, S, W]; w [K, W], tap K-1 on the current step."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, j:j + s] * w[j] for j in range(k)) + bias


def segsum(x):
    """[..., T] -> [..., T, T]: entry (i, j) the sum of x over (j, i], -inf
    above the diagonal (the paper's stable segment sum)."""
    t = x.shape[-1]
    x = x[..., None].expand(*x.shape, t)
    strict = torch.ones(t, t, dtype=torch.bool, device=x.device).tril(-1)
    out = torch.cumsum(x.masked_fill(~strict, 0.0), dim=-2)
    return out.masked_fill(~torch.ones_like(strict).tril(), float("-inf"))


def ssd(x, a, b, c):
    """The SSD in chunks of ``CHUNK``: x [B, S, H, P] (already times dt),
    a [B, S, H] (dt · A), b and c [B, S, N].  Returns (y [B, S, H, P], the
    final state [B, H, N, P])."""
    bsz, s, h, p = x.shape
    pad = -s % CHUNK
    if pad:
        x, a = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(a, (0, 0, 0, pad))
        b, c = F.pad(b, (0, 0, 0, pad)), F.pad(c, (0, 0, 0, pad))
    n_c = (s + pad) // CHUNK
    x = x.reshape(bsz, n_c, CHUNK, h, -1)
    b, c = b.reshape(bsz, n_c, CHUNK, -1), c.reshape(bsz, n_c, CHUNK, -1)
    a = a.reshape(bsz, n_c, CHUNK, h).permute(0, 3, 1, 2)               # [B, H, C, L]
    a_cum = torch.cumsum(a, dim=-1)
    cb = torch.einsum("bcln,bcsn->bcls", c, b)
    # 1. within each chunk
    y_diag = torch.einsum("bhcls,bcshp->bclhp", cb[:, None] * torch.exp(segsum(a)), x)
    # 2. each chunk's own final state
    decay = torch.exp(a_cum[..., -1:] - a_cum)                          # [B, H, C, L]
    states = torch.einsum("bcln,bclhp->bchnp", b, x * decay.permute(0, 2, 3, 1)[..., None])
    # 3. the states carried across chunks, from a zero start
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    carry = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))            # [B, H, C+1, C+1]
    states = torch.einsum("bhzc,bchnp->bzhnp", carry, states)
    before, final = states[:, :-1], states[:, -1]
    # 4. each chunk's start state read out
    y_off = torch.einsum("bcln,bchnp->bclhp", c, before) * \
        torch.exp(a_cum).permute(0, 2, 3, 1)[..., None]
    y = (y_diag + y_off).reshape(bsz, n_c * CHUNK, h, p)[:, :s]
    return y, final


def mamba(p, c, x, prec, keep):
    bsz, s, _ = x.shape
    di, n, hp = c["ssm_expand"] * c["d_model"], c["ssm_state"], c["ssm_head_dim"]
    nh = di // hp
    z, xbc, dt = prec.mm(x, p["w_in"].float()).split([di, di + 2 * n, nh], dim=-1)
    xbc = prec.act(F.silu(causal_conv(xbc, p["conv_w"].float(), p["conv_b"].float())))
    xs, bm, cm = xbc.split([di, n, n], dim=-1)
    xs = xs.reshape(bsz, s, nh, hp)
    dt = F.softplus(dt + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    ys, finals = [], []
    for h0 in range(0, nh, HEAD_BLOCK):
        hs = slice(h0, h0 + HEAD_BLOCK)
        y, final = ssd(xs[:, :, hs] * dt[:, :, hs, None], dt[:, :, hs] * a[hs], bm, cm)
        ys.append(y)
        finals.append(final)
    y = prec.act(torch.cat(ys, dim=2) + xs * p["d_skip"][:, None])
    if keep is not None:
        keep.ssm.append(torch.cat(finals, dim=1)[:, keep.heads])
    gated = prec.act(y.reshape(bsz, s, di) * prec.act(F.silu(z)))
    return prec.mm(prec.act(rms(gated, p["norm_scale"], c["rms_norm_eps"])), p["w_out"].float())


def attention(p, c, x, prec, keep):
    bsz, s, _ = x.shape
    hq, hkv, dh = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    q = prec.mm(x, p["wq"].float()).view(bsz, s, hq, dh).transpose(1, 2)
    k = prec.mm(x, p["wk"].float()).view(bsz, s, hkv, dh).transpose(1, 2)
    v = prec.mm(x, p["wv"].float()).view(bsz, s, hkv, dh).transpose(1, 2)
    if keep is not None:
        keep.k.append(k[:, :, keep.positions])
        keep.v.append(v[:, :, keep.positions])
    rep = hq // hkv
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    out = torch.empty_like(q)
    for i in range(hq):     # a head at a time, so that S x S scores stay small
        sc = (q[:, i] @ k[:, i // rep].transpose(-1, -2)) * c["attention_multiplier"]
        sc = sc.masked_fill(~causal, float("-inf"))
        out[:, i] = torch.softmax(sc, dim=-1) @ v[:, i // rep]
    return prec.mm(out.transpose(1, 2).reshape(bsz, s, hq * dh), p["wo"].float())


def swiglu(x, w_gate, w_up, w_down, prec):
    g = prec.act(F.silu(prec.mm(x, w_gate.float())))
    return prec.mm(prec.act(g * prec.mm(x, w_up.float())), w_down.float())


def moe(p, c, x, prec):
    """x [T, d]: each token through its top-k experts, weighted by the
    softmax over their logits; no capacity, nothing dropped."""
    top, idx = torch.topk(x @ p["router"].float(), c["experts_per_token"], dim=-1)
    gates = torch.softmax(top, dim=-1)
    y = torch.zeros_like(x)
    for e in range(c["num_experts"]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel():
            ye = swiglu(x[rows], p["w_gate"][e], p["w_up"][e], p["w_down"][e], prec)
            y.index_add_(0, rows, ye * gates[rows, slot, None])
    return prec.act(y)


def _at(tree, i):
    if isinstance(tree, dict):
        return {k: _at(v, i) for k, v in tree.items()}
    return tree[i]


def hidden(params, c, tokens, prec, keep=None):
    """The last hidden state [B, S, d] (before the final norm) of ``tokens``."""
    g = params["groups"]["granite_hybrid"]
    eps, r = c["rms_norm_eps"], c["residual_multiplier"]
    h = prec.act(params["embed"][tokens].float() * c["embedding_multiplier"])
    seen = {"M": 0, "A": 0}
    for i, kind in enumerate(c["layer_pattern"]):
        mixer = _at(g["mamba" if kind == "M" else "attn"], seen[kind])
        seen[kind] += 1
        x = prec.act(rms(h, g["ln1"][i], eps))
        y = (mamba if kind == "M" else attention)(mixer, c, x, prec, keep)
        h = prec.act(h + r * y)
        x = prec.act(rms(h, g["ln2"][i], eps))
        b, s, d = x.shape
        f = moe(_at(g["moe"], i), c, x.reshape(b * s, d), prec).reshape(b, s, d)
        sh = _at(g["shared"], i)
        f = f + swiglu(x, sh["w_gate"], sh["w_up"], sh["w_down"], prec)
        h = prec.act(h + r * prec.act(f))
    return h


def logits(params, c, h, prec):
    x = prec.act(rms(h, params["final_ln"], c["rms_norm_eps"]))
    return prec.mm(x, params["embed"].float().T) / c["logits_scaling"]


def last_logits(params, c, tokens, prec, keep=None):
    """Logits [B, V] at the last position of ``tokens`` [B, S]; with
    ``keep`` also what a prefill caches at its places."""
    return logits(params, c, hidden(params, c, tokens, prec, keep)[:, -1], prec)


def all_logits(params, c, tokens, prec, start: int = 0):
    """Logits [B, S - start, V] at the positions of ``tokens`` [B, S] from
    ``start`` on."""
    return logits(params, c, hidden(params, c, tokens, prec)[:, start:], prec)
