"""The plain f32 reference of the configurations' language models.

Written from the models' equations, independent of the program: plain
PyTorch, no kernel, no cache, no batching beyond the sequences it is
handed.  It reads the parameter tree by key path (the layout the
benchmark's weights are made in) and the configuration's JSON file.

* dense (granite-3-2b): ``h = embed[tokens]``; per layer
  ``h += attn(rms(h)·(1+ln1))``, ``h += swiglu(rms(h)·(1+ln2))``; GQA
  attention with RoPE (rotate-half, theta ``rope_theta``), causal;
* logits ``rms(h)·(1+final_ln) @ head``.

``rms`` is x/sqrt(mean(x²) + 1e-6).  ``Precision`` is f32 with TF32 off
for the reference, or the control: the same computed in float8 e4m3
where the program holds bf16 (the precision below the configuration's).
``KV`` collects each layer's keys (after RoPE) and values at chosen
positions, as a decode cache holds them."""
from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-6
FP8_MAX = 448.0


class Precision:
    """f32 throughout (``fp8=False``: the reference), or the control
    (``fp8=True``): every tensor that the program holds in bf16 rounded to
    float8 e4m3 under a per-tensor scale instead — the operands and output
    of each matrix product, the embedding, the residual stream after each
    block, the norms', RoPE's and SiLU's outputs.  The rounding passes the
    gradient through unchanged (straight through), so the control also
    trains."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    @staticmethod
    def round_fp8(t):
        scale = (t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX)
        q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
        return t + (q - t.detach())

    def act(self, t):
        return self.round_fp8(t) if self.fp8 else t

    def mm(self, x, w):
        if self.fp8:
            return self.round_fp8(self.round_fp8(x) @ self.round_fp8(w))
        return x @ w


def rms(x, scale=None):
    y = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS)
    return y if scale is None else y * (1.0 + scale)


def rope(x, theta: float):
    """x [B, H, S, Dh] at positions 0..S-1, rotate-half."""
    s, dh = x.shape[-2], x.shape[-1]
    freqs = theta ** (-torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


class KV:
    """Each attention layer's k and v [B, Hkv, P, Dh] at ``positions``, in
    the order the layers run."""

    def __init__(self, positions):
        self.positions = positions
        self.k, self.v = [], []


def attention(p, c, x, prec, kv=None):
    b, s, _ = x.shape
    hq, hkv, dh = c["num_heads"], c["num_kv_heads"], c["head_dim"]
    q = prec.mm(x, p["wq"]).view(b, s, hq, dh).transpose(1, 2)
    k = prec.mm(x, p["wk"]).view(b, s, hkv, dh).transpose(1, 2)
    v = prec.mm(x, p["wv"]).view(b, s, hkv, dh).transpose(1, 2)
    q, k = prec.act(rope(q, c["rope_theta"])), prec.act(rope(k, c["rope_theta"]))
    if kv is not None:
        kv.k.append(k[:, :, kv.positions])
        kv.v.append(v[:, :, kv.positions])
    rep = hq // hkv
    k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    out = torch.empty_like(q)
    for i in range(hq):     # a head at a time, so that S x S scores stay small
        sc = (q[:, i] @ k[:, i].transpose(-1, -2)) * dh ** -0.5
        sc = sc.masked_fill(~causal, float("-inf"))
        out[:, i] = torch.softmax(sc, dim=-1) @ v[:, i]
    return prec.mm(out.transpose(1, 2).reshape(b, s, hq * dh), p["wo"])


def swiglu(p, x, prec):
    gate = prec.act(F.silu(prec.mm(x, p["w_gate"])))
    return prec.mm(prec.act(gate * prec.mm(x, p["w_up"])), p["w_down"])


def decoder_layer(p, c, h, prec, kv=None):
    h = prec.act(h + attention(p["attn"], c, prec.act(rms(h, p["ln1"])), prec, kv))
    return prec.act(h + swiglu(p["ffn"], prec.act(rms(h, p["ln2"])), prec))


def _at(tree, *idx):
    if isinstance(tree, dict):
        return {k: _at(v, *idx) for k, v in tree.items()}
    return tree[idx]


def hidden(params, c, tokens, prec, kv=None):
    """The last hidden state [B, S, d] (before the final norm) of ``tokens``."""
    if c["arch_type"] != "dense":
        raise ValueError(f"no reference for arch_type {c['arch_type']!r}")
    h = prec.act(params["embed"][tokens])
    for i in range(c["num_layers"]):
        h = decoder_layer(_at(params["groups"]["decoder"], i), c, h, prec, kv)
    return h


def logits(params, c, h, prec):
    return prec.mm(prec.act(rms(h, params["final_ln"])), params["head"])


class no_tf32:
    """f32 matrix products and convolutions in f32 on the card (TF32 off),
    restored on exit."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False


def last_logits(params, c, tokens, prec, kv=None):
    """Logits [B, V] at the last position of ``tokens`` [B, S]; with ``kv``
    also each layer's keys and values at its positions."""
    return logits(params, c, hidden(params, c, tokens, prec, kv)[:, -1], prec)


def all_logits(params, c, tokens, prec, start: int = 0):
    """Logits [B, S - start, V] at the positions of ``tokens`` [B, S] from
    ``start`` on."""
    return logits(params, c, hidden(params, c, tokens, prec)[:, start:], prec)


def served_gap(want, tokens):
    """How far each served token's reference logit lies below the
    reference's best at its position: ``want`` [..., V], ``tokens`` [...]."""
    return want.max(-1).values - want.gather(-1, tokens.long()[..., None])[..., 0]
