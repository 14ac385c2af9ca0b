"""Mamba2 (SSD) block: prefill/forward path + O(1)-state decode path.

The reference's ``repro.models.mamba`` with tensors: in_proj -> (gate z,
conv branch [x|B|C], dt), depthwise causal conv1d, SSD scan over heads,
gated RMSNorm, out_proj.  The SSD scan goes through ``kernels.ops.ssd_scan``
(the CUDA kernel for CUDA tensors, the reference's XLA path on the CPU);
decode keeps a (conv_state, ssm_state) cache, O(1) in sequence length.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import shard_local
from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, rmsnorm, torch_dtype, wide


def mamba_init(gen: torch.Generator, cfg, device=None):
    dtype = torch_dtype(cfg.dtype)
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_width = di + 2 * n
    return {
        "w_in": dense_init(gen, (d, 2 * di + 2 * n + h), dtype, device=device),
        "conv_w": dense_init(gen, (cfg.conv_kernel, conv_width), dtype, scale=0.5,
                             device=device),
        "conv_b": torch.zeros((conv_width,), dtype=dtype, device=device),
        "a_log": torch.log(torch.linspace(1.0, 8.0, h, dtype=torch.float32, device=device)),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=device),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=device),
        "norm_scale": torch.zeros((di,), dtype=dtype, device=device),
        "w_out": dense_init(gen, (di, d), dtype, device=device),
    }


def _split_proj(cfg, proj):
    di, n = cfg.d_inner, cfg.ssm_state
    z = proj[..., :di]
    conv_in = proj[..., di:2 * di + 2 * n]
    dt = proj[..., 2 * di + 2 * n:]
    return z, conv_in, dt


def _causal_conv(params, conv_in, conv_state=None):
    """Depthwise causal conv1d.  conv_in: [B, S, W].  Returns (y, new_state)
    where state is the last (K-1) inputs for decode.

    A sum of K shifted products, as the reference, and not ``F.conv1d``: a
    float32 convolution goes through cuDNN in TF32 by default, which keeps
    about three digits."""
    k = params["conv_w"].shape[0]
    if conv_state is None:
        pad = conv_in.new_zeros((conv_in.shape[0], k - 1, conv_in.shape[2]))
    else:
        pad = conv_state
    xp = torch.cat([pad, conv_in], dim=1)                    # [B, S+K-1, W]
    s = conv_in.shape[1]
    y = xp[:, 0:s] * params["conv_w"][0][None, None, :]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * params["conv_w"][i][None, None, :]
    y = F.silu(wide(y + params["conv_b"])).to(conv_in.dtype)
    return y, xp[:, -(k - 1):]


def _ssm_inputs(params, cfg, conv_out, dt):
    """(x [.., H, P], b, c, dt after softplus, a) from the conv output."""
    di, n, h, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    xs = conv_out[..., :di].unflatten(-1, (h, p))
    bmat = conv_out[..., di:di + n]
    cmat = conv_out[..., di + n:]
    dt = F.softplus(wide(dt) + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    return xs, bmat, cmat, dt, a


def _gate_out(params, y, z, eps):
    y = rmsnorm(y * F.silu(wide(z)).to(y.dtype), params["norm_scale"], eps)
    return y @ params["w_out"]


def mamba_apply(params, cfg, x, *, return_state=False, eps=1e-6):
    """Full-sequence path.  x: [B, S, d] -> ([B, S, d], state or None).

    The state, when asked for, is {conv [B, K-1, W], ssm [B, H, N, P] f32}.
    ``eps``: the gated RMSNorm's."""
    b, s, _ = x.shape
    proj = x @ params["w_in"]
    z, conv_in, dt = _split_proj(cfg, proj)
    conv_out, conv_state = _causal_conv(params, conv_in)
    xs, bmat, cmat, dt, a = _ssm_inputs(params, cfg, conv_out, dt)
    xs, bmat, cmat = xs.contiguous(), bmat.contiguous(), cmat.contiguous()
    y = ops.ssd_scan(xs, dt, a, bmat, cmat, params["d_skip"], chunk=cfg.ssd_chunk,
                     compute_dtype=torch_dtype(cfg.ssd_compute_dtype))
    out = _gate_out(params, y.reshape(b, s, cfg.d_inner), z, eps)
    if not return_state:
        return out, None
    # shard-local on a mesh (dist.sharding.shard_local): independent over the
    # batch and the heads, and its reversed prefix sum (torch.flip) has no
    # DTensor rule in torch 2.11
    state = shard_local(_final_state, (xs, dt, a, bmat), ((0, 2), (0, 2), (None, 0), (0, None)),
                        out_dims=(0, 1))
    return out, {"conv": conv_state, "ssm": state}


def _final_state(xs, dt, a, bmat):
    """Final SSD state [B, H, N, P] after the whole sequence, in closed form:

        S_T = Σ_t exp(Σ_{u>t} dt_u a) · dt_t · (b_t ⊗ x_t)

    one weighted sum (a batched matrix product) in place of the reference's
    per-token scan, which would cost S small launches per layer.  The decay
    exponent is a suffix sum of ``dt * a`` taken in f32 from the end, so the
    weights of the recent steps, which dominate, carry the rounding of a
    short sum.  It equals the scan's state up to rounding: the scan
    multiplies S rounded decays where this rounds one exponent per step
    (the tests hold it to 1e-5 of the state's scale)."""
    bsz, s, h, p = xs.shape
    seg = dt * a[None, None, :]                                    # [B, S, H]
    incl = torch.flip(torch.cumsum(torch.flip(seg, [1]), 1), [1])  # Σ_{u>=t}
    after = torch.cat([incl[:, 1:], torch.zeros_like(incl[:, :1])], dim=1)
    wx = xs.float() * (torch.exp(after) * dt)[..., None]           # [B, S, H, P]
    state = torch.bmm(bmat.float().transpose(1, 2), wx.reshape(bsz, s, h * p))
    return state.reshape(bsz, -1, h, p).transpose(1, 2).contiguous()


def mamba_decode(params, cfg, x1, cache, eps=1e-6):
    """Single-token step.  x1: [B, 1, d]; cache: {conv [B,K-1,W], ssm [B,H,N,P]}.
    Returns (y [B, 1, d], new cache).  ``eps``: the gated RMSNorm's."""
    b = x1.shape[0]
    proj = x1 @ params["w_in"]                                     # [B, 1, ...]
    z, conv_in, dt = _split_proj(cfg, proj)
    conv_out, conv_state = _causal_conv(params, conv_in, cache["conv"])
    xs, bmat, cmat, dt, a = _ssm_inputs(params, cfg, conv_out[:, 0], dt[:, 0])
    decay = torch.exp(dt * a[None, :])                             # [B, H]
    xs32 = xs.float()
    ssm = cache["ssm"] * decay[..., None, None] + torch.einsum(
        "bn,bhp,bh->bhnp", bmat.float(), xs32, dt)
    y = torch.einsum("bhnp,bn->bhp", ssm, cmat.float())
    y = y + xs32 * params["d_skip"][None, :, None]
    y = y.reshape(b, 1, cfg.d_inner).to(x1.dtype)
    return _gate_out(params, y, z, eps), {"conv": conv_state, "ssm": ssm}
