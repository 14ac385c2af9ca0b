"""Plain PyTorch versions of the port's kernels.

Each computes what its CUDA kernel computes, with ordinary tensor ops.  They
are the path for CPU tensors, and ``chip_smoke.py`` holds each kernel
against its plain version on the card.  The tests hold them against the
reference's Pallas kernels (interpret mode).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.stage2_score import unpack_stage2_params

_LOG2E = 1.4426950408889634


def csr_spmm_ref(h, nbr_idx, weights):
    """out[i] = sum_d weights[i, d] * h[nbr_idx[i, d]], accumulated in f32.

    h: [N, H]; nbr_idx: [N, D] int32; weights: [N, D].  Returns h's dtype."""
    msgs = h[nbr_idx.long()].float()                       # [N, D, H]
    out = torch.einsum("ndh,nd->nh", msgs, weights.float())
    return out.to(h.dtype)


def csr_spmm_etype_mean_ref(h, nbr_idx, nbr_mask, nbr_etype, num_types: int):
    """Mean-aggregate neighbour states separately per edge type, [E, N, H]:
    for each type e < ``num_types``, :func:`csr_spmm_ref` with the weights
    ``mask * (etype == e)`` over their float sum (at least 1)."""
    outs = []
    for e in range(num_types):
        w = nbr_mask * (nbr_etype == e)
        cnt = w.sum(-1, keepdim=True).clamp_min(1.0)
        outs.append(csr_spmm_ref(h, nbr_idx, w / cnt))
    return torch.stack(outs)


def edge_softmax_agg_ref(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias):
    """GAT-style masked neighbour softmax + weighted aggregation.

    z: [N, H]; s_src/s_dst: [N]; nbr_idx/nbr_mask/etype_bias: [N, D]."""
    idx = nbr_idx.long()
    logits = s_src[idx] + s_dst[:, None] + etype_bias
    logits = F.leaky_relu(logits, 0.2)
    logits = torch.where(nbr_mask > 0, logits, torch.full_like(logits, -1e9))
    attn = torch.softmax(logits.float(), dim=-1) * nbr_mask
    return torch.einsum("ndh,nd->nh", z[idx], attn.to(z.dtype))


def stage2_score_ref(entity_emb, emb_mask, order_feats, flat,
                     gnn_type: str = "gcn", slot_type=None):
    """The fused stage-2 computation, unfused, over the flattened weights
    (:func:`~repro_torch.kernels.stage2_score.flatten_stage2_params`).

    ``(emb [B,K,H], mask [B,K], feats [B,F]) -> logits [B]``; ``slot_type``
    (int ``[B, K]``, -1 = untyped slot) selects the typed variant."""
    p = unpack_stage2_params(flat, gnn_type, typed=slot_type is not None)
    emb = entity_emb.float()
    mask = emb_mask.float()
    feats = order_feats.float()

    if slot_type is not None:
        # every type's tower reads the original embedding, not a chained one
        emb0 = emb
        for t in range(p["typed_w"].shape[0]):
            tr = torch.relu(emb0 @ p["typed_w"][t] + p["typed_b"][t])
            emb = torch.where((slot_type == t)[..., None], tr, emb)

    h = torch.relu(feats @ p["w_in"] + p["b_in"] + p["type_row"])
    for li in range(p["tower_w"].shape[0]):
        h = torch.relu(h @ p["tower_w"][li] + p["tower_b"][li])

    if gnn_type in ("gcn", "sage"):
        cnt = mask.sum(-1, keepdim=True).clamp_min(1.0)
        agg = torch.einsum("bkh,bk->bh", emb, mask / cnt)
        g = h @ p["w_self"] + agg @ p["w_nbr"]
    else:
        w = p["w_gat"]
        z = emb @ w
        s_dst = (h @ w) @ p["a_dst"]                              # [B, 1]
        s_src = (z @ p["a_src"])[..., 0]                          # [B, K]
        logits = F.leaky_relu(s_src + s_dst + p["a_et"][0, 0], 0.2)
        logits = torch.where(mask > 0, logits, torch.full_like(logits, -1e9))
        attn = torch.softmax(logits, dim=-1) * mask
        g = torch.einsum("bkh,bk->bh", z, attn) + h @ p["w_self"]
    g = torch.relu(g + p["b_last"])

    y = g @ p["w0g"] + feats @ p["w0f"] + p["b0"]
    for w, b in p["mlp"]:
        y = torch.relu(y) @ w + b
    return y[:, 0]


# ---------------------------------------------------------------------------
# Attention kernels (transformer zoo)
# ---------------------------------------------------------------------------

def mha_ref(q, k, v, causal=True, window=None, scale=None):
    """Full O(S^2) GQA attention oracle.

    q: [B, Hq, Sq, Dh]; k/v: [B, Hkv, Sk, Dh]; Hq % Hkv == 0.
    ``window``: sliding-window size (keys within [i-window+1, i]); q rows
    are aligned to the end of the keys.  For cross attention causal=False.
    """
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = hq // hkv
    if scale is None:
        scale = dh ** -0.5
    kk = k.repeat_interleave(rep, dim=1)
    vv = v.repeat_interleave(rep, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, kk).float() * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv)


def gqa_decode_ref(q, k, v, kv_len=None, window=None):
    """Single-token decode attention: the plain version of the gqa_decode
    kernel, and the reference's inline XLA path (``models/attention.py``).

    q: [B, Hq, Dh]; k/v: [B, Hkv, S, Dh] (the cache); kv_len: [B] valid
    lengths (None = full).  ``window``: only the last ``window`` valid
    positions attend.  Logits and the weighted sum in f32 (the
    probabilities rounded to v's dtype first).  Returns [B, Hq, Dh].
    """
    b, hq, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    rep = hq // hkv
    qg = q.reshape(b, hkv, rep, dh).float()
    logits = torch.einsum("bgrd,bgsd->bgrs", qg, k.float()) * (dh ** -0.5)
    pos = torch.arange(s, device=q.device)[None, :]
    if kv_len is None:
        valid = torch.ones((b, s), dtype=torch.bool, device=q.device)
        hi = torch.full((b, 1), s, device=q.device)
    else:
        hi = kv_len.long()[:, None]
        valid = pos < hi
    if window is not None:
        valid &= pos >= hi - window
    logits = torch.where(valid[:, None, None, :], logits, torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1).to(v.dtype).float()
    out = torch.einsum("bgrs,bgsd->bgrd", p, v.float())
    return out.reshape(b, hq, dh).to(q.dtype)


def gqa_decode_split_ref(q, k, v, kv_len=None, window=None, chunk: int = 64):
    """The gqa_decode kernel's own arithmetic: the cache cut into splits of
    ``chunk`` rows, a partial (m, l, acc) per split with the probabilities
    rounded to v's dtype against the split's own max, then the combine in
    split order.  Used by the tests and ``chip_smoke.py`` only, to keep the
    kernel's partition and combine rule testable without the card.

    Valid rows are [max(kv_len - window, 0), min(kv_len, S)).  A split with
    no valid row is neutral (m = -inf, l = 0).  With no valid row at all
    every slot's logit is -1e30, so each weighs 1 and the result is the
    mean of v over the S slots, as in the reference.  Returns [B, Hq, Dh].
    """
    b, hq, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    rep = hq // hkv
    n = -(-s // chunk)
    qg = q.reshape(b, hkv, rep, dh).float()
    logits = torch.einsum("bgrd,bgsd->bgrs", qg, k.float()) * (dh ** -0.5)
    pos = torch.arange(s, device=q.device)[None, :]
    hi = torch.full((b, 1), s, device=q.device) if kv_len is None else kv_len.long()[:, None]
    valid = pos < hi
    if window is not None:
        valid &= pos >= hi - window
    empty = ~valid.any(-1)                                        # [B]
    neg_inf = torch.tensor(float("-inf"), device=q.device)
    logits = torch.where(valid[:, None, None, :], logits, neg_inf)
    logits = torch.where(empty[:, None, None, None], torch.full_like(logits, -1e30), logits)
    logits = F.pad(logits, (0, n * chunk - s), value=float("-inf"))
    vc = F.pad(v.float(), (0, 0, 0, n * chunk - s)).reshape(b, hkv, n, chunk, dh)
    logits = logits.reshape(b, hkv, rep, n, chunk)
    m = logits.amax(-1)                                           # [B, G, R, n]
    neutral = m == float("-inf")
    p = torch.exp(logits - torch.where(neutral, 0.0, m)[..., None])
    l = p.sum(-1)
    acc = torch.einsum("bgrnc,bgncd->bgrnd", p.to(v.dtype).float(), vc)
    mx = m.amax(-1, keepdim=True)
    w = torch.where(neutral, 0.0, torch.exp(m - mx))
    den = (l * w).sum(-1).clamp_min(1e-30)
    out = (acc * w[..., None]).sum(-2) / den[..., None]
    return out.reshape(b, hq, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Mamba2 SSD (state-space duality) scan
# ---------------------------------------------------------------------------

def ssd_scan_ref(x, dt, a, b, c, d_skip=None):
    """Sequential SSD recurrence (Mamba2, arXiv 2405.21060).

    x: [B, S, H, P]; dt: [B, S, H] (softplus-activated, > 0); a: [H]
    (negative decay rates); b, c: [B, S, N] (one group); d_skip: [H] or
    None.  Returns y [B, S, H, P] in x's dtype.  Per head h, with S_t in
    R^{N x P}:  S_t = exp(dt_t a_h) S_{t-1} + dt_t (b_t ⊗ x_t),  y_t = S_t^T c_t.
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    x32, dt32, b32, c32 = x.float(), dt.float(), b.float(), c.float()
    state = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt32[:, t] * a[None, :])                    # [B, H]
        upd = torch.einsum("bn,bhp,bh->bhnp", b32[:, t], x32[:, t], dt32[:, t])
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bhnp,bn->bhp", state, c32[:, t]))
    y = torch.stack(ys, dim=1)
    if d_skip is not None:
        y = y + x32 * d_skip[None, None, :, None]
    return y.to(x.dtype)


def ssd_chunked_ref(x, dt, a, b, c, d_skip=None, chunk: int = 64,
                    compute_dtype=torch.float32):
    """Chunk-parallel SSD evaluation (the algorithm of the TPU kernel) with
    plain tensor ops: the reference's XLA path op for op.

    ``compute_dtype`` is the dtype of the big intra-chunk tensors (the
    [Q, Q, H] decay and weight blocks); state math stays f32.
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc = s // chunk
    cd = compute_dtype
    xc = x.reshape(bsz, nc, chunk, h, p).to(cd)
    dtc = dt.reshape(bsz, nc, chunk, h).float()
    bc = b.reshape(bsz, nc, chunk, n).to(cd)
    cc = c.reshape(bsz, nc, chunk, n).to(cd)

    # cumulative log-decay within each chunk: l[t] = sum_{u<=t} dt_u * a
    cum = torch.cumsum(dtc * a[None, None, None, :], dim=2)          # [B,nc,Q,H]
    total = cum[:, :, -1]                                            # [B,nc,H]

    # intra-chunk: y[t] = sum_{u<=t} c_t·b_u exp(cum[t]-cum[u]) dt_u x_u
    scores = torch.einsum("bkin,bkjn->bkij", cc.float(), bc.float())  # [B,nc,Q,Q]
    decay = torch.exp(torch.clamp(cum[:, :, :, None, :] - cum[:, :, None, :, :],
                                  -60.0, 0.0)).to(cd)                # [B,nc,Q,Q,H]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    w = scores.to(cd)[..., None] * decay * causal[None, None, :, :, None]
    wd = w.float() * dtc.to(cd).float()[:, :, None, :, :]
    y_intra = torch.einsum("bkijh,bkjhp->bkihp", wd, xc.float())

    # chunk states: S_k = sum_u exp(total - cum[u]) dt_u (b_u ⊗ x_u)
    dec_state = torch.exp(torch.clamp(total[:, :, None] - cum, -60.0, 0.0))
    xw = xc.float() * (dec_state * dtc)[..., None]
    s_chunk = torch.einsum("bkjn,bkjhp->bkhnp", bc.float(), xw)

    # inter-chunk scan: the state before each chunk, carried with exp(total)
    carry = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    prev = []
    for k in range(nc):
        prev.append(carry)
        carry = carry * torch.exp(torch.clamp(total[:, k], -60.0, 0.0))[..., None, None] \
            + s_chunk[:, k]
    prev_states = torch.stack(prev, dim=1)                           # [B,nc,H,N,P]

    # inter-chunk contribution: y[t] = exp(cum[t]) c_t · S_prev
    y_inter = torch.einsum("bkin,bkhnp->bkihp", cc.float(), prev_states) \
        * torch.exp(torch.clamp(cum, -60.0, 0.0))[..., None]
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    if d_skip is not None:
        y = y + x.float() * d_skip[None, None, :, None]
    return y.to(x.dtype)


def ssd_scan_mma_ref(x, dt, a, b, c, d_skip=None, chunk: int = 64):
    """The bf16 ssd_scan kernel's own arithmetic: the chunked algorithm of
    :func:`ssd_chunked_ref` with x, b and c taken as bf16 and values rounded
    to bf16 exactly where the kernel rounds them to feed its tensor-core
    products, all sums in f32.  Used by the tests and ``chip_smoke.py``
    only, to keep those roundings testable without the card.

    The rounded values: W = (C·Bᵀ) exp(cum_i - cum_j) dt_j (masked to
    j <= i) for W·x; the state before each chunk for C·S (the carried state
    stays f32); b_j exp(total - cum_j) dt_j for the state update.  The
    exponents are taken in base 2 (dt·a·log2 e, clipped to -60·log2 e and
    0), as the kernel does.  A ragged last chunk is padded with no-op rows
    (dt = 0, x = b = c = 0), so any S works.  Returns y [B, S, H, P] in
    x's dtype.
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s

    def rounded(t):
        return t.to(torch.bfloat16).float()

    def clip_exp2(v):
        return torch.exp2(torch.clamp(v, -60.0 * _LOG2E, 0.0))

    xc = F.pad(rounded(x), (0, 0, 0, 0, 0, pad)).reshape(bsz, nc, chunk, h, p)
    dtc = F.pad(dt.float(), (0, 0, 0, pad)).reshape(bsz, nc, chunk, h)
    bc = F.pad(rounded(b), (0, 0, 0, pad)).reshape(bsz, nc, chunk, n)
    cc = F.pad(rounded(c), (0, 0, 0, pad)).reshape(bsz, nc, chunk, n)

    cum = torch.cumsum(dtc * (a.float() * _LOG2E)[None, None, None, :], dim=2)  # base 2
    total = cum[:, :, -1]                                                     # [B,nc,H]

    # intra-chunk: W rounded to bf16, then W·x
    scores = torch.einsum("bkin,bkjn->bkij", cc, bc)
    decay = clip_exp2(cum[:, :, :, None, :] - cum[:, :, None, :, :])          # [B,nc,Q,Q,H]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    w = scores[..., None] * decay * dtc[:, :, None, :, :]
    w = rounded(torch.where(causal[None, None, :, :, None], w, torch.zeros_like(w)))
    y_intra = torch.einsum("bkijh,bkjhp->bkihp", w, xc)

    # chunk states from the rounded operand b_j exp(total - cum_j) dt_j
    bw = rounded(bc[..., None] * (clip_exp2(total[:, :, None] - cum) * dtc)[:, :, :, None, :])
    s_chunk = torch.einsum("bkjnh,bkjhp->bkhnp", bw, xc)

    # the state carried in f32; C·S reads its bf16 copy
    carry = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    y_inter = []
    for k in range(nc):
        y_inter.append(torch.einsum("bin,bhnp->bihp", cc[:, k], rounded(carry)))
        carry = carry * clip_exp2(total[:, k])[..., None, None] + s_chunk[:, k]
    y = y_intra + torch.stack(y_inter, dim=1) * clip_exp2(cum)[..., None]
    if d_skip is not None:
        y = y + xc * d_skip[None, None, None, :, None]
    return y.reshape(bsz, nc * chunk, h, p)[:, :s].to(x.dtype)
