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


def _acc_dtype(dtype):
    """The type a plain version accumulates in: f32, or f64 for f64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def csr_spmm_ref(h, nbr_idx, weights):
    """out[i] = sum_d weights[i, d] * h[nbr_idx[i, d]], accumulated in f32
    (f64 for f64 inputs).

    h: [N, H]; nbr_idx: [N, D] int32; weights: [N, D].  Returns h's dtype."""
    acc = _acc_dtype(h.dtype)
    msgs = h[nbr_idx.long()].to(acc)                       # [N, D, H]
    out = torch.einsum("ndh,nd->nh", msgs, weights.to(acc))
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


def _leaky_relu(x):
    """leaky_relu with slope 0.2 as ``jax.nn.leaky_relu`` takes it: ``x``
    where ``x >= 0``, so its derivative at exactly 0 is 1 (torch's
    ``F.leaky_relu`` gives 0.2 there); the same values as ``F.leaky_relu``."""
    return torch.where(x >= 0, x, 0.2 * x)


def edge_softmax_agg_ref(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias):
    """GAT-style masked neighbour softmax + weighted aggregation.

    z: [N, H]; s_src/s_dst: [N]; nbr_idx/nbr_mask/etype_bias: [N, D]."""
    idx = nbr_idx.long()
    logits = _leaky_relu(s_src[idx] + s_dst[:, None] + etype_bias)
    logits = torch.where(nbr_mask > 0, logits, torch.full_like(logits, -1e9))
    attn = torch.softmax(logits.to(_acc_dtype(logits.dtype)), dim=-1) * nbr_mask
    return torch.einsum("ndh,nd->nh", z[idx], attn.to(z.dtype))


# ---------------------------------------------------------------------------
# Backward of the graph kernels (training)
# ---------------------------------------------------------------------------

def reverse_slots_ref(nbr_idx, nbr_mask):
    """The reverse-slot index of a padded graph, which the backward kernels
    read to sum into source rows in a fixed order, without atomics.

    The slots are the flat positions ``i * D + d`` with ``nbr_mask > 0``;
    empty slots (``nbr_mask == 0``, padding points at row 0) are left out.
    Source row ``j``'s slots, those whose index (clamped into [0, N), as
    the kernels clamp it) is ``j``, are ``rev_slot[rev_ptr[j]:rev_ptr[j +
    1]]`` in ascending order.  Returns ``(rev_ptr [N + 1], rev_slot [nnz])``,
    both int32.  Any weight or mask a later call passes must be zero
    outside these slots (stage 1's mask and the final hop's are)."""
    n = nbr_idx.shape[0]
    slots = torch.nonzero((nbr_mask > 0).flatten()).flatten()     # ascending
    src = nbr_idx.flatten()[slots].long().clamp(0, max(n - 1, 0))
    order = torch.sort(src, stable=True).indices
    ptr = torch.zeros(n + 1, dtype=torch.int64, device=nbr_idx.device)
    ptr[1:] = torch.cumsum(torch.bincount(src, minlength=n), 0)
    return ptr.int(), slots[order].int()


def _rev_sum(values, rev_ptr, n: int):
    """out[j] = sum of ``values`` over row j's reverse slots, in their
    order: ``values`` holds one entry (a scalar or a row) per reverse slot."""
    src = torch.repeat_interleave(torch.arange(n, device=values.device),
                                  rev_ptr.long().diff(), output_size=values.shape[0])
    out = torch.zeros((n,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, src, values)


def csr_spmm_bwd_ref(dout, weights, rev_ptr, rev_slot):
    """Gradient of :func:`csr_spmm_ref` with respect to ``h``, in closed
    form over the reverse index: dh[j] = sum over j's slots (i, d) of
    weights[i, d] * dout[i].  dout: [N, H] f32; weights: [N, D]."""
    n, d = weights.shape
    slot = rev_slot.long()
    w = weights.flatten()[slot]
    return _rev_sum(w[:, None] * dout[slot // d], rev_ptr, n)


def etype_mean_weights_ref(nbr_mask, nbr_etype, num_types: int):
    """Each slot's weight in the per-edge-type mean: mask[i, d] / cnt[i, e]
    for e = etype[i, d] in [0, num_types), cnt[i, e] the row's mask sum
    over type e (at least 1); 0 for a slot of a type outside that range.
    [N, D], the dtype of ``nbr_mask``."""
    et = nbr_etype.long()
    w = torch.zeros_like(nbr_mask)
    for e in range(num_types):
        we = nbr_mask * (et == e)
        w = w + we / we.sum(-1, keepdim=True).clamp_min(1.0)
    return w


def csr_spmm_etype_mean_bwd_ref(dout, nbr_mask, nbr_etype, rev_ptr, rev_slot):
    """Gradient of :func:`csr_spmm_etype_mean_ref` with respect to ``h``:
    dh[j] = sum over j's slots (i, d) of mask[i, d] / cnt[i, e] *
    dout[e, i], e = etype[i, d] (slots of a type outside [0, E) add
    nothing).  dout: [E, N, H] f32."""
    num_types = dout.shape[0]
    n, d = nbr_mask.shape
    w = etype_mean_weights_ref(nbr_mask, nbr_etype, num_types)
    slot = rev_slot.long()
    plane = nbr_etype.long().flatten()[slot]
    keep = (plane >= 0) & (plane < num_types)
    rows = dout[plane.clamp(0, num_types - 1), slot // d]
    vals = torch.where(keep, w.flatten()[slot], torch.zeros_like(rows[:, 0]))
    return _rev_sum(vals[:, None] * rows, rev_ptr, n)


def edge_softmax_agg_bwd_ref(dout, z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias,
                             rev_ptr, rev_slot):
    """Gradients of :func:`edge_softmax_agg_ref` with respect to ``z``,
    ``s_src``, ``s_dst`` and ``etype_bias``, in closed form.

    With p the softmax over a row's D slots (masked logits at -1e9) and
    g[i, d] = dout[i] . z[idx[i, d]]: dp = mask * g, c_i = sum_d p * dp,
    dlogit = p * (dp - c_i) * leaky'(pre) on slots with mask > 0 (0 on
    the others, where the logit is the constant -1e9), leaky' 1 where the
    pre-activation is >= 0, else 0.2.  Then ds_dst[i] = sum_d dlogit,
    d(etype_bias) = dlogit, and over the reverse index dz[j] = sum of
    p * mask * dout[i] and ds_src[j] = sum of dlogit."""
    n, d = nbr_mask.shape
    idx = nbr_idx.long()
    valid = nbr_mask > 0
    pre = s_src[idx] + s_dst[:, None] + etype_bias
    logits = torch.where(valid, _leaky_relu(pre), torch.full_like(pre, -1e9))
    p = torch.softmax(logits, dim=-1)
    dp = nbr_mask * torch.einsum("ndh,nh->nd", z[idx], dout)
    c = (p * dp).sum(-1, keepdim=True)
    slope = torch.where(pre >= 0, torch.ones_like(pre), torch.full_like(pre, 0.2))
    dlogit = torch.where(valid, p * (dp - c) * slope, torch.zeros_like(pre))
    slot = rev_slot.long()
    alpha = (p * nbr_mask).flatten()[slot]
    dz = _rev_sum(alpha[:, None] * dout[slot // d], rev_ptr, n)
    ds_src = _rev_sum(dlogit.flatten()[slot], rev_ptr, n)
    return dz, ds_src, dlogit.sum(-1), dlogit


def _mm(x, w):
    """``x @ w``, where a one-column ``w`` [K, 1] is taken as an elementwise
    product and a sum over K: each row's bits then do not depend on how many
    rows come with it (the CPU's matrix-vector path rounds rows differently
    at two or three rows than at more, and stage 2 runs at micro-batches of
    two)."""
    if w.shape[-1] == 1:
        return (x * w[:, 0]).sum(-1, keepdim=True)
    return x @ w


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
            tr = torch.relu(_mm(emb0, p["typed_w"][t]) + p["typed_b"][t])
            emb = torch.where((slot_type == t)[..., None], tr, emb)

    h = torch.relu(_mm(feats, p["w_in"]) + p["b_in"] + p["type_row"])
    for li in range(p["tower_w"].shape[0]):
        h = torch.relu(_mm(h, p["tower_w"][li]) + p["tower_b"][li])

    if gnn_type in ("gcn", "sage"):
        cnt = mask.sum(-1, keepdim=True).clamp_min(1.0)
        agg = torch.einsum("bkh,bk->bh", emb, mask / cnt)
        g = _mm(h, p["w_self"]) + _mm(agg, p["w_nbr"])
    else:
        w = p["w_gat"]
        z = _mm(emb, w)
        s_dst = _mm(_mm(h, w), p["a_dst"])                        # [B, 1]
        s_src = _mm(z, p["a_src"])[..., 0]                         # [B, K]
        logits = F.leaky_relu(s_src + s_dst + p["a_et"][0, 0], 0.2)
        logits = torch.where(mask > 0, logits, torch.full_like(logits, -1e9))
        attn = torch.softmax(logits, dim=-1) * mask
        g = torch.einsum("bkh,bk->bh", z, attn) + _mm(h, p["w_self"])
    g = torch.relu(g + p["b_last"])

    y = _mm(g, p["w0g"]) + _mm(feats, p["w0f"]) + p["b0"]
    for w, b in p["mlp"]:
        y = _mm(torch.relu(y), w) + b
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
