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
from repro_torch.utils.padding import pad_to_multiple

_LOG2E = 1.4426950408889634


def _acc_dtype(dtype):
    """The type a plain version accumulates in: f32, or f64 for f64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def _wide(x):
    """``x`` in :func:`_acc_dtype`."""
    return x.to(_acc_dtype(x.dtype))


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
    w = etype_mean_weights_ref(nbr_mask, nbr_etype, dout.shape[0])
    return csr_spmm_etype_mean_bwd_saved_ref(dout, w, nbr_etype, rev_ptr, rev_slot)


def csr_spmm_etype_mean_bwd_saved_ref(dout, wslot, nbr_etype, rev_ptr, rev_slot):
    """:func:`csr_spmm_etype_mean_bwd_ref` from the slot weights the forward
    kernel saves under grad (``wslot``, :func:`etype_mean_weights_ref`), as
    the backward kernel reads them."""
    num_types = dout.shape[0]
    n, d = wslot.shape
    slot = rev_slot.long()
    plane = nbr_etype.long().flatten()[slot]
    keep = (plane >= 0) & (plane < num_types)
    rows = dout[plane.clamp(0, num_types - 1), slot // d]
    vals = torch.where(keep, wslot.flatten()[slot], torch.zeros_like(rows[:, 0]))
    return _rev_sum(vals[:, None] * rows, rev_ptr, n)


def edge_softmax_stats_ref(s_src, s_dst, nbr_idx, nbr_mask, etype_bias):
    """Each row's softmax max and sum over its D masked logits, [N, 2] f32:
    what the forward kernel saves under grad for the backward."""
    idx = nbr_idx.long()
    pre = s_src[idx] + s_dst[:, None] + etype_bias
    logits = torch.where(nbr_mask > 0, _leaky_relu(pre), torch.full_like(pre, -1e9)).float()
    m = logits.max(-1).values if logits.shape[1] else torch.full_like(s_dst, -float("inf"))
    return torch.stack([m, torch.exp(logits - m[:, None]).sum(-1)], -1)


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


def edge_softmax_agg_bwd_saved_ref(dout, out, stats, z, s_src, s_dst, nbr_idx, nbr_mask,
                                   etype_bias, rev_ptr, rev_slot):
    """:func:`edge_softmax_agg_bwd_ref` as the backward kernel computes it,
    from what its forward saves: p = exp(logit - max) / sum from the row's
    ``stats`` [N, 2] (:func:`edge_softmax_stats_ref`), and c_i =
    dout[i] . out[i] in place of sum_d p * dp (the same number, since out[i]
    = sum_d p * mask * z[idx[i, d]])."""
    n, d = nbr_mask.shape
    idx = nbr_idx.long()
    valid = nbr_mask > 0
    pre = s_src[idx] + s_dst[:, None] + etype_bias
    logits = torch.where(valid, _leaky_relu(pre), torch.full_like(pre, -1e9))
    p = torch.exp(logits - stats[:, :1]) / stats[:, 1:]
    dp = nbr_mask * torch.einsum("ndh,nh->nd", z[idx], dout)
    c = (dout * out).sum(-1, keepdim=True)
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


def blockwise_attention(q, k, v, *, causal=True, window=None, block_k=512,
                        q_offset=None, scale=None):
    """The plain version of the prefill attention kernel
    (``kernels.ops.flash_attention`` takes it for CPU tensors), the
    reference's XLA path op for op.

    q: [B, Hq, Sq, Dh]; k/v: [B, Hkv, Sk, Dh].  GQA via head grouping
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
    qg = _wide(q.reshape(b, hkv, rep, sq, dh))
    acc_t = qg.dtype
    qpos = q_offset + torch.arange(sq, device=dev)

    m = torch.full((b, hkv, rep, sq), -1e30, dtype=acc_t, device=dev)
    denom = torch.zeros((b, hkv, rep, sq), dtype=acc_t, device=dev)
    acc = torch.zeros((b, hkv, rep, sq, dh), dtype=acc_t, device=dev)
    for j in range(sk // block_k):
        kj = _wide(k[:, :, j * block_k:(j + 1) * block_k])
        vj = v[:, :, j * block_k:(j + 1) * block_k]
        logits = torch.einsum("bgrsd,bgkd->bgrsk", qg, kj) * scale
        kpos = j * block_k + torch.arange(block_k, device=dev)
        mask = (kpos[None, :] < kv_valid).expand(sq, block_k)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        alpha = torch.exp(m - m_new)
        denom = denom * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bgrsk,bgkd->bgrsd", _wide(p.to(vj.dtype)), _wide(vj))
        m = m_new
    out = acc / denom.clamp_min(1e-30)[..., None]
    return out.reshape(b, hq, sq, dh).to(q.dtype)


def gqa_decode_ref(q, k, v, kv_len=None, window=None, scale=None):
    """Single-token decode attention: the plain version of the gqa_decode
    kernel, and the reference's inline XLA path (``models/attention.py``).

    q: [B, Hq, Dh]; k/v: [B, Hkv, S, Dh] (the cache); kv_len: [B] valid
    lengths (None = full).  ``window``: only the last ``window`` valid
    positions attend.  ``scale``: the logits' (default ``Dh ** -0.5``).
    Logits and the weighted sum in f32 (the probabilities rounded to v's
    dtype first).  Returns [B, Hq, Dh].
    """
    b, hq, dh = q.shape
    hkv, s = k.shape[1], k.shape[2]
    rep = hq // hkv
    qg = q.reshape(b, hkv, rep, dh).float()
    logits = torch.einsum("bgrd,bgsd->bgrs", qg, k.float()) * (
        dh ** -0.5 if scale is None else scale)
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


def _attn_masks(sq: int, sk: int, causal: bool, window, device):
    """The mask of the prefill attention kernel, q rows aligned to the end of
    the keys: ``valid`` [Sq, Sk], whether key j counts for q row i, and
    ``dead`` [Sq], the rows with no valid key (causal, Sq > Sk: the q rows
    before the first key), whose output is the mean of v over the Sk keys."""
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    valid = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        valid &= kpos <= qpos
    if window is not None:
        valid &= kpos > qpos - window
    return valid, ~valid.any(-1)


def _attn_logits(qg, kg, valid, dead, scale):
    """Scaled f32 logits of one kv head's q heads ``qg`` [B, R, Sq, Dh]
    against its keys ``kg`` [B, Sk, Dh]: -inf where masked, 0 on a dead
    row (its keys weigh alike)."""
    s = torch.einsum("brqd,bkd->brqk", qg, kg) * scale
    fill = torch.where(dead[:, None], 0.0, float("-inf")).to(s.dtype)
    return torch.where(valid, s, fill)


def attention_lse_ref(q, k, causal=True, window=None, scale=None):
    """Each q row's logsumexp over its logits scaled by ``scale`` (default
    ``Dh ** -0.5``), [B, Hq, Sq] f32 in
    natural-log units (f64 for f64 inputs): what the flash_attention forward kernel writes under
    grad, for its backward.  A dead row (no valid key, :func:`_attn_masks`)
    gets log(Sk), so that exp(0 - lse) is its uniform weight 1 / Sk."""
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = hq // hkv
    valid, dead = _attn_masks(sq, sk, causal, window, q.device)
    acc = _acc_dtype(q.dtype)
    out = []
    for g in range(hkv):
        hs = slice(g * rep, (g + 1) * rep)
        s = _attn_logits(q[:, hs].to(acc), k[:, g].to(acc), valid, dead,
                         dh ** -0.5 if scale is None else scale)
        out.append(torch.logsumexp(s, -1))
    return torch.cat(out, dim=1)


def flash_attention_bwd_ref(q, k, v, out, dout, lse, causal=True, window=None, scale=None):
    """Gradients of the prefill attention (``kernels.ops.flash_attention``)
    with respect to q, k and v, in closed form from the forward's output
    ``out`` and row logsumexp ``lse`` (:func:`attention_lse_ref`), in f32
    (f64 for f64 inputs):

        p = exp(s - lse),  delta_i = dout_i . out_i,
        ds = p * (dout v^T - delta),
        dq = scale ds k,  dk = scale ds^T q,  dv = p^T dout,

    with s the logits scaled by ``scale`` (default ``Dh ** -0.5``).  Masked
    entries have p = ds = 0; a dead row has p = 1 / Sk on every key and
    ds = 0 (its logits are constants).  dk and dv sum over a kv head's q
    heads in head order.  Returns (dq, dk, dv) in the dtypes of q, k and v."""
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = dh ** -0.5 if scale is None else scale
    valid, dead = _attn_masks(sq, sk, causal, window, q.device)
    acc = _acc_dtype(q.dtype)
    delta = (dout.to(acc) * out.to(acc)).sum(-1)                     # [B, Hq, Sq]
    dq, dk, dv = [], [], []
    for g in range(hkv):
        hs = slice(g * rep, (g + 1) * rep)
        qg, kg, vg = q[:, hs].to(acc), k[:, g].to(acc), v[:, g].to(acc)
        dog = dout[:, hs].to(acc)
        p = torch.exp(_attn_logits(qg, kg, valid, dead, scale) - lse[:, hs, :, None])
        dp = torch.einsum("brqd,bkd->brqk", dog, vg)
        ds = torch.where(valid, p * (dp - delta[:, hs, :, None]), torch.zeros_like(p))
        dq.append(torch.einsum("brqk,bkd->brqd", ds, kg) * scale)
        dkg = dvg = 0.0
        for r in range(rep):          # the kv head's q heads in order
            dkg = dkg + torch.einsum("bqk,bqd->bkd", ds[:, r], qg[:, r])
            dvg = dvg + torch.einsum("bqk,bqd->bkd", p[:, r], dog[:, r])
        dk.append(dkg * scale)
        dv.append(dvg)
    return (torch.cat(dq, 1).to(q.dtype), torch.stack(dk, 1).to(k.dtype),
            torch.stack(dv, 1).to(v.dtype))


def flash_attention_bwd_mma_ref(q, k, v, out, dout, lse, causal=True, window=None):
    """The bf16 flash_attention backward kernels' own arithmetic: the closed
    form of :func:`flash_attention_bwd_ref` with p taken in base 2
    (exp2(s·scale·log2 e − lse·log2 e), a dead row's exp2(−lse·log2 e)) and,
    for bf16 inputs, p and ds rounded to bf16 where the kernels feed them to
    their tensor-core products (dv = pᵀ dout; dk = scale dsᵀ q and dq =
    scale ds k), every sum in f32 and the outputs rounded once.  With f32
    inputs nothing is rounded (f64 inputs are taken in f64).  Used by the
    tests and ``chip_smoke.py`` only, to keep the kernels' roundings
    testable without the card, as :func:`ssd_scan_mma_ref` for the scan's
    forward.  Returns (dq, dk, dv) in the dtypes of q, k and v."""
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = dh ** -0.5
    valid, dead = _attn_masks(sq, sk, causal, window, q.device)
    f32 = _acc_dtype(q.dtype)
    if q.dtype == torch.bfloat16:
        def rounded(t):
            return t.to(torch.bfloat16).float()
    else:
        def rounded(t):
            return t
    delta = (dout.to(f32) * out.to(f32)).sum(-1)                      # [B, Hq, Sq]
    lse2 = lse.to(f32) * _LOG2E
    dq = torch.empty(q.shape, dtype=f32, device=q.device)
    dk = torch.empty(k.shape, dtype=f32, device=q.device)
    dv = torch.empty(v.shape, dtype=f32, device=q.device)
    for g in range(hkv):
        hs = slice(g * rep, (g + 1) * rep)
        qg, kg, vg, dog = q[:, hs].to(f32), k[:, g].to(f32), v[:, g].to(f32), dout[:, hs].to(f32)
        l2 = lse2[:, hs, :, None]
        p = torch.exp2(torch.einsum("brqd,bkd->brqk", qg, kg) * (scale * _LOG2E) - l2)
        p = torch.where(valid, p, torch.where(dead[:, None], torch.exp2(-l2), 0.0))
        dp = torch.einsum("brqd,bkd->brqk", dog, vg)
        ds = rounded(torch.where(valid, p * (dp - delta[:, hs, :, None]), 0.0))
        p = rounded(p)
        dq[:, hs] = torch.einsum("brqk,bkd->brqd", ds, kg) * scale
        dk[:, g] = torch.einsum("brqk,brqd->bkd", ds, qg) * scale
        dv[:, g] = torch.einsum("brqk,brqd->bkd", p, dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
    acc = _acc_dtype(x.dtype)
    x32, dt32, b32, c32 = x.to(acc), dt.to(acc), b.to(acc), c.to(acc)
    state = torch.zeros((bsz, h, n, p), dtype=acc, device=x.device)
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
    [Q, Q, H] decay and weight blocks); state math stays f32 (f64, and the
    compute dtype too, for f64 inputs).
    """
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    nc = s // chunk
    acc = _acc_dtype(x.dtype)
    cd = compute_dtype if acc == torch.float32 else acc
    xc = x.reshape(bsz, nc, chunk, h, p).to(cd)
    dtc = dt.reshape(bsz, nc, chunk, h).to(acc)
    bc = b.reshape(bsz, nc, chunk, n).to(cd)
    cc = c.reshape(bsz, nc, chunk, n).to(cd)

    # cumulative log-decay within each chunk: l[t] = sum_{u<=t} dt_u * a
    cum = torch.cumsum(dtc * a[None, None, None, :], dim=2)          # [B,nc,Q,H]
    total = cum[:, :, -1]                                            # [B,nc,H]

    # intra-chunk: y[t] = sum_{u<=t} c_t·b_u exp(cum[t]-cum[u]) dt_u x_u
    scores = torch.einsum("bkin,bkjn->bkij", cc.to(acc), bc.to(acc))  # [B,nc,Q,Q]
    decay = torch.exp(torch.clamp(cum[:, :, :, None, :] - cum[:, :, None, :, :],
                                  -60.0, 0.0)).to(cd)                # [B,nc,Q,Q,H]
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    w = scores.to(cd)[..., None] * decay * causal[None, None, :, :, None]
    wd = w.to(acc) * dtc.to(cd).to(acc)[:, :, None, :, :]
    y_intra = torch.einsum("bkijh,bkjhp->bkihp", wd, xc.to(acc))

    # chunk states: S_k = sum_u exp(total - cum[u]) dt_u (b_u ⊗ x_u)
    dec_state = torch.exp(torch.clamp(total[:, :, None] - cum, -60.0, 0.0))
    xw = xc.to(acc) * (dec_state * dtc)[..., None]
    s_chunk = torch.einsum("bkjn,bkjhp->bkhnp", bc.to(acc), xw)

    # inter-chunk scan: the state before each chunk, carried with exp(total)
    carry = torch.zeros((bsz, h, n, p), dtype=acc, device=x.device)
    prev = []
    for k in range(nc):
        prev.append(carry)
        carry = carry * torch.exp(torch.clamp(total[:, k], -60.0, 0.0))[..., None, None] \
            + s_chunk[:, k]
    prev_states = torch.stack(prev, dim=1)                           # [B,nc,H,N,P]

    # inter-chunk contribution: y[t] = exp(cum[t]) c_t · S_prev
    y_inter = torch.einsum("bkin,bkhnp->bkihp", cc.to(acc), prev_states) \
        * torch.exp(torch.clamp(cum, -60.0, 0.0))[..., None]
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    if d_skip is not None:
        y = y + x.to(acc) * d_skip[None, None, :, None]
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


def ssd_scan_bwd_ref(x, dt, a, b, c, d_skip, dy, chunk: int = 64):
    """Gradients of the chunked SSD scan (:func:`ssd_chunked_ref`) with
    respect to x, dt, a, b, c and d_skip, in closed form, in f32.

    The forward saves nothing: the state before each chunk is recomputed,
    then the state's gradient R is carried in reverse across the chunks.
    With cum the within-chunk prefix sum of dt·a, T its last entry,
    L_ij = exp(clip(cum_i - cum_j, -60, 0)) for j <= i, G = C Bᵀ and
    w_j = exp(clip(T - cum_j, -60, 0)) dt_j, one chunk is

        y_i = Σ_j G_ij L_ij dt_j x_j + exp(clip(cum_i)) c_i · H + D x_i,
        H' = exp(clip(T)) H + Σ_j w_j b_j ⊗ x_j,

    and each exp(clip(v)) passes a gradient only where the clip is not
    active (v >= -60), as ``jax.grad`` of the reference's ``jnp.clip``
    does.  (The clip's upper end is reached only on a difference of one
    value with itself, whose two gradients cancel: they are left out.)
    S need not be a multiple of ``chunk``: the last chunk is padded with
    no-op rows (dt = 0, x = b = c = 0), as the kernel pads it.  b and c are
    shared by the H heads, so db and dc sum over them; da and dd sum over B
    and S.  In f32 (f64 for f64 inputs).  Returns (dx, ddt, da, db, dc, dd)
    in the dtypes of the inputs (dd None without ``d_skip``)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc = -(-s // chunk)
    pad = nc * chunk - s
    q = chunk
    f32 = _acc_dtype(x.dtype)

    def chunks(t, *tail):
        return F.pad(t.to(f32), (0, 0) * len(tail) + (0, pad)).reshape(bsz, nc, q, *tail)

    xc, dyc = chunks(x, h, p), chunks(dy, h, p)
    bc, cc = chunks(b, n), chunks(c, n)
    dtc = F.pad(dt.to(f32), (0, 0, 0, pad)).reshape(bsz, nc, q, h)
    af = a.to(f32)

    cum = torch.cumsum(dtc * af, dim=2)                               # [B,nc,Q,H]
    total = cum[:, :, -1]                                             # [B,nc,H]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]              # [B,nc,Qi,Qj,H]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    lower = tri[None, None, :, :, None]
    strict = (~torch.eye(q, dtype=torch.bool, device=x.device))[None, None, :, :, None]
    ell = torch.where(lower, torch.exp(diff.clamp(-60.0, 0.0)), torch.zeros_like(diff))
    act_ell = lower & strict & (diff >= -60.0)
    g = torch.einsum("bkin,bkjn->bkij", cc, bc)                       # [B,nc,Qi,Qj]
    gap = total[:, :, None] - cum
    e_w = torch.exp(gap.clamp(-60.0, 0.0))                            # [B,nc,Q,H]
    w = e_w * dtc
    e_t = torch.exp(total.clamp(-60.0, 0.0))                          # [B,nc,H]
    e_in = torch.exp(cum.clamp(-60.0, 0.0))                           # [B,nc,Q,H]

    # the state before each chunk, recomputed as the forward carries it
    s_chunk = torch.einsum("bkjn,bkjhp->bkhnp", bc, xc * w[..., None])
    carry = torch.zeros((bsz, h, n, p), dtype=f32, device=x.device)
    states = []
    for k in range(nc):
        states.append(carry)
        carry = carry * e_t[:, k, :, None, None] + s_chunk[:, k]
    states = torch.stack(states, 1)                                   # [B,nc,H,N,P]

    # the inter-chunk term y_i += e_i c_i · H
    dye = dyc * e_in[..., None]
    ch = torch.einsum("bkin,bkhnp->bkihp", cc, states)
    dcum = torch.where(cum >= -60.0, e_in * (ch * dyc).sum(-1), torch.zeros_like(cum))
    dc = torch.einsum("bkhnp,bkihp->bkin", states, dye)
    dh_inter = torch.einsum("bkin,bkihp->bkhnp", cc, dye)

    # the state's gradient, carried in reverse: dS_k = R, the gradient of H_{k+1}
    r = torch.zeros_like(carry)
    d_state, d_total = [None] * nc, [None] * nc
    for k in reversed(range(nc)):
        d_state[k] = r
        d_total[k] = torch.where(total[:, k] >= -60.0,
                                 e_t[:, k] * (states[:, k] * r).sum((-1, -2)),
                                 torch.zeros_like(total[:, k]))
        r = dh_inter[:, k] + e_t[:, k, :, None, None] * r
    d_state = torch.stack(d_state, 1)                                 # [B,nc,H,N,P]
    d_total = torch.stack(d_total, 1)                                 # [B,nc,H]

    # the chunk's state update Σ_j w_j b_j ⊗ x_j
    rx = torch.einsum("bkhnp,bkjhp->bkjhn", d_state, xc)               # [B,nc,Q,H,N]
    db = torch.einsum("bkjhn,bkjh->bkjn", rx, w)
    dx = torch.einsum("bkhnp,bkjn->bkjhp", d_state, bc) * w[..., None]
    dsw = torch.einsum("bkjhn,bkjn->bkjh", rx, bc)                     # dL / dw_j
    ddt = e_w * dsw
    d_gap = torch.where(gap >= -60.0, w * dsw, torch.zeros_like(gap))
    d_total = d_total + d_gap.sum(2)
    dcum = dcum - d_gap

    # the intra-chunk term y_i += Σ_j G_ij L_ij dt_j x_j
    dm = torch.einsum("bkihp,bkjhp->bkijh", dyc, xc)                  # [B,nc,Qi,Qj,H]
    wgt = g[..., None] * ell                                          # G_ij L_ij
    dx = dx + torch.einsum("bkijh,bkihp->bkjhp", wgt * dtc[:, :, None], dyc)
    dg = (dm * ell * dtc[:, :, None]).sum(-1)                         # over the heads
    dc = dc + torch.einsum("bkij,bkjn->bkin", dg, bc)
    db = db + torch.einsum("bkij,bkin->bkjn", dg, cc)
    ddt = ddt + (dm * wgt).sum(2)
    dl = torch.where(act_ell, dm * wgt * dtc[:, :, None], torch.zeros_like(dm))
    dcum = dcum + dl.sum(3) - dl.sum(2)

    dd = None
    if d_skip is not None:
        dx = dx + dyc * d_skip.to(f32)[:, None]
        dd = (dyc * xc).sum((0, 1, 2, 4))

    # cum_i = Σ_{u<=i} dt_u a, and T = cum_{Q-1}
    dcum[:, :, -1] += d_total
    suffix = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    ddt = ddt + suffix * af
    da = (suffix * dtc).sum((0, 1, 2))

    def unchunk(t, like):
        return t.reshape(bsz, nc * q, *t.shape[3:])[:, :s].to(like.dtype)

    return (unchunk(dx, x), unchunk(ddt, dt), da.to(a.dtype), unchunk(db, b), unchunk(dc, c),
            None if dd is None else dd.to(d_skip.dtype))


def ssd_scan_bwd_mma_ref(x, dt, a, b, c, d_skip, dy, chunk: int = 64):
    """The bf16 ssd_scan backward kernels' own arithmetic: the closed form
    of :func:`ssd_scan_bwd_ref` in the kernels' chunk-parallel
    decomposition, with exponents in base 2 (as :func:`ssd_scan_mma_ref`)
    and, for bf16 inputs, values rounded to bf16 exactly where the kernels
    feed them to their tensor-core products, every sum in f32.  Used by the
    tests and ``chip_smoke.py`` only.

    First the states, as the states kernel carries them in f32: H_k, the
    state before chunk k (H_0 = 0, H_{k+1} = exp(clip(T_k)) H_k + Σ_j
    rnd(b_j w_j) ⊗ x_j), and R_k, the gradient of H_{k+1} (R_{nc-1} = 0,
    R_{k-1} = exp(clip(T_k)) R_k + Σ_i rnd(c_i e_i) ⊗ dy_i).  Then each
    chunk's gradients from rnd(H_k) and rnd(R_k) and the rounded factors
    rnd(G∘L) (for dx), rnd(dM∘L) (db) and rnd(dM∘L∘dt) (dc); L, the clip
    masks, dw, dl's row and column sums, <H_k, R_k> (unrounded), d(cum)
    and its prefix sum's reverse stay f32.  dx, db and dc are rounded once
    at the end (db and dc after their sum over the heads).  With f32 inputs
    nothing is rounded (and f64 inputs are taken in f64).  Returns (dx,
    ddt, da, db, dc, dd) as :func:`ssd_scan_bwd_ref`."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = chunk
    nc = -(-s // q)
    pad = nc * q - s
    f32 = _acc_dtype(x.dtype)
    if x.dtype == torch.bfloat16:
        def rounded(t):
            return t.to(torch.bfloat16).float()
    else:
        def rounded(t):
            return t
    clip2 = -60.0 * _LOG2E

    def clip_exp2(v):
        return torch.exp2(v.clamp(clip2, 0.0))

    def chunks(t, *tail):
        return F.pad(t.to(f32), (0, 0) * len(tail) + (0, pad)).reshape(bsz, nc, q, *tail)

    xc, dyc = chunks(x, h, p), chunks(dy, h, p)
    bc, cc = chunks(b, n), chunks(c, n)
    dtc = F.pad(dt.to(f32), (0, 0, 0, pad)).reshape(bsz, nc, q, h)
    af = a.to(f32)
    cum = torch.cumsum(dtc * (af * _LOG2E), dim=2)                    # [B,nc,Q,H], base 2
    total = cum[:, :, -1]                                             # [B,nc,H]
    e_in, e_t = clip_exp2(cum), clip_exp2(total)
    gap = total[:, :, None] - cum
    e_w = clip_exp2(gap)
    w = e_w * dtc

    # the states kernel: H_k forward and R_k in reverse, carried in f32
    s_loc = torch.einsum("bkjnh,bkjhp->bkhnp", rounded(bc[..., None] * w[:, :, :, None]), xc)
    r_loc = torch.einsum("bkinh,bkihp->bkhnp", rounded(cc[..., None] * e_in[:, :, :, None]),
                         dyc)
    zero = torch.zeros((bsz, h, n, p), dtype=f32, device=x.device)
    hs, rs = [], [None] * nc
    carry = zero
    for k in range(nc):
        hs.append(carry)
        carry = carry * e_t[:, k, :, None, None] + s_loc[:, k]
    carry = zero
    for k in reversed(range(nc)):
        rs[k] = carry
        carry = carry * e_t[:, k, :, None, None] + r_loc[:, k]
    hst, rst = torch.stack(hs, 1), torch.stack(rs, 1)                 # [B,nc,H,N,P]
    hb, rb = rounded(hst), rounded(rst)

    # the chunk kernel
    g = torch.einsum("bkin,bkjn->bkij", cc, bc)                       # [B,nc,Qi,Qj]
    dm = torch.einsum("bkihp,bkjhp->bkijh", dyc, xc)                  # [B,nc,Qi,Qj,H]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))[None, None, :, :, None]
    strict = ~torch.eye(q, dtype=torch.bool, device=x.device)[None, None, :, :, None]
    ell = torch.where(tri, clip_exp2(diff), 0.0)
    wgt = g[..., None] * ell                                          # G∘L
    mlf = dm * ell                                                    # dM∘L
    dw = (dm * wgt).sum(2)                                            # [B,nc,Qj,H]
    dl = torch.where(tri & strict & (diff >= clip2), dm * wgt * dtc[:, :, None], 0.0)
    dc = (torch.einsum("bkihp,bkhnp->bkihn", dyc, hb) * e_in[..., None]
          + torch.einsum("bkijh,bkjn->bkihn", rounded(mlf * dtc[:, :, None]), bc))
    ch = torch.einsum("bkin,bkhnp->bkihp", cc, hb)
    d_inter = torch.where(cum >= clip2, e_in * (ch * dyc).sum(-1), 0.0)
    rx = torch.einsum("bkjhp,bkhnp->bkjhn", xc, rb)                   # X·Rᵀ
    dsw = torch.einsum("bkjhn,bkjn->bkjh", rx, bc)
    db = dtc[..., None] * (e_w[..., None] * rx
                           + torch.einsum("bkijh,bkin->bkjhn", rounded(mlf), cc))
    dx = dtc[..., None] * (e_w[..., None] * torch.einsum("bkjn,bkhnp->bkjhp", bc, rb)
                           + torch.einsum("bkijh,bkihp->bkjhp", rounded(wgt), dyc))
    dd = None
    if d_skip is not None:
        dx = dx + dyc * d_skip.to(f32)[:, None]
        dd = (dyc * xc).sum((0, 1, 2, 4))
    d_gap = torch.where(gap >= clip2, w * dsw, 0.0)
    d_total = (torch.where(total >= clip2, e_t * (hst * rst).sum((-1, -2)), 0.0)
               + d_gap.sum(2))
    dcum = d_inter + dl.sum(3) - dl.sum(2) - d_gap
    dcum[:, :, -1] += d_total
    suffix = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    ddt = e_w * dsw + dw + suffix * af
    da = (suffix * dtc).sum((0, 1, 2))

    def unchunk(t, like):
        return t.reshape(bsz, nc * q, *t.shape[3:])[:, :s].to(like.dtype)

    return (unchunk(dx, x), unchunk(ddt, dt), da.to(a.dtype), unchunk(db.sum(3), b),
            unchunk(dc.sum(3), c), None if dd is None else dd.to(d_skip.dtype))


def rope_freqs(head_dim: int, theta: float, device=None):
    """The ``[Dh / 2]`` f32 RoPE frequencies ``theta ** (-2i / Dh)``."""
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    # theta filled on the device: a copy from the host would wait for it
    return torch.pow(torch.full((), theta, dtype=torch.float32, device=device), exps)


def rope_ref(x, pos0: int, theta: float, inverse: bool = False):
    """Rotate-half RoPE of ``x`` [..., S, Dh] at positions ``pos0`` ..
    ``pos0 + S - 1``: the reference's ``apply_rope`` expression over
    ``arange(pos0, pos0 + S)``, in f32 (f64 for f64), rounded once to x's
    dtype.  ``inverse`` negates the sines (an exact change): the rotation
    by the negated angles, which is the rotation's gradient."""
    positions = torch.arange(pos0, pos0 + x.shape[-2], device=x.device)
    angles = positions[..., None].float() * rope_freqs(x.shape[-1], theta, x.device)
    cos, sin = torch.cos(angles), torch.sin(angles)
    if inverse:
        sin = -sin
    x1, x2 = _wide(x).chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def moe_experts_ref(xs, ends, w_gate, w_up, w_down):
    """The plain version of the grouped expert products
    (``kernels/moe_experts.py``): a loop over the experts, each expert's
    SwiGLU on its segment of ``xs`` [rows, d] (rows sorted by expert,
    segment ``e`` ending at ``ends[e]``), SiLU in f32 and cast back.
    Returns [rows, d]."""
    outs, start = [], 0
    for e, end in enumerate(ends.tolist()):
        seg = xs[start:end]
        g = F.silu((seg @ w_gate[e]).to(torch.promote_types(seg.dtype, torch.float32)))
        outs.append((g.to(seg.dtype) * (seg @ w_up[e])) @ w_down[e])
        start = end
    return torch.cat(outs)
