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


def csr_spmm_ref(h, nbr_idx, weights):
    """out[i] = sum_d weights[i, d] * h[nbr_idx[i, d]], accumulated in f32.

    h: [N, H]; nbr_idx: [N, D] int32; weights: [N, D].  Returns h's dtype."""
    msgs = h[nbr_idx.long()].float()                       # [N, D, H]
    out = torch.einsum("ndh,nd->nh", msgs, weights.float())
    return out.to(h.dtype)


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
