"""Device dispatch for the port's kernels.

The tensor's device picks the path: a CUDA tensor launches the hand-written
kernel (and raises if it cannot), a CPU tensor takes the plain PyTorch
version in ``kernels.ref``, anything else raises.  There is no fallback from
one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.csr_spmm import csr_spmm_cuda
from repro_torch.kernels.edge_softmax import edge_softmax_agg_cuda
from repro_torch.kernels.stage2_score import flatten_stage2_params, stage2_score_cuda


def _on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raise for any other."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel path for tensors on {t.device}: use cuda or cpu")


def csr_spmm(h, nbr_idx, weights):
    """out[i] = sum_d weights[i, d] * h[nbr_idx[i, d]]."""
    if _on_cuda(h):
        return csr_spmm_cuda(h, nbr_idx, weights)
    return ref.csr_spmm_ref(h, nbr_idx, weights)


def edge_softmax_agg(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias):
    """GAT masked neighbour softmax + weighted aggregation."""
    if _on_cuda(z):
        return edge_softmax_agg_cuda(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias)
    return ref.edge_softmax_agg_ref(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias)


def stage2_score(params, gnn_type, entity_emb, emb_mask, order_feats,
                 slot_type=None):
    """Whole online stage 2 for a micro-batch: logits [B].

    Takes the full ``lnn_init`` tree.  Heterogeneous params (``"typed"`` in
    the tree) select the typed variant: ``slot_type`` is the int32 ``[B, K]``
    entity-type code per slot (-1 = padding/untyped; all -1 when omitted).
    """
    typed = "typed" in params
    flat = flatten_stage2_params(params, gnn_type)
    if not typed:
        slot_type = None
    elif slot_type is None:
        slot_type = torch.full(emb_mask.shape, -1, dtype=torch.int32,
                               device=emb_mask.device)
    if _on_cuda(entity_emb):
        return stage2_score_cuda(entity_emb, emb_mask, order_feats, flat,
                                 gnn_type=gnn_type, slot_type=slot_type)
    return ref.stage2_score_ref(entity_emb, emb_mask, order_feats, flat,
                                gnn_type=gnn_type, slot_type=slot_type)
