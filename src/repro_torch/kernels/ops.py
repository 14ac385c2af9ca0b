"""Device dispatch for the port's kernels.

The tensor's device picks the path: a CUDA tensor launches the hand-written
kernel (and raises if it cannot), a CPU tensor takes the plain PyTorch
version in ``kernels.ref``, anything else raises.  There is no fallback from
one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.csr_spmm import csr_spmm_cuda, csr_spmm_etype_mean_cuda
from repro_torch.kernels.edge_softmax import edge_softmax_agg_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.gqa_decode import gqa_decode_cuda
from repro_torch.kernels.ssd_scan import ssd_scan_cuda
from repro_torch.kernels.stage2_score import (flatten_stage2_params, pack_stage2_params,
                                              stage2_score_cuda, unpack_stage2_pack)
from repro_torch.models.common import blockwise_attention


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


def csr_spmm_etype_mean(h, nbr_idx, nbr_mask, nbr_etype, num_types: int):
    """out[e, i] = the mean of h over i's neighbours of edge type e (masked
    by ``nbr_mask``, divided by the mask's sum for that type, at least 1):
    [num_types, N, H], one launch on the card."""
    if _on_cuda(h):
        return csr_spmm_etype_mean_cuda(h, nbr_idx, nbr_mask, nbr_etype, num_types)
    return ref.csr_spmm_etype_mean_ref(h, nbr_idx, nbr_mask, nbr_etype, num_types)


def edge_softmax_agg(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias):
    """GAT masked neighbour softmax + weighted aggregation."""
    if _on_cuda(z):
        return edge_softmax_agg_cuda(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias)
    return ref.edge_softmax_agg_ref(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias)


def stage2_score(params, gnn_type, entity_emb, emb_mask, order_feats,
                 slot_type=None, pack=None):
    """Whole online stage 2 for a micro-batch: logits [B].

    Takes the full ``lnn_init`` tree.  Heterogeneous params (``"typed"`` in
    the tree) select the typed variant: ``slot_type`` is the int32 ``[B, K]``
    entity-type code per slot (-1 = padding/untyped; all -1 when omitted).
    ``pack`` is the tree's :func:`pack_stage2_params` buffer, built once by
    a caller that scores many batches; without it the weights are packed
    (on the card) or flattened (on the host) for this call.
    """
    typed = "typed" in params
    if pack is not None and (pack.gnn_type, pack.typed) != (gnn_type, typed):
        raise ValueError(f"the pack holds {pack.gnn_type} weights (typed={pack.typed}), "
                         f"not {gnn_type} (typed={typed})")
    if not typed:
        slot_type = None
    elif slot_type is None:
        slot_type = torch.full(emb_mask.shape, -1, dtype=torch.int32,
                               device=emb_mask.device)
    if _on_cuda(entity_emb):
        if pack is None:
            pack = pack_stage2_params(flatten_stage2_params(params, gnn_type), gnn_type, typed)
        return stage2_score_cuda(entity_emb, emb_mask, order_feats, pack, slot_type)
    flat = unpack_stage2_pack(pack) if pack is not None else flatten_stage2_params(params, gnn_type)
    return ref.stage2_score_ref(entity_emb, emb_mask, order_feats, flat,
                                gnn_type=gnn_type, slot_type=slot_type)


def flash_attention(q, k, v, causal: bool = True, window: int | None = None):
    """Prefill attention.  q: [B, Hq, Sq, Dh]; k/v: [B, Hkv, Sk, Dh]; q rows
    aligned to the end of the keys.  The plain version is the reference's
    XLA path (``blockwise_attention`` over key blocks of min(512, Sk))."""
    if _on_cuda(q):
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    return blockwise_attention(q, k, v, causal=causal, window=window,
                               block_k=min(512, k.shape[2]))


def gqa_decode(q, k, v, kv_len=None, window: int | None = None):
    """One-token attention over the cache.  q: [B, Hq, Dh]; k/v:
    [B, Hkv, S, Dh]; kv_len: [B] int32 valid lengths (None: all S)."""
    if _on_cuda(q):
        return gqa_decode_cuda(q, k, v, kv_len=kv_len, window=window)
    return ref.gqa_decode_ref(q, k, v, kv_len=kv_len, window=window)


def ssd_scan(x, dt, a, b, c, d_skip=None, chunk: int = 64,
             compute_dtype=torch.float32):
    """Mamba2 SSD scan.  x: [B, S, H, P]; dt: [B, S, H]; a: [H]; b/c:
    [B, S, N]; d_skip: [H] or None.  Returns y [B, S, H, P] in x's dtype.

    The CUDA kernel takes any S (its own chunk of 64).  On the CPU the
    choice is the reference's XLA path (``models/mamba.py`` with
    ``use_pallas=False``): the chunked form at ``chunk`` where it divides S
    (a whole sequence shorter than 64 is one chunk), else the sequential
    recurrence; ``compute_dtype`` is the chunked form's intra-chunk dtype.
    """
    if _on_cuda(x):
        return ssd_scan_cuda(x, dt, a, b, c, d_skip)
    s = x.shape[1]
    if s % chunk:
        chunk = s if s < 64 else 1
    if chunk > 1:
        return ref.ssd_chunked_ref(x, dt, a, b, c, d_skip, chunk=chunk,
                                   compute_dtype=compute_dtype)
    return ref.ssd_scan_ref(x, dt, a, b, c, d_skip)
