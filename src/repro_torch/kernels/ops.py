"""Device dispatch for the port's kernels.

The tensor's device picks the path: a CUDA tensor launches the hand-written
kernel (and raises if it cannot), a CPU or meta tensor takes the plain
PyTorch version in ``kernels.ref``, anything else raises.  There is no
fallback from one to the other.  A ``DTensor`` on the card reaches a
kernel wrapper, which refuses it (``_build.check_tensor``).  The zoo's three
kernels on a meta or CPU ``DTensor`` (the dry-run's, ``launch.steps``) run
*shard-local*, as each card of a mesh would run its kernel on its own
shard: the inputs are redistributed so that only their batch and head
dimensions are sharded, alike for all of them, and the plain version runs
once over global-shape stand-ins (``dist.sharding.shard_local``), so that
its count is the one-device count and its output carries the first input's
layout.

Gradients: the three graph aggregations go through
``torch.autograd.Function``s (``csr_spmm.CsrSpmm``,
``csr_spmm.CsrSpmmEtypeMean``, ``edge_softmax.EdgeSoftmaxAgg``) when a
gradient is wanted.  Their backward sums into source rows over the graph's
reverse-slot index ``rev`` (``PaddedGraph.rev``) in a fixed order: a kernel
on the card, the closed forms of ``kernels.ref`` on the CPU, so two
backward passes give the same bits at any thread count.  On the CPU a
missing ``rev`` is built from the slots; on the card it must be given.  A
CPU call that also wants a gradient for the graph's weights or mask takes
ordinary autograd of the plain version, whose gather adds with atomics
above one intra-op thread (not bit-reproducible); the card refuses one.
The two zoo kernels of training, ``flash_attention`` and ``ssd_scan``,
take their ``torch.autograd.Function``s (``flash_attention.FlashAttention``,
``ssd_scan.SsdScan``) on either device when a gradient is wanted: forward
as without grad (the kernel also saving the attention's row logsumexp),
backward a kernel on the card and the closed forms of ``kernels.ref`` on
the CPU, each in a fixed order.  ``gqa_decode`` (decode only) and
``stage2_score`` (serving) have no backward: on the card they raise
(:func:`refuse_grad`) rather than return a tensor that autograd cannot
differentiate.  ``moe_experts`` (the dropless MoE's expert products) is
PyTorch's grouped GEMM on the card and a loop over the experts elsewhere,
both differentiable by autograd.  ``rope`` takes its Function
(``rope.Rope``) on either device when a gradient is wanted: the backward is
the rotation by the negated angles, the same kernel on the card, the plain
version on the CPU; a ``DTensor`` off the card takes the plain version,
differentiated by autograd.
"""
from __future__ import annotations

import torch

from repro_torch.dist.sharding import is_dtensor, shard_local
from repro_torch.kernels import ref
from repro_torch.kernels.csr_spmm import (csr_spmm_autograd, csr_spmm_cuda,
                                          csr_spmm_etype_mean_autograd,
                                          csr_spmm_etype_mean_cuda)
from repro_torch.kernels.edge_softmax import edge_softmax_agg_autograd, edge_softmax_agg_cuda
from repro_torch.kernels.flash_attention import (FlashAttention, flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.gqa_decode import gqa_decode_cuda
from repro_torch.kernels.moe_experts import moe_experts_cuda
from repro_torch.kernels.rope import Rope, rope_cuda
from repro_torch.kernels.ssd_scan import SsdScan, ssd_scan_cuda, ssd_scan_plain
from repro_torch.kernels.stage2_score import (flatten_stage2_params, pack_stage2_params,
                                              stage2_score_cuda, unpack_stage2_pack)
from repro_torch.params import tree_leaves


def _on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU or meta one; raise for any
    other.  A meta tensor has no values, so taking the plain version there
    hides nothing: it is how the dry-run (``launch.dryrun``) traces a step
    at full size, as the reference's dry-run traces its XLA path."""
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"no kernel path for tensors on {t.device}: use cuda, cpu or meta")


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise if autograd would want a gradient through ``kernel``, which has
    no backward: grad mode is on and a floating tensor among ``tensors``
    requires grad.  Costs nothing under ``torch.no_grad()``."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.is_floating_point() and t.requires_grad
            for t in tensors):
        raise RuntimeError(f"{kernel} has no backward kernel: call it under torch.no_grad() "
                           "or on tensors that do not require grad")


def csr_spmm(h, nbr_idx, weights, rev=None):
    """out[i] = sum_d weights[i, d] * h[nbr_idx[i, d]].  ``rev``: the graph's
    reverse-slot index, which a gradient on the card needs."""
    cuda = _on_cuda(h)
    if _wants_grad(h, weights) and (cuda or not weights.requires_grad):
        return csr_spmm_autograd(h, nbr_idx, weights, rev, cuda)
    if cuda:
        return csr_spmm_cuda(h, nbr_idx, weights)
    return ref.csr_spmm_ref(h, nbr_idx, weights)


def csr_spmm_etype_mean(h, nbr_idx, nbr_mask, nbr_etype, num_types: int, rev=None):
    """out[e, i] = the mean of h over i's neighbours of edge type e (masked
    by ``nbr_mask``, divided by the mask's sum for that type, at least 1):
    [num_types, N, H], one launch on the card.  ``rev`` as for
    :func:`csr_spmm`."""
    cuda = _on_cuda(h)
    if _wants_grad(h, nbr_mask) and (cuda or not nbr_mask.requires_grad):
        return csr_spmm_etype_mean_autograd(h, nbr_idx, nbr_mask, nbr_etype, num_types, rev,
                                            cuda)
    if cuda:
        return csr_spmm_etype_mean_cuda(h, nbr_idx, nbr_mask, nbr_etype, num_types)
    return ref.csr_spmm_etype_mean_ref(h, nbr_idx, nbr_mask, nbr_etype, num_types)


def edge_softmax_agg(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias, rev=None):
    """GAT masked neighbour softmax + weighted aggregation.  ``rev`` as for
    :func:`csr_spmm`."""
    cuda = _on_cuda(z)
    if (_wants_grad(z, s_src, s_dst, nbr_mask, etype_bias)
            and (cuda or not nbr_mask.requires_grad)):
        return edge_softmax_agg_autograd(z, s_src, s_dst, nbr_idx, nbr_mask, etype_bias, rev,
                                         cuda)
    if cuda:
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
        if torch.is_grad_enabled():          # the tree is walked only where grad is on
            refuse_grad("stage2_score", entity_emb, emb_mask, order_feats,
                        *tree_leaves(params))
        if pack is None:
            pack = pack_stage2_params(flatten_stage2_params(params, gnn_type), gnn_type, typed)
        return stage2_score_cuda(entity_emb, emb_mask, order_feats, pack, slot_type)
    flat = unpack_stage2_pack(pack) if pack is not None else flatten_stage2_params(params, gnn_type)
    return ref.stage2_score_ref(entity_emb, emb_mask, order_feats, flat,
                                gnn_type=gnn_type, slot_type=slot_type)


def flash_attention(q, k, v, causal: bool = True, window: int | None = None,
                    scale: float | None = None):
    """Prefill attention.  q: [B, Hq, Sq, Dh]; k/v: [B, Hkv, Sk, Dh]; q rows
    aligned to the end of the keys; the logits scaled by ``scale`` (default
    ``Dh ** -0.5``).  The plain version is the reference's XLA path
    (``blockwise_attention`` over key blocks of min(512, Sk)).  Under grad:
    ``FlashAttention`` (the backward kernel on the card)."""
    cuda = _on_cuda(q)
    if not cuda and is_dtensor(q):
        return shard_local(lambda *t: flash_attention(*t, causal, window, scale), (q, k, v),
                           ((0, 1),) * 3)
    if _wants_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, cuda, scale)
    if cuda:
        return flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale)
    return flash_attention_plain(q, k, v, causal, window, scale)


def gqa_decode(q, k, v, kv_len=None, window: int | None = None, scale: float | None = None):
    """One-token attention over the cache.  q: [B, Hq, Dh]; k/v:
    [B, Hkv, S, Dh]; kv_len: [B] int32 valid lengths (None: all S); the
    logits scaled by ``scale`` (default ``Dh ** -0.5``)."""
    if _on_cuda(q):
        refuse_grad("gqa_decode", q, k, v)
        return gqa_decode_cuda(q, k, v, kv_len=kv_len, window=window, scale=scale)
    if is_dtensor(q):
        return shard_local(lambda *t: gqa_decode(*t, window=window, scale=scale),
                           (q, k, v, kv_len), ((0, 1), (0, 1), (0, 1), (0, None)))
    return ref.gqa_decode_ref(q, k, v, kv_len=kv_len, window=window, scale=scale)


def moe_experts(xs, ends, w_gate, w_up, w_down):
    """The MoE's expert SwiGLUs over tokens sorted by expert: ``xs``
    [rows, d], ``ends`` [E] int32 (each expert's segment end), weights
    [E, d, f], [E, d, f], [E, f, d].  Returns [rows, d].  On the card three
    grouped GEMMs (``moe_experts.moe_experts_cuda``), elsewhere a loop over
    the experts (``ref.moe_experts_ref``)."""
    if _on_cuda(xs):
        return moe_experts_cuda(xs, ends, w_gate, w_up, w_down)
    return ref.moe_experts_ref(xs, ends, w_gate, w_up, w_down)


def ssd_scan(x, dt, a, b, c, d_skip=None, chunk: int = 64,
             compute_dtype=torch.float32):
    """Mamba2 SSD scan.  x: [B, S, H, P]; dt: [B, S, H]; a: [H]; b/c:
    [B, S, N]; d_skip: [H] or None.  Returns y [B, S, H, P] in x's dtype.

    The CUDA kernel takes any S (its own chunk of 64).  On the CPU the
    choice is the reference's XLA path (``models/mamba.py`` with
    ``use_pallas=False``): the chunked form at ``chunk`` where it divides S
    (a whole sequence shorter than 64 is one chunk), else the sequential
    recurrence; ``compute_dtype`` is the chunked form's intra-chunk dtype.
    Under grad: ``SsdScan`` (the backward kernel on the card).
    """
    cuda = _on_cuda(x)
    if not cuda and is_dtensor(x):
        return shard_local(lambda *t: ssd_scan(*t, chunk=chunk, compute_dtype=compute_dtype),
                           (x, dt, a, b, c, d_skip),
                           ((0, 2), (0, 2), (None, 0), (0, None), (0, None), (None, 0)))
    if _wants_grad(*(t for t in (x, dt, a, b, c, d_skip) if t is not None)):
        return SsdScan.apply(x, dt, a, b, c, d_skip, chunk, compute_dtype, cuda)
    if cuda:
        return ssd_scan_cuda(x, dt, a, b, c, d_skip)
    return ssd_scan_plain(x, dt, a, b, c, d_skip, chunk, compute_dtype)


def rope(x, pos0: int, theta: float):
    """Rotate-half RoPE of ``x`` [B, H, S, Dh] (the projection's transposed
    view is read as it is) at positions ``pos0`` .. ``pos0 + S - 1``
    (``pos0`` a Python int: 0 in prefill, the position in decode).  Returns
    a contiguous [B, H, S, Dh] in x's dtype.  On the card one launch
    (``rope.rope_cuda``), elsewhere ``ref.rope_ref``; under grad ``Rope``."""
    cuda = _on_cuda(x)
    if not cuda and is_dtensor(x):
        return ref.rope_ref(x, pos0, theta)
    if _wants_grad(x):
        return Rope.apply(x, pos0, theta, cuda)
    if cuda:
        return rope_cuda(x, pos0, theta)
    return ref.rope_ref(x, pos0, theta)
