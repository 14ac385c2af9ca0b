"""Lambda Neural Network (LNN) — paper §3.3.

A deep GNN split in two stages at the ``entity_{t-e}`` cut:

* **stage 1** (batch layer): input projection + all GNN layers except the
  last, run over the whole DDS community graph.  Its output rows for entity
  vertices are the embeddings that production would periodically refresh and
  push to a key-value store.
* **stage 2** (speed layer): the final GNN layer restricted to the
  ``entity_{t-e} -> order_t`` final-hop edges, concatenated with the raw
  order features, followed by an MLP scorer — exactly the computation an
  online checkout approval performs after KV lookups.

``lnn_forward = stage2 ∘ stage1`` end-to-end; the split is exact because
effective orders have *only* final-hop in-edges in a DDS graph.

Parameters are nested dicts of tensors in the reference's layout (``x @ W``
with ``W`` as ``[in, out]``), so a reference tree crosses through
``repro_torch.params.from_numpy`` without transposes.  The device of the
tensors picks the kernel path (see ``kernels.ops``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.core.graph import EdgeType, NodeType, PaddedGraph
from repro_torch.core.layers import LAYER_REGISTRY, _glorot, lookup, weighted_gather_sum
from repro_torch.kernels import ops
from repro_torch.params import tree_map
from repro_torch.utils.device import resolve_device


@dataclass(frozen=True)
class LNNConfig:
    """Hyperparameters of the Lambda Neural Network (see module docstring).

    ``entity_types`` opts into heterogeneous per-type entity towers: a
    non-empty tuple of type names adds a per-type input embedding to stage 1
    and per-type weight blocks to stage 2.  Empty (the default) keeps the
    homogeneous model.
    """

    gnn_type: str = "gcn"            # 'gcn' | 'gat' | 'sage'
    num_gnn_layers: int = 3          # total GNN layers (>= 2: stage1 has L-1)
    hidden_dim: int = 64
    mlp_dims: tuple = (64, 32)
    feat_dim: int = 16               # raw checkout feature width
    pos_weight: float = 1.0          # BCE positive-class weight (fraud is rare)
    entity_types: tuple = ()         # () = homogeneous; e.g. hetero.ENTITY_TYPE_NAMES

    def __post_init__(self):
        if self.num_gnn_layers < 2:
            raise ValueError("LNN needs >= 2 GNN layers (stage1 >= 1, stage2 == 1)")
        if self.gnn_type not in LAYER_REGISTRY:
            raise ValueError(f"unknown gnn_type {self.gnn_type}")
        object.__setattr__(self, "entity_types", tuple(self.entity_types))


def lnn_init(rng: torch.Generator, cfg: LNNConfig, device=None):
    """Initialize an LNN parameter tree for ``cfg`` on ``device`` (default:
    CUDA).

    ``rng`` is a CPU ``torch.Generator``: the draws are made on the host and
    then moved, so one seed gives the same weights on every device.  Key
    paths and shapes are the reference's; the values are not (the reference
    draws from ``jax.random``), so parity tests carry the reference's values
    across with ``params.from_numpy``.
    """
    dev = resolve_device(device)
    init_fn, _ = LAYER_REGISTRY[cfg.gnn_type]
    params = {
        "input": {
            "w": _glorot(rng, (cfg.feat_dim, cfg.hidden_dim)),
            "b": torch.zeros(cfg.hidden_dim),
        },
        # small learned embedding per node type so entities (zero features)
        # are distinguishable from shadows at the input
        "type_emb": 0.02 * torch.randn((4, cfg.hidden_dim), generator=rng),
        "gnn": [init_fn(rng, cfg.hidden_dim, cfg.hidden_dim)
                for _ in range(cfg.num_gnn_layers - 1)],
        "last": init_fn(rng, cfg.hidden_dim, cfg.hidden_dim),
        "mlp": [],
    }
    dims = (cfg.hidden_dim + cfg.feat_dim,) + tuple(cfg.mlp_dims) + (1,)
    for i in range(len(dims) - 1):
        params["mlp"].append({"w": _glorot(rng, (dims[i], dims[i + 1])),
                              "b": torch.zeros(dims[i + 1])})
    n_types = len(cfg.entity_types)
    if n_types:
        params["typed"] = {
            # stage-1 additive input embedding per entity type
            "entity_type_emb": 0.02 * torch.randn((n_types, cfg.hidden_dim),
                                                  generator=rng),
            # stage-2 per-type weight blocks over the KV-fetched embeddings
            "tower_w": torch.stack([_glorot(rng, (cfg.hidden_dim, cfg.hidden_dim))
                                    for _ in range(n_types)]),
            "tower_b": torch.zeros((n_types, cfg.hidden_dim)),
        }
    return tree_map(lambda t: t.to(dev), params)


def _apply_towers(params, x, codes):
    """Per-type entity tower: rows whose type code is ``t`` are replaced by
    ``relu(x @ tower_w[t] + tower_b[t])``; rows with code ``-1`` (orders,
    shadows, untyped entities, padding) pass through unchanged.  Every
    type's tower reads the original ``x``."""
    tw, tb = params["typed"]["tower_w"], params["typed"]["tower_b"]
    out = x
    for t in range(tw.shape[0]):
        out = torch.where((codes == t)[..., None], torch.relu(x @ tw[t] + tb[t]), out)
    return out


# ---------------------------------------------------------------------------
# Stage 1 — batch layer
# ---------------------------------------------------------------------------

def lnn_stage1(params, cfg: LNNConfig, graph: PaddedGraph, mm=torch.matmul):
    """Input proj + first L-1 GNN layers.  Returns hidden states [N, H].

    The final-hop ``entity_{t-e} -> order_t`` edges are *masked out* here:
    they are consumed only by the last (speed-layer) GNN layer, so an
    order's stage-1 state depends only on its own raw features (see
    ``lnn_order_tower``).  ``mm`` takes every dense product over the node
    rows: ``core.layers.row_stable_matmul`` gives a node the same bits at
    any graph size (the streaming refresh passes it).
    """
    _, apply_fn = LAYER_REGISTRY[cfg.gnn_type]
    stage1_graph = graph._replace(
        nbr_mask=graph.nbr_mask * (graph.nbr_etype != EdgeType.ENTITY_TO_ORDER)
    )
    h = mm(graph.features, params["input"]["w"]) + params["input"]["b"]
    h = h + lookup(params["type_emb"], graph.node_type)
    if "typed" in params and graph.tower is not None:
        # typed entity-snapshot vertices additionally receive their
        # per-entity-type embedding (tower < 0 rows add zero)
        emb = params["typed"]["entity_type_emb"]
        h = h + (graph.tower >= 0)[:, None] * lookup(emb, graph.tower.clamp_min(0))
    h = torch.relu(h)
    for layer in params["gnn"]:
        h = apply_fn(layer, h, stage1_graph, mm)
    return h


def lnn_order_tower(params, cfg: LNNConfig, order_feats):
    """Stage-1 state of an *order* node, computed locally from raw features
    (stage 1 masks final-hop edges, so each GNN layer reduces to its
    self-transform for an order)."""
    h = order_feats @ params["input"]["w"] + params["input"]["b"]
    h = h + params["type_emb"][NodeType.ORDER]
    h = torch.relu(h)
    for layer in params["gnn"]:
        h = torch.relu(h @ layer["w_self"] + layer["b"])
    return h


# ---------------------------------------------------------------------------
# Stage 2 — speed layer
# ---------------------------------------------------------------------------

def _last_layer_combine(params, cfg: LNNConfig, agg, self_h):
    """Final GNN layer math shared by the batch and online paths.

    ``agg`` is the (already weighted) neighbor aggregate in *input* space,
    ``self_h`` the node's own hidden state.
    """
    p = params["last"]
    if cfg.gnn_type == "gcn":
        # orders only receive ENTITY_TO_ORDER edges; use that etype's weight
        out = self_h @ p["w_self"] + agg @ p["w_nbr"][EdgeType.ENTITY_TO_ORDER]
    elif cfg.gnn_type == "sage":
        out = self_h @ p["w_self"] + agg @ p["w_nbr"]
    else:  # gat: agg is already in z-space (post-W); self term below
        out = agg + self_h @ p["w_self"]
    return torch.relu(out + p["b"])


def _mlp(params, x):
    for i, layer in enumerate(params["mlp"]):
        x = x @ layer["w"] + layer["b"]
        if i + 1 < len(params["mlp"]):
            x = torch.relu(x)
    return x[..., 0]


def _final_hop_aggregate(params, cfg: LNNConfig, h, graph: PaddedGraph):
    """Neighbor aggregate of the last layer, restricted to final-hop edges."""
    w_fin = graph.nbr_mask * (graph.nbr_etype == EdgeType.ENTITY_TO_ORDER)
    if cfg.gnn_type in ("gcn", "sage"):
        cnt = w_fin.sum(-1, keepdim=True).clamp_min(1.0)
        return weighted_gather_sum(h, graph.nbr_idx, w_fin / cnt, graph.rev)
    # gat: the same masked edge softmax as a GAT layer, over final-hop edges
    p = params["last"]
    z = h @ p["w"]
    return ops.edge_softmax_agg(z, z @ p["a_src"], z @ p["a_dst"], graph.nbr_idx,
                                w_fin, lookup(p["a_et"], graph.nbr_etype), graph.rev)


def lnn_stage2_batch(params, cfg: LNNConfig, h, graph: PaddedGraph):
    """Speed-layer computation over the whole padded graph (training path).

    Returns logits [N]; only rows with node_type == ORDER are meaningful.
    """
    if "typed" in params and graph.tower is not None:
        h = _apply_towers(params, h, graph.tower)
    agg = _final_hop_aggregate(params, cfg, h, graph)
    g_out = _last_layer_combine(params, cfg, agg, h)
    x = torch.cat([g_out, graph.features], dim=-1)
    return _mlp(params, x)


def lnn_stage2_embed(params, cfg: LNNConfig, entity_emb, emb_mask, order_feats,
                     order_h=None, slot_type=None):
    """Online stage-2 *embedding*: the last GNN layer's output concatenated
    with the raw checkout features, ``[B, H + F]`` — everything up to the
    MLP head, unfused, over the parameter tree.  ``slot_type``: optional
    [B, K] int type codes per entity slot (-1 = untyped/padding).
    """
    if order_h is None:
        order_h = lnn_order_tower(params, cfg, order_feats)
    if "typed" in params and slot_type is not None:
        entity_emb = _apply_towers(params, entity_emb, slot_type)
    if cfg.gnn_type in ("gcn", "sage"):
        cnt = emb_mask.sum(-1, keepdim=True).clamp_min(1.0)
        agg = torch.einsum("bkh,bk->bh", entity_emb, emb_mask / cnt)
    else:  # gat
        p = params["last"]
        z = entity_emb @ p["w"]
        logits = z @ p["a_src"] + ((order_h @ p["w"]) @ p["a_dst"])[:, None]
        logits = logits + p["a_et"][EdgeType.ENTITY_TO_ORDER]
        logits = F.leaky_relu(logits, 0.2)
        logits = torch.where(emb_mask > 0, logits, torch.full_like(logits, -1e9))
        attn = torch.softmax(logits, dim=-1) * emb_mask
        agg = torch.einsum("bkh,bk->bh", z, attn)
    g_out = _last_layer_combine(params, cfg, agg, order_h)
    return torch.cat([g_out, order_feats], dim=-1)


def lnn_stage2_online(params, cfg: LNNConfig, entity_emb, emb_mask, order_feats,
                      order_h=None, slot_type=None, *, pack=None):
    """Online scoring path: KV-fetched entity embeddings -> risk logit [B].

    entity_emb: [B, K, H] stage-1 embeddings of the ≤K linked effective
    entities (zero rows where absent); emb_mask: [B, K]; order_feats: [B, F]
    raw checkout features; ``order_h``: [B, H] the order's own stage-1
    state, accepted in the reference's place but not read; ``slot_type``:
    optional [B, K] int32 entity-type codes (heterogeneous models; -1 =
    padding/untyped slot).

    One call of ``kernels.ops.stage2_score``: on CUDA tensors the fused
    kernel (one launch), on CPU tensors its plain version.  Both recompute
    the order's stage-1 state from ``order_feats``, as the reference's fused
    path does: stage 1 masks final-hop edges, so that state is a pure
    function of the order's own features (``lnn_order_tower``), and a given
    ``order_h`` would be the same values.  ``pack`` (keyword only): the
    weights as ``kernels.stage2_score.pack_stage2_params`` laid them out for
    the kernel, built once by a caller that scores many batches (packed for
    this call when omitted).
    """
    return ops.stage2_score(params, cfg.gnn_type, entity_emb, emb_mask,
                            order_feats, slot_type=slot_type, pack=pack)


# ---------------------------------------------------------------------------
# End-to-end
# ---------------------------------------------------------------------------

def lnn_forward(params, cfg: LNNConfig, graph: PaddedGraph):
    """Full forward: stage2 ∘ stage1.  Logits [N]."""
    h = lnn_stage1(params, cfg, graph)
    return lnn_stage2_batch(params, cfg, h, graph)


def lnn_loss(params, cfg: LNNConfig, graph: PaddedGraph):
    """Masked weighted BCE over effective orders: the mean over rows with
    ``label_mask * [node_type == ORDER]`` (divided by that mask's sum, at
    least 1) of ``-(pos_weight * y * log σ(x) + (1 - y) * log σ(-x))``.

    Differentiable on both paths: on the card the graph aggregations'
    gradients come from their backward kernels, which read the graph's
    reverse-slot index (``PaddedGraph.with_rev`` builds it)."""
    logits = lnn_forward(params, cfg, graph)
    mask = graph.label_mask * (graph.node_type == NodeType.ORDER).float()
    y = graph.label
    per = -(cfg.pos_weight * y * F.logsigmoid(logits) + (1.0 - y) * F.logsigmoid(-logits))
    return (per * mask).sum() / mask.sum().clamp_min(1.0)
