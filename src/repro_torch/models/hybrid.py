"""Hybrid GNN -> GBDT risk head (paper §4.2's "LNN + LGB" composition).

The (frozen) LNN produces its pre-MLP stage-2 embedding ``[g_out ; feats]``
for each request, and a histogram-GBDT booster (``baselines/gbdt.py``, the
LightGBM stand-in) replaces the MLP as the final risk scorer.

Serving contract: a :class:`HybridModel` registers with
:class:`~repro_torch.service.FraudService` as an ordinary model version.
The embedding runs on the LNN's device, unfused
(:func:`~repro_torch.core.lnn.lnn_stage2_embed`; the reference has no fused
embedding either), with one copy back to the host; the booster scores on
the host — numpy, element-deterministic.  :func:`embed_rows` runs the
embedding in launches of exactly ``EMBED_ROWS`` rows, so a request's
embedding has the same bits in any micro-batch (cuBLAS picks its kernel by
shape on the card, and the CPU's matrix-vector path rounds a row
differently at two or three rows than at more): replay parity holds at any
worker count, as for the MLP head.

Persistence is the reference's ``.npz`` layout (``train/checkpoint.py``):
LNN leaves under their usual key paths, the booster's flat arrays under a
``__gbdt__/...`` namespace, and a ``__hybrid__`` marker key that
:func:`is_hybrid_checkpoint` routes restores by — a file either package
writes, the other loads.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.baselines.gbdt import GBDTConfig, GBDTModel, _Tree, train_gbdt
from repro_torch.core.lnn import LNNConfig, lnn_init, lnn_stage2_embed
from repro_torch.params import from_numpy, save_npz, tree_map
from repro_torch.train.checkpoint import load_checkpoint
from repro_torch.utils.device import resolve_device

#: rows per embedding launch (the speed layer's default micro-batch cap)
EMBED_ROWS = 16


def embed_rows(lnn_params, cfg: LNNConfig, entity_emb, emb_mask, order_feats,
               slot_type=None) -> np.ndarray:
    """:func:`~repro_torch.core.lnn.lnn_stage2_embed` of ``[B, K, H]``,
    ``[B, K]``, ``[B, F]`` tensors (and ``[B, K]`` slot types) on their
    device, in launches of exactly ``EMBED_ROWS`` rows, the last padded with
    masked-out zero rows; one copy back.  Returns ``[B, H + F]`` float32 on
    the host, each row's bits independent of B."""
    b = entity_emb.shape[0]
    pad = -b % EMBED_ROWS

    def padded(t, fill=0):
        if not pad:
            return t
        return torch.cat([t, t.new_full((pad,) + tuple(t.shape[1:]), fill)])

    emb, mask, feats = padded(entity_emb), padded(emb_mask), padded(order_feats)
    st = None if slot_type is None else padded(slot_type, -1)
    with torch.no_grad():
        out = torch.cat([
            lnn_stage2_embed(lnn_params, cfg, emb[i:i + EMBED_ROWS],
                             mask[i:i + EMBED_ROWS], feats[i:i + EMBED_ROWS],
                             slot_type=None if st is None else st[i:i + EMBED_ROWS])
            for i in range(0, b + pad, EMBED_ROWS)])
    return out[:b].float().cpu().numpy()


@dataclass
class HybridModel:
    """Frozen LNN embedding + GBDT booster over ``[g_out ; feats]``.

    ``lnn_params`` is the full ``lnn_init`` tree on its device (the stage-1
    refresh uses it unchanged — the hybrid head only replaces online
    stage 2's MLP); ``gbdt`` stays numpy on the host.
    """

    lnn_params: dict
    cfg: LNNConfig
    gbdt: GBDTModel

    def embed(self, entity_emb, emb_mask, order_feats, slot_type=None) -> np.ndarray:
        """Pre-MLP stage-2 embedding ``[B, H+F]`` (host numpy, f32)."""
        return embed_rows(self.lnn_params, self.cfg, entity_emb, emb_mask,
                          order_feats, slot_type=slot_type)

    def score(self, entity_emb, emb_mask, order_feats, slot_type=None) -> np.ndarray:
        """Fraud probability per row — the embedding, then the host booster."""
        return self.gbdt.predict_proba(
            self.embed(entity_emb, emb_mask, order_feats, slot_type=slot_type))


def train_hybrid(lnn_params, cfg: LNNConfig, embeddings: np.ndarray,
                 labels: np.ndarray, gbdt_cfg: GBDTConfig | None = None,
                 x_val: np.ndarray | None = None,
                 y_val: np.ndarray | None = None, device=None) -> HybridModel:
    """Fit the booster on pre-computed stage-2 embeddings (LNN stays frozen).

    ``embeddings`` are :meth:`HybridModel.embed` outputs (or
    ``lnn_stage2_embed``'s) for the training split, as host arrays.  The
    model's LNN leaves (tensors or numpy arrays) are put on ``device``
    (default: CUDA); the booster stays on the host.
    """
    dev = resolve_device(device)
    lnn_params = tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor)
                          else from_numpy(x, dev), lnn_params)
    gbdt = train_gbdt(np.asarray(embeddings, np.float64),
                      np.asarray(labels, np.float64),
                      cfg=gbdt_cfg or GBDTConfig(),
                      x_val=x_val, y_val=y_val)
    return HybridModel(lnn_params=lnn_params, cfg=cfg, gbdt=gbdt)


# --------------------------------------------------------------- persistence

def _gbdt_payload(gbdt: GBDTModel) -> dict:
    """The booster as a tree of arrays: the ``__hybrid__`` marker and the
    ``__gbdt__`` namespace, whose ``/``-joined paths are the reference's
    npz keys."""
    return {
        "__hybrid__": np.asarray(1, np.int64),
        "__gbdt__": {
            "base_score": np.asarray(gbdt.base_score, np.float64),
            "n_trees": np.asarray(len(gbdt.trees), np.int64),
            "n_features": np.asarray(len(gbdt.bin_edges), np.int64),
            "cfg": np.asarray([gbdt.cfg.num_trees, gbdt.cfg.max_depth,
                               gbdt.cfg.num_bins], np.int64),
            "cfg_f": np.asarray([gbdt.cfg.learning_rate, gbdt.cfg.min_child_weight,
                                 gbdt.cfg.reg_lambda, gbdt.cfg.min_gain], np.float64),
            "edges": {str(j): np.asarray(e, np.float64)
                      for j, e in enumerate(gbdt.bin_edges)},
            "tree": {str(i): {"feature": t.feature, "threshold_bin": t.threshold_bin,
                              "left": t.left, "right": t.right, "value": t.value}
                     for i, t in enumerate(gbdt.trees)},
        },
    }


def _gbdt_from_payload(data) -> GBDTModel:
    ci = data["__gbdt__/cfg"]
    cf = data["__gbdt__/cfg_f"]
    cfg = GBDTConfig(num_trees=int(ci[0]), max_depth=int(ci[1]),
                     num_bins=int(ci[2]), learning_rate=float(cf[0]),
                     min_child_weight=float(cf[1]), reg_lambda=float(cf[2]),
                     min_gain=float(cf[3]))
    gbdt = GBDTModel(cfg=cfg, base_score=float(data["__gbdt__/base_score"]))
    for j in range(int(data["__gbdt__/n_features"])):
        gbdt.bin_edges.append(np.asarray(data[f"__gbdt__/edges/{j}"]))
    for i in range(int(data["__gbdt__/n_trees"])):
        gbdt.trees.append(_Tree(
            feature=np.asarray(data[f"__gbdt__/tree/{i}/feature"]),
            threshold_bin=np.asarray(data[f"__gbdt__/tree/{i}/threshold_bin"]),
            left=np.asarray(data[f"__gbdt__/tree/{i}/left"]),
            right=np.asarray(data[f"__gbdt__/tree/{i}/right"]),
            value=np.asarray(data[f"__gbdt__/tree/{i}/value"]),
        ))
    return gbdt


def save_hybrid(path: str, model: HybridModel) -> str:
    """Atomically write a hybrid model to ``path`` (.npz): LNN leaves (host
    copies of the device tensors) under their checkpoint key paths plus the
    ``__gbdt__`` namespace, in one ``params.save_npz``."""
    return save_npz(path, {**model.lnn_params, **_gbdt_payload(model.gbdt)})


def is_hybrid_checkpoint(path: str) -> bool:
    """True when ``path`` is a :func:`save_hybrid` artifact (``__hybrid__``
    marker present), False for a plain LNN checkpoint."""
    with np.load(path) as data:
        return "__hybrid__" in data.files


def load_hybrid(path: str, like_lnn_params, cfg: LNNConfig) -> HybridModel:
    """Restore a hybrid model (written by either package);
    ``like_lnn_params`` is the ``lnn_init`` template whose structure and
    device the LNN leaves take (``train.checkpoint.load_checkpoint``)."""
    lnn_params, _ = load_checkpoint(path, like_lnn_params)
    with np.load(path) as data:
        gbdt = _gbdt_from_payload(data)
    return HybridModel(lnn_params=lnn_params, cfg=cfg, gbdt=gbdt)


def load_model_file(path: str, cfg: LNNConfig, device=None):
    """A model file (written by either package) restored on ``device``
    (default: CUDA): a :class:`HybridModel` for a :func:`save_hybrid`
    artifact, else an LNN tree (``train.checkpoint``'s layout), either one
    taking the structure of an ``lnn_init`` template."""
    template = lnn_init(torch.Generator().manual_seed(0), cfg, device=device)
    if is_hybrid_checkpoint(path):
        return load_hybrid(path, template, cfg)
    return load_checkpoint(path, template)[0]


__all__ = [
    "EMBED_ROWS", "HybridModel", "embed_rows", "is_hybrid_checkpoint",
    "load_hybrid", "load_model_file", "save_hybrid", "train_hybrid",
]
