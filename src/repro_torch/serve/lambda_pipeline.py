"""The Lambda architecture (paper §3.3): batch layer + speed layer.

* :class:`BatchLayer` — periodically refreshes entity embeddings: runs LNN
  stage 1 over every community DDS graph on the device and writes the
  ``entity_{t-e}`` embeddings into the KV store.
* :class:`SpeedLayer` — online transaction-risk inference: per checkout
  request, fetch the linked entities' embeddings by key (ONE key-value
  lookup per entity — no graph traversal) and run the one-layer-GNN + MLP
  stage-2 scorer, one fused kernel launch per micro-batch on the card.
* :func:`split_equivalence_check` — proves the two-stage path reproduces the
  monolithic full-graph forward (the paper's correctness argument for
  deploying the split).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.lnn import LNNConfig, lnn_forward, lnn_stage1, lnn_stage2_online
from repro_torch.kernels.stage2_score import flatten_stage2_params, pack_stage2_params
from repro_torch.serve.kvstore import KVStore, pack_key
from repro_torch.service.types import ScoreRequest
from repro_torch.utils.device import resolve_device


def host_sigmoid(logits) -> np.ndarray:
    """Probabilities from logits, in float64 on the host, returned as float32.

    numpy's ufuncs are element-deterministic for any array length, so a
    request's probability does not depend on the batch it was scored in."""
    x = np.asarray(logits, np.float64)
    return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)


@dataclass
class BatchLayer:
    """Periodic batch-layer refresh: ``refresh(batches)`` runs LNN stage 1
    over each community's padded graph on ``device`` (default: CUDA) and
    writes every ``(entity, t)`` snapshot embedding into ``store`` under its
    packed key.

    ``batches`` are community batches (``b.graph`` PaddedGraph + ``b.dds``
    build record) as produced by ``repro_torch.data.build_communities``.
    """

    params: object
    cfg: LNNConfig
    store: KVStore
    model_version: int = 0
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def set_model(self, params, model_version: int) -> None:
        """Swap to a new parameter version: later refreshes compute and stamp
        embeddings under it."""
        self.params = params
        self.model_version = int(model_version)

    def refresh(self, batches) -> dict:
        """Run stage 1 over all communities, push entity embeddings to the KV
        store.  Returns refresh stats (the paper's 'periodical inference')."""
        t0 = time.time()
        n_written = 0
        for b in batches:
            with torch.no_grad():
                h = lnn_stage1(self.params, self.cfg, b.graph.to(self.device))
            h = h.cpu().numpy()   # one device-to-host copy per community
            # ONE batched put per community (key = (global entity, t))
            items = list(b.dds.entity_snap_ids.items())
            keys = [pack_key(self._global_entity(b, ent), t)
                    for (ent, t), _ in items]
            n_written += self.store.put_batch(
                keys, (h[nid] for _, nid in items),
                model_version=self.model_version)
        return {"entities_written": n_written, "seconds": time.time() - t0,
                "store_size": len(self.store)}

    @staticmethod
    def _global_entity(b, local_ent: int) -> int:
        # communities keep a local->global entity map when built from a
        # partition; fall back to local ids for single-community graphs
        m = getattr(b, "global_entity_ids", None)
        return int(m[local_ent]) if m is not None else int(local_ent)


@dataclass
class SpeedLayer:
    """Online transaction-risk scorer: ``score(requests)`` maps a list of
    requests to fraud probabilities via at most ``k_max`` KV lookups per
    request plus a single ``lnn_stage2_online`` call on ``device`` (default:
    CUDA) — on the card, one launch of the fused ``stage2_score`` kernel.

    ``pack`` holds the weights as the kernel reads them, packed once from
    ``params`` here (and again by :meth:`set_model`, or if ``params`` is
    replaced); ``None`` packs them on every call.
    """

    params: object
    cfg: LNNConfig
    store: KVStore
    k_max: int = 8
    model_version: int = 0
    device: object = None
    pack: object = field(init=False, default=None, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._repack()

    def _repack(self) -> None:
        gnn, typed = self.cfg.gnn_type, "typed" in self.params
        self.pack = pack_stage2_params(flatten_stage2_params(self.params, gnn), gnn, typed)
        self._packed_params = self.params

    def set_model(self, params, model_version: int) -> None:
        """Swap to a new parameter version; the next score uses its pack."""
        self.params = params
        self.model_version = int(model_version)
        self._repack()

    def score(self, requests: list) -> np.ndarray:
        """requests: :class:`~repro_torch.service.types.ScoreRequest`s (the
        ``{'features': [F], 'entity_keys': [(ent, t_e), ...]}`` dicts are
        also accepted).  Returns float32 fraud probabilities."""
        reqs = [ScoreRequest.from_legacy(r) for r in requests]
        feats = np.stack([np.asarray(r.features, np.float32) for r in reqs])
        key_lists = [[pack_key(e, t) for (e, t) in r.entity_keys] for r in reqs]
        emb, mask = self.store.lookup_batch(key_lists, self.k_max)
        dev = self.device
        if self.pack is not None and self.params is not self._packed_params:
            self._repack()
        with torch.no_grad():
            logits = lnn_stage2_online(
                self.params, self.cfg, torch.from_numpy(emb).to(dev),
                torch.from_numpy(mask).to(dev), torch.from_numpy(feats).to(dev),
                pack=self.pack)
        return host_sigmoid(logits.cpu().numpy())


def _batch_history_requests(b) -> tuple[list[ScoreRequest], list[int]]:
    """(typed requests, their order rows) for one community batch — the one
    place the speed-layer request construction from ``b.dds.last_hop``
    lives."""
    requests, rows = [], []
    for o, hops in b.dds.last_hop.items():
        keys = [(BatchLayer._global_entity(b, ent), t) for ent, t, _ in hops]
        requests.append(ScoreRequest(
            features=np.asarray(b.graph.features[o]), entity_keys=keys))
        rows.append(o)
    return requests, rows


def history_requests(batches) -> list[ScoreRequest]:
    """Typed speed-layer requests for every order with history across the
    community batches."""
    return [r for b in batches for r in _batch_history_requests(b)[0]]


def split_equivalence_check(score_fn, params, cfg: LNNConfig, batches,
                            atol: float = 1e-4, device=None) -> float:
    """Max |online score - monolithic forward| over all orders with history,
    for ANY scorer with the speed-layer signature (``score_fn(requests) ->
    probs``).  The monolithic forward runs on ``device`` (default: CUDA).
    Raises ``AssertionError`` above ``atol``."""
    dev = resolve_device(device)
    worst = 0.0
    for b in batches:
        requests, rows = _batch_history_requests(b)
        if not requests:
            continue
        with torch.no_grad():
            logits = lnn_forward(params, cfg, b.graph.to(dev))
        full = host_sigmoid(logits.cpu().numpy())
        online = np.asarray(score_fn(requests))
        worst = max(worst, float(np.abs(online - full[rows]).max()))
    if worst > atol:
        raise AssertionError(f"lambda split mismatch: {worst} > {atol}")
    return worst
