"""``FraudService`` — the one serving facade over both Lambda halves.

One class, one explicit lifecycle::

    build() -> warmup() -> serve (score / submit / replay / refresh)
            -> drain() -> close()

constructed from a single :class:`~repro_torch.service.config.ServiceConfig`
artifact plus a parameter tree, on ``device`` (default: CUDA; tests pass
``device="cpu"`` for the kernels' plain versions).  ``mode="batch"`` wraps
the offline :class:`~repro_torch.serve.lambda_pipeline.BatchLayer` /
:class:`~repro_torch.serve.lambda_pipeline.SpeedLayer` pair over one KV
store; ``mode="streaming"`` wraps the event-time
:class:`~repro_torch.stream.engine.StreamingEngine` (and its
:class:`~repro_torch.stream.workers.WorkerPool`) over the same store design.
Scores are **bit-identical** to those layers and that engine driven
directly — the facade calls the same layers in the same order
(``tests/test_torch_service.py``).

On top of them it adds:

* **versioned model hot-swap** — :meth:`load_model` registers a parameter
  version; in-flight micro-batches finish on the weight pack they
  captured, new flushes score under the new version, and batch-layer KV
  puts are stamped with the model version so post-swap reads of pre-swap
  embeddings are detectable (``store.stats['model_stale_reads']``);
* **admission control** — queue-depth / in-flight caps with a
  shed-vs-block policy (block stalls bounded by
  ``admission.block_max_wait_s`` with a timed-out→shed fallback), accounted
  in :class:`~repro_torch.service.types.ServiceStats`;
* **canary/shadow scoring** — :meth:`enable_shadow` re-scores a sampled
  fraction of admitted traffic under a second registered model version,
  off the response path, through a scorer of its own (its own weight
  pack), tracking |primary − shadow| divergence and raising an alert when
  it breaches a threshold;
* **crash consistency** — :meth:`enable_wal`, :meth:`checkpoint` and
  :meth:`restore` (``repro_torch.stream.checkpoint``): crash → restore →
  WAL-suffix replay gives the uninterrupted run's scores and KV bytes.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time

import numpy as np
import torch

from repro_torch.serve.kvstore import KVStore
from repro_torch.service.config import ServiceConfig
from repro_torch.service.types import ScoreRequest, ScoreResponse, ServiceStats
from repro_torch.utils.device import resolve_device


class ServiceLifecycleError(RuntimeError):
    """An operation was invoked in a lifecycle state that forbids it."""


#: states in which serving operations (score/submit/refresh/drain) are legal
_SERVABLE = ("built", "ready", "serving", "drained")


class FraudService:
    """One typed serving API for the Lambda fraud detector.

    Parameters
    ----------
    config:
        The :class:`ServiceConfig` artifact (or a dict / JSON produced by
        one — see :meth:`from_artifact`).
    params:
        LNN parameter tree (or a :class:`~repro_torch.models.hybrid.HybridModel`)
        for the initial model version, on ``device``.  May instead be
        registered later via :meth:`load_model` before :meth:`build`.
    store:
        Optional pre-populated :class:`KVStore`; by default the service
        builds its own from ``config.store``.
    device:
        Where stage 1 and stage 2 run (default: CUDA, raising without it;
        ``"cpu"`` takes the kernels' plain versions).
    """

    def __init__(self, config: ServiceConfig, params=None,
                 store: KVStore | None = None, device=None):
        self.device = resolve_device(device)
        if isinstance(config, dict):
            config = ServiceConfig.from_dict(config)
        self.config = config
        self.mode = config.mode
        self._external_store = store
        self.store: KVStore | None = store
        self._state = "created"
        self._models: dict[int, object] = {}
        self._model_version = 0
        self._model_swaps = 0
        self._params = None
        # previous active version after a live swap — the rollback target
        # (rollback_model); None until the first post-build activation
        self._last_good: int | None = None
        self.last_rollback: dict | None = None
        self._auto_ckpt: dict | None = None   # enable_auto_checkpoint state
        # crash consistency (enable_wal / checkpoint / restore) — these must
        # exist before the eager load_model below consults them
        self._wal = None
        self._wal_root: str | None = None
        self._applied_seq = 0
        self._replaying = False
        self.last_recovery: dict | None = None
        if params is not None:
            self.load_model(params, version=0)
        # admission + traffic accounting (ServiceStats surface)
        self._acct = {"requests": 0, "scored": 0, "shed": 0, "blocked": 0,
                      "block_timeouts": 0, "rollbacks": 0,
                      "queue_depth_peak": 0, "in_flight_peak": 0}
        self._scores_by_version: dict[int, int] = {}
        # canary/shadow scoring state (enable_shadow); the lock makes the
        # divergence counters tear-free under concurrent request threads
        self._shadow_lock = threading.Lock()
        self._shadow: dict | None = None
        self._shadow_acc = 0.0
        self._shadow_scorers: dict[int, object] = {}   # version -> Stage2Scorer
        # mode-specific internals (populated by build)
        self._engine = None          # streaming
        self._autoscaler = None      # streaming (admission.autoscale)
        self._batch_layer = None     # batch
        self._speed_layer = None     # batch

    @classmethod
    def from_artifact(cls, path: str, params=None,
                      store: KVStore | None = None, device=None) -> "FraudService":
        """Construct from a saved ``ServiceConfig`` JSON artifact (written by
        either package)."""
        return cls(ServiceConfig.load(path), params=params, store=store,
                   device=device)

    # ------------------------------------------------------------- lifecycle
    @property
    def state(self) -> str:
        return self._state

    def _ensure(self, allowed: tuple, op: str) -> None:
        if self._state not in allowed:
            raise ServiceLifecycleError(
                f"FraudService.{op}() is illegal in state {self._state!r} "
                f"(allowed: {allowed}); lifecycle is "
                "build -> warmup -> serve -> drain -> close"
            )

    def build(self) -> "FraudService":
        """Construct the store and the mode's serving layers.  Requires a
        registered model (constructor ``params`` or :meth:`load_model`).
        With ``workers.backend="process"`` each worker is a spawned shard
        process on ``device`` (``repro_torch.stream.procpool``); checkpoints
        gather the shards out of them and ``restore`` re-seeds fresh ones."""
        self._ensure(("created",), "build")
        if self._params is None:
            raise ServiceLifecycleError(
                "build() needs a model: pass params to the constructor or "
                "call load_model() first")
        cfg = self.config
        lnn = cfg.to_lnn_config()
        if self.mode == "streaming":
            from repro_torch.stream.engine import StreamingEngine, _stage1_params

            self._engine = StreamingEngine(
                self._params, lnn, cfg.to_engine_config(),
                store=self._external_store, _via_service=True, device=self.device)
            self._engine.model_version = self._model_version
            self._engine.pool.set_model(self._params, self._model_version)
            self._engine.refresher.set_model(
                _stage1_params(self._params), self._model_version)
            self.store = self._engine.store
            adm = cfg.admission
            if adm.autoscale or adm.adaptive_steal:
                from repro_torch.stream.workers import DepthAutoscaler

                self._autoscaler = DepthAutoscaler(
                    self._engine.pool,
                    min_workers=adm.autoscale_min_workers,
                    max_workers=adm.autoscale_max_workers,
                    high_depth=adm.autoscale_high_depth,
                    low_depth=adm.autoscale_low_depth,
                    sustain=adm.autoscale_sustain,
                    cooldown=adm.autoscale_cooldown,
                    autoscale=adm.autoscale,
                    adaptive_steal=adm.adaptive_steal,
                )
        else:
            from repro_torch.models.hybrid import HybridModel

            if isinstance(self._params, HybridModel):
                raise ServiceLifecycleError(
                    "hybrid GNN->GBDT models serve in mode='streaming' only "
                    "(the booster replaces the online stage-2 head; the "
                    "batch pipeline has no online stage 2)")
            from repro_torch.serve.lambda_pipeline import BatchLayer, SpeedLayer

            if self.store is None:
                s = cfg.store
                self.store = KVStore(
                    lnn.hidden_dim, capacity=s.capacity,
                    ttl_seconds=s.ttl_seconds, num_shards=s.num_shards,
                    shard_by_entity=bool(s.shard_by_entity),
                )
            self._batch_layer = BatchLayer(
                self._params, lnn, self.store,
                model_version=self._model_version, device=self.device)
            self._speed_layer = SpeedLayer(
                self._params, lnn, self.store, cfg.engine.k_max,
                model_version=self._model_version, device=self.device)
        self._state = "built"
        return self

    def warmup(self) -> "FraudService":
        """Run the hot path once per shape up front, on the device (cold
        start off the measured path).  Streaming: every micro-batch bucket
        on every worker, under the active version and under every other
        registered one (whose weight packs are built here), so the first
        flush after a hot swap pays neither.  Batch: one stage-2 launch."""
        self._ensure(("built", "ready"), "warmup")
        if self.mode == "streaming":
            others = {v: p for v, p in self._models.items()
                      if v != self._model_version}
            self._engine.pool.warmup(others)
        else:
            from repro_torch.core.lnn import lnn_stage2_online

            lnn = self.config.to_lnn_config()
            k, sl = self.config.engine.k_max, self._speed_layer
            # one launch at batch 1, without touching the store
            with torch.no_grad():
                lnn_stage2_online(
                    sl.params, lnn, torch.zeros((1, k, lnn.hidden_dim), device=self.device),
                    torch.zeros((1, k), device=self.device),
                    torch.zeros((1, lnn.feat_dim), device=self.device), pack=sl.pack)
        self._state = "ready"
        return self

    def drain(self, now: float | None = None) -> list[ScoreResponse]:
        """Barrier: finish outstanding work (streaming: join async refreshes
        and force-flush every worker queue).  The service may keep serving
        afterwards; ``close()`` ends it for good."""
        self._ensure(_SERVABLE, "drain")
        seq = None
        if self._wal is not None and not self._replaying \
                and self.mode == "streaming":
            # a drain force-flushes every queue, changing flush composition
            # — replay must reproduce it at the same point in the stream
            seq = self._wal.append_drain(now)
        out: list[ScoreResponse] = []
        if self.mode == "streaming":
            out = self._engine.flush(now)
            self._engine.refresher.drain()
            self._account_scored(out)
        self._state = "drained"
        if seq is not None:
            self._applied_seq = seq
        return out

    def close(self) -> None:
        """Terminal: no operation is legal afterwards (idempotent).  The
        refresh thread stops and the WAL closes even when the final flush
        raises (a crash the async refresh thread carried)."""
        if self._state == "closed":
            return
        try:
            if self.mode == "streaming" and self._engine is not None \
                    and self._state in _SERVABLE:
                # never strand queued work on close
                if self._wal is not None:
                    self._wal.append_drain(None)
                self._engine.flush()
                self._engine.refresher.drain()
        finally:
            self._state = "closed"
            try:
                if self.mode == "streaming" and self._engine is not None:
                    self._engine.close()
            finally:
                if self._wal is not None:
                    self._wal.close()

    # -------------------------------------------------------------- hot-swap
    def load_model(self, params, version: int | None = None) -> int:
        """Register ``params`` as a model version and activate it.

        In-flight micro-batches finish on the weight pack (and version
        stamp) they captured at flush entry; every later flush scores under
        the new version.  Batch-layer KV puts are stamped with the active
        model version, so reads of embeddings computed by an older model
        are detectable (``store.stats['model_stale_reads']``).  Versions are
        kept in a registry; re-activating an old version reuses its
        weight pack.
        """
        if self._state == "closed":
            raise ServiceLifecycleError("load_model() on a closed service")
        if version is None:
            version = (max(self._models) + 1) if self._models else 0
        version = int(version)
        seq = None
        if self._wal is not None and not self._replaying:
            # write-ahead for hot-swaps too: persist the params file, THEN
            # log the swap — a logged swap is always replayable
            rel = self._persist_params(params, version)
            seq = self._wal.append_model(version, rel)
        prev = self._model_version
        self._models[version] = params
        self._params = params
        self._model_version = version
        if self._state != "created":
            self._model_swaps += 1
            if prev != version and prev in self._models:
                # the displaced incumbent becomes the rollback target
                self._last_good = prev
            if self.mode == "streaming":
                self._engine.load_model(params, version)
            else:
                self._batch_layer.set_model(params, version)
                self._speed_layer.set_model(params, version)
        if seq is not None:
            self._applied_seq = seq
        return version

    @property
    def model_version(self) -> int:
        return self._model_version

    @property
    def wal(self):
        """The live :class:`~repro_torch.stream.checkpoint.WriteAheadLog`
        (None before :meth:`enable_wal`)."""
        return self._wal

    def model_versions(self) -> tuple:
        """Every registered version, ascending."""
        return tuple(sorted(self._models))

    def model_params(self, version: int | None = None):
        """Registered parameters for ``version`` (default: the active
        version)."""
        v = self._model_version if version is None else int(version)
        if v not in self._models:
            raise KeyError(
                f"model version {v} is not registered "
                f"(registered: {self.model_versions()})")
        return self._models[v]

    def register_model(self, params, version: int | None = None) -> int:
        """Add ``params`` to the version registry WITHOUT activating them —
        the staging half of a rollout: a registered version can be activated
        later (:meth:`activate_model`) or served as the canary
        (:meth:`enable_shadow`).  Returns the version registered."""
        if self._state == "closed":
            raise ServiceLifecycleError("register_model() on a closed service")
        if version is None:
            version = (max(self._models) + 1) if self._models else 0
        version = int(version)
        if self._wal is not None and not self._replaying:
            # registration has no scoring effect, so it needs no WAL record,
            # but the params must be on disk for checkpoint manifests (and a
            # later logged activate_model) to reference
            self._persist_params(params, version)
        self._models[version] = params
        return version

    def activate_model(self, version: int) -> int:
        """Hot-swap to an already-registered version (weights travel via
        checkpoints, not by value)."""
        version = int(version)
        if version not in self._models:
            raise KeyError(
                f"model version {version} is not registered "
                f"(registered: {self.model_versions()})")
        return self.load_model(self._models[version], version)

    def register_perturbed(self, from_version: int, scale: float,
                           seed: int = 0, version: int | None = None) -> int:
        """Register a new version derived from ``from_version`` by adding
        deterministic Gaussian noise of ``scale`` to every parameter leaf.

        ``scale=0.0`` clones the weights — a hot swap to such a clone
        leaves every score bit-identical across a version bump; a nonzero
        scale makes a deliberately-divergent canary that must trip the
        shadow divergence alert.

        The noise is drawn on the host (``np.random.default_rng(seed)``),
        leaf by leaf in the reference's order (dict keys sorted, as
        ``jax.tree_util`` flattens), added to host copies of the leaves in
        float64 and rounded to their dtype, then moved back to their
        device: the port and the reference perturb the same weights into
        the same bits.  Hybrid models perturb their LNN tower only (the
        GBDT head is shared by reference)."""
        from_version = int(from_version)
        if from_version not in self._models:
            raise KeyError(
                f"model version {from_version} is not registered "
                f"(registered: {self.model_versions()})")
        import dataclasses

        from repro_torch.models.hybrid import HybridModel

        rng = np.random.default_rng(seed)

        def perturb(leaf):
            if scale == 0.0 or not leaf.is_floating_point():
                return leaf.clone()
            a = leaf.detach().cpu().numpy()
            a = (a + scale * rng.standard_normal(a.shape)).astype(a.dtype)
            return torch.from_numpy(a).to(leaf.device)

        source = self._models[from_version]
        if isinstance(source, HybridModel):
            params = dataclasses.replace(
                source, lnn_params=_map_sorted(perturb, source.lnn_params))
        else:
            params = _map_sorted(perturb, source)
        return self.register_model(params, version)

    @property
    def last_good_version(self) -> int | None:
        """The version a :meth:`rollback_model` would return to — the
        incumbent displaced by the most recent live swap (None until a swap
        happens, and cleared by a rollback so two alerts can never
        ping-pong between a bad version and its predecessor)."""
        return self._last_good

    def rollback_model(self, reason: str = "") -> int:
        """Roll the active model back to the last-good version.

        The shared rollback path of a promotion controller and a canary
        auto-rollback: it disables shadow scoring (the alert source),
        re-activates :attr:`last_good_version`, counts the event
        (``ServiceStats.rollbacks``), and records ``last_rollback`` for the
        stats surface.  Raises :class:`ServiceLifecycleError` when no
        last-good version exists."""
        if self._last_good is None or self._last_good not in self._models:
            raise ServiceLifecycleError(
                "rollback_model() needs a last-good version — no live swap "
                "has displaced an incumbent (or it was already rolled back)")
        bad, target = self._model_version, self._last_good
        self.disable_shadow()
        out = self.activate_model(target)
        # activate_model recorded ``bad`` as the displaced incumbent; a
        # rolled-back-from version is NOT a rollback target
        self._last_good = None
        self._acct["rollbacks"] += 1
        self.last_rollback = {"from": bad, "to": target,
                              "reason": str(reason)}
        return out

    # ------------------------------------------------------- shadow (canary)
    def enable_shadow(self, version: int, fraction: float | None = None,
                      threshold: float | None = None,
                      collect_eval: int | None = None,
                      role: str = "canary") -> dict:
        """Start canary/shadow scoring: a sampled ``fraction`` of admitted
        responses is re-scored under registered ``version`` (off the
        response path — callers invoke :meth:`shadow_observe` AFTER the
        primary response is delivered) and |primary − shadow| divergence is
        accumulated; one sample above ``threshold`` raises the alert
        (``shadow['alert_active']``, sticky until shadow is re-enabled).

        Defaults for ``fraction``/``threshold`` come from
        ``config.gateway``.  Returns the initial shadow-state snapshot.

        ``collect_eval``: when set, each sampled response additionally
        appends a ``[label, primary_score, shadow_score]`` triple to a
        bounded eval buffer (``shadow['eval']``, capped at ``collect_eval``
        entries) — the promotion controller's recall@budget evidence.  The
        buffer lives inside the shadow dict, so it rides checkpoint
        manifests and a crash mid-eval resumes the window instead of
        double-counting.  ``role`` labels the shadow's purpose
        (``'canary'`` / ``'candidate'`` / ``'last_good'``) so a restored
        promotion controller can re-attach to the right state.

        The shadow version scores through a
        :class:`~repro_torch.stream.workers.Stage2Scorer` of its own, built
        here (its own weight pack, never the primary's).
        """
        if self._state == "closed":
            raise ServiceLifecycleError("enable_shadow() on a closed service")
        version = int(version)
        if version not in self._models:
            raise KeyError(
                f"shadow version {version} is not registered "
                f"(registered: {self.model_versions()})")
        gw = self.config.gateway
        fraction = gw.shadow_fraction if fraction is None else float(fraction)
        if not 0.0 <= fraction <= 1.0:
            raise ValueError("shadow fraction must be in [0, 1]")
        threshold = (gw.shadow_divergence_threshold if threshold is None
                     else float(threshold))
        self._shadow_scorer(version)
        with self._shadow_lock:
            self._shadow = {
                "version": version, "fraction": fraction,
                "threshold": threshold, "role": str(role), "sampled": 0,
                "divergence_sum": 0.0, "divergence_max": 0.0,
                "last_divergence": 0.0, "alerts": 0, "alert_active": False,
            }
            if collect_eval is not None:
                if int(collect_eval) < 1:
                    raise ValueError("collect_eval must be >= 1 or None")
                self._shadow["eval"] = []
                self._shadow["eval_max"] = int(collect_eval)
            self._shadow_acc = 0.0
            return self._shadow_snapshot()

    def _shadow_snapshot(self) -> dict:
        """Copy of the shadow dict (eval buffer deep-copied) — callers must
        never alias the live mutable state.  Lock held by caller."""
        snap = dict(self._shadow)
        if "eval" in snap:
            snap["eval"] = [list(t) for t in snap["eval"]]
        return snap

    def disable_shadow(self) -> None:
        with self._shadow_lock:
            self._shadow = None

    def shadow_stats(self) -> dict:
        """Snapshot of the divergence counters (empty dict = shadow off)."""
        with self._shadow_lock:
            return self._shadow_snapshot() if self._shadow is not None else {}

    def shadow_observe(self, responses: list) -> int:
        """Feed delivered responses to the shadow scorer.

        Samples admitted responses at the configured fraction (deterministic
        error-accumulator sampling, not RNG — replays sample identically),
        re-scores them in ONE padded stage-2 call under the shadow version
        against the live KV store, and folds |primary − shadow| into the
        divergence counters.  Returns the number sampled.

        The shadow batch is padded to the speed layer's pow2 buckets and a
        row's score does not depend on its batch, so an identical-weights
        shadow diverges by exactly 0.0 (bit-parity).
        """
        with self._shadow_lock:
            if self._shadow is None:
                return 0
            version = self._shadow["version"]
            fraction = self._shadow["fraction"]
            picked: list[ScoreResponse] = []
            for r in responses:
                if not r.admitted:
                    continue
                self._shadow_acc += fraction
                if self._shadow_acc >= 1.0 - 1e-12:
                    self._shadow_acc -= 1.0
                    picked.append(r)
        if not picked:
            return 0
        shadow_scores = self._shadow_score([r.request for r in picked], version)
        with self._shadow_lock:
            sh = self._shadow
            if sh is None or sh["version"] != version:
                return 0   # shadow was swapped/disabled mid-scoring
            for r, p in zip(picked, shadow_scores):
                d = abs(float(r.score) - float(p))
                sh["sampled"] += 1
                sh["divergence_sum"] += d
                sh["divergence_max"] = max(sh["divergence_max"], d)
                sh["last_divergence"] = d
                if d > sh["threshold"]:
                    sh["alerts"] += 1
                    sh["alert_active"] = True
                if "eval" in sh and len(sh["eval"]) < sh["eval_max"]:
                    # [label, primary, shadow] — labels ride the request tag
                    # (the CheckoutEvent); tagless batch-mode requests record
                    # NaN, which recall evaluation skips
                    label = getattr(r.request.tag, "label", math.nan)
                    sh["eval"].append(
                        [float(label), float(r.score), float(p)])
        return len(picked)

    def _shadow_scorer(self, version: int):
        """The shadow's own :class:`~repro_torch.stream.workers.Stage2Scorer`
        for registered ``version`` (built once per version and params)."""
        from repro_torch.stream.workers import Stage2Scorer

        params = self._models[version]
        sc = self._shadow_scorers.get(version)
        if sc is None or sc.params is not params:
            sc = Stage2Scorer(params, self.config.to_lnn_config(), self.store,
                              self.config.engine.k_max, model_version=version,
                              device=self.device)
            self._shadow_scorers[version] = sc
        return sc

    def _shadow_score(self, requests: list, version: int) -> np.ndarray:
        """Score ``requests`` under registered ``version`` against the live
        store, replicating the primary path's numerics per mode (streaming:
        versioned snapshot-fallback lookup; batch: exact-key lookup as
        ``serve.SpeedLayer`` does), padded to a pow2 bucket (in chunks of at
        most ``engine.max_batch`` requests), through the shadow's scorer:
        its stage-2 pack (or hybrid head) and the host f64 sigmoid."""
        from repro_torch.stream.microbatch import bucket_size

        cap = max(2, self.config.engine.max_batch)
        if len(requests) > cap:      # one padded bucket at most per call
            return np.concatenate([self._shadow_score(requests[i:i + cap], version)
                                   for i in range(0, len(requests), cap)])
        lnn = self.config.to_lnn_config()
        k = self.config.engine.k_max
        scorer = self._shadow_scorer(version)
        n = len(requests)
        b = bucket_size(n, cap)
        feats = np.zeros((b, lnn.feat_dim), np.float32)
        key_lists: list[list] = [[] for _ in range(b)]
        for i, r in enumerate(requests):
            feats[i] = r.features
            key_lists[i] = list(r.entity_keys)
        if self.mode == "streaming":
            # expected_model_version=None: shadow reads must not pollute the
            # production model_stale_reads counter
            emb, mask, stale = self.store.lookup_batch_versioned(key_lists, k)
        else:
            from repro_torch.serve.kvstore import pack_key

            packed = [[pack_key(e, t) for (e, t) in keys] for keys in key_lists]
            emb, mask = self.store.lookup_batch(packed, k)
            stale = np.full((b, k), -1, np.int32)
        # a strongly-perturbed canary can drive exp to +inf, which saturates
        # to prob 0.0 — well-defined, so the overflow warning is noise
        with np.errstate(over="ignore"):
            probs, _, _ = scorer.score_slots(feats, key_lists, emb, mask, stale)
        return probs[:n]

    # ------------------------------------------------------------ batch mode
    def refresh(self, batches) -> dict:
        """Batch-layer refresh over community batches (mode='batch')."""
        self._ensure(_SERVABLE, "refresh")
        self._require_mode("batch", "refresh")
        self._state = "serving"
        return self._batch_layer.refresh(batches)

    def score(self, requests: list) -> list[ScoreResponse]:
        """Score a request list synchronously (mode='batch').

        Accepts typed :class:`ScoreRequest`s (legacy dicts tolerated).
        Admission: with ``max_queue_depth = D`` set, ``shed`` rejects
        requests beyond the first D per call (NaN score,
        ``admitted=False``); ``block`` scores everything in D-sized
        chunks, counting the overflow as blocked.
        """
        self._ensure(_SERVABLE, "score")
        self._require_mode("batch", "score")
        self._state = "serving"
        reqs = [ScoreRequest.from_legacy(r) for r in requests]
        self._acct["requests"] += len(reqs)
        adm = self.config.admission
        cap = adm.max_queue_depth
        shed: list[ScoreRequest] = []
        chunks: list[list[ScoreRequest]]
        if cap is None or len(reqs) <= cap:
            chunks = [reqs] if reqs else []
        elif adm.policy == "shed":
            chunks, shed = [reqs[:cap]], reqs[cap:]
            self._acct["shed"] += len(shed)
        else:  # block: everything scores, in cap-sized waves
            chunks = [reqs[i:i + cap] for i in range(0, len(reqs), cap)]
            self._acct["blocked"] += len(reqs) - cap
        self._acct["queue_depth_peak"] = max(
            self._acct["queue_depth_peak"], len(reqs))
        out: list[ScoreResponse] = []
        for chunk in chunks:
            probs = self._speed_layer.score(chunk)
            out.extend(
                ScoreResponse(request=r, score=float(p),
                              batch_size=len(chunk),
                              model_version=self._model_version)
                for r, p in zip(chunk, probs)
            )
        self._account_scored(out)
        out.extend(
            ScoreResponse(request=r, score=math.nan, admitted=False,
                          model_version=self._model_version)
            for r in shed
        )
        return out

    def score_equivalence_check(self, batches, atol: float = 1e-4) -> float:
        """Two-stage-vs-monolithic bound through the real store
        (mode='batch'); see ``serve.split_equivalence_check``."""
        self._ensure(_SERVABLE, "score_equivalence_check")
        self._require_mode("batch", "score_equivalence_check")
        from repro_torch.serve.lambda_pipeline import split_equivalence_check

        # drive the speed layer directly: an internal verification replay
        # must neither count as served traffic nor be subject to admission
        # shedding (a shed NaN would fail the check spuriously)
        return split_equivalence_check(
            self._speed_layer.score,
            self._params, self.config.to_lnn_config(), batches, atol,
            device=self.device)

    # -------------------------------------------------------- streaming mode
    def submit(self, event) -> list[ScoreResponse]:
        """Ingest one :class:`~repro_torch.stream.events.CheckoutEvent` and
        return whatever responses completed by its arrival — the engine's
        path with the admission controller between ingest and enqueue."""
        self._ensure(_SERVABLE, "submit")
        self._require_mode("streaming", "submit")
        seq = None
        if self._wal is not None and not self._replaying:
            # write-ahead: log before any state mutation, so a crash
            # anywhere inside the apply is repaired by replay, never lost
            seq = self._wal.append_event("submit", event)
        self._state = "serving"
        eng, pool, adm = self._engine, self._engine.pool, self.config.admission
        now = event.arrival
        out = pool.poll(now)
        req = eng.ingest(event)
        self._acct["requests"] += 1
        self._acct["in_flight_peak"] = max(
            self._acct["in_flight_peak"], pool.busy_workers(now))

        if not self._admit(req, pool, adm, now, out):
            self._account_scored(out)
            out.append(ScoreResponse(
                request=req, score=math.nan, admitted=False,
                model_version=self._model_version))
            if seq is not None:
                self._applied_seq = seq
            self._maybe_auto_checkpoint()
            return out
        # peak records the depth the admitted request actually observed
        # (post block-drain), so it never exceeds an enforced cap + 1 frame
        self._acct["queue_depth_peak"] = max(
            self._acct["queue_depth_peak"], len(pool) + 1)
        out.extend(pool.submit(req, now))
        if self._autoscaler is not None:
            # a scale decision drains the queues; those results were scored
            # under the old topology and must reach the caller
            out.extend(self._autoscaler.observe(now))
        self._account_scored(out)
        if seq is not None:
            self._applied_seq = seq
        self._maybe_auto_checkpoint()
        return out

    def _admit(self, req, pool, adm, now: float, out: list) -> bool:
        """Admission decision for one streaming request.  Returns False to
        shed.  Block-policy stalls (forced flushes / busy-worker waits) are
        applied here and counted."""
        if adm.max_queue_depth is not None and len(pool) >= adm.max_queue_depth:
            if adm.policy == "shed":
                self._acct["shed"] += 1
                return False
            # block: the producer stalls while the deepest queue drains.
            # Progress is measured by pool depth, NOT by returned results —
            # the reorder buffer may withhold a flushed batch until earlier
            # sequence numbers complete, so an empty return is routine with
            # multiple workers while the flush itself still freed capacity.
            # The stall is wall-clock-bounded by admission.block_max_wait_s:
            # on timeout (or a wedged queue) the request is shed instead of
            # waiting forever / being admitted over-cap.
            self._acct["blocked"] += 1
            drained, admitted = pool.drain_to_depth(
                adm.max_queue_depth, now, budget_s=adm.block_max_wait_s)
            out.extend(drained)
            if not admitted:
                self._acct["block_timeouts"] += 1
                self._acct["shed"] += 1
                return False
        if adm.max_in_flight is not None \
                and pool.busy_workers(now) >= adm.max_in_flight:
            if adm.policy == "shed":
                self._acct["shed"] += 1
                return False
            self._acct["blocked"] += 1  # admitted, but the stall is visible
        return True

    def ingest(self, event) -> None:
        """Ingest one event into the DDS/batch layer WITHOUT scoring —
        backfill and non-checkout entity activity.  Counts toward refresh
        triggers and KV writes but not toward request/score accounting."""
        self._ensure(_SERVABLE, "ingest")
        self._require_mode("streaming", "ingest")
        seq = None
        if self._wal is not None and not self._replaying:
            seq = self._wal.append_event("ingest", event)
        self._state = "serving"
        self._engine.ingest(event)
        if seq is not None:
            self._applied_seq = seq
        self._maybe_auto_checkpoint()

    def replay(self, events, warmup: bool = True):
        """Drive a whole event stream; returns the engine's
        :class:`~repro_torch.stream.engine.ReplayReport` (admission-shed
        requests are accounted in :meth:`stats`, not in the report)."""
        self._ensure(_SERVABLE, "replay")
        self._require_mode("streaming", "replay")
        if warmup:
            # same semantics as the engine's replay: every bucket shape once
            # before the measured loop (idempotent)
            self._engine.warmup()
            if self._state == "built":
                self._state = "ready"
        from repro_torch.stream.engine import ReplayReport

        results: list[ScoreResponse] = []
        for ev in events:
            results.extend(self.submit(ev))
        results.extend(self.drain())
        return ReplayReport(
            results=[r for r in results if r.admitted], engine=self._engine)

    # ---------------------------------------------- crash consistency (WAL)
    def _persist_params(self, params, version: int) -> str:
        """Write one model version under the WAL root (idempotent), from
        host copies of its tensors.  Returns the root-relative path
        checkpoint manifests / WAL model records reference.  Hybrid models
        persist as ``save_hybrid`` artifacts in the same ``.npz`` slot (the
        ``__hybrid__`` marker routes the restore)."""
        from repro_torch.models.hybrid import HybridModel, save_hybrid
        from repro_torch.train.checkpoint import save_checkpoint

        rel = os.path.join("models", f"v{int(version)}.npz")
        path = os.path.join(self._wal_root, rel)
        if not os.path.exists(path):
            if isinstance(params, HybridModel):
                save_hybrid(path, params)
            else:
                save_checkpoint(path, params)
        return rel

    def enable_wal(self, root: str, fsync: bool = False) -> "FraudService":
        """Start write-ahead logging under directory ``root``.

        Must be called on a freshly-built streaming service **before any
        traffic** — recovery without a checkpoint replays the whole log
        against the genesis state, so that state must be reconstructible:
        ``root/service.json`` (the config), ``root/genesis.json`` (active
        version + registry + lifecycle), and every registered version's
        params under ``root/models/`` are persisted here.  From this point
        every ``submit`` / ``ingest`` / ``load_model`` is logged *before*
        it is applied; :meth:`checkpoint` bounds replay time and
        :meth:`restore` rebuilds the exact state after a crash.
        """
        from repro_torch.stream import checkpoint as ckpt

        self._ensure(("built", "ready"), "enable_wal")
        self._require_mode("streaming", "enable_wal")
        if self._wal is not None:
            raise ServiceLifecycleError("enable_wal() called twice")
        if self._engine.ingester.num_events:
            raise ServiceLifecycleError(
                "enable_wal() must run before any traffic — events ingested "
                "pre-WAL would be unrecoverable")
        os.makedirs(root, exist_ok=True)
        self._wal_root = root
        self.config.save(os.path.join(root, "service.json"))
        for v, p in self._models.items():
            self._persist_params(p, v)
        with open(os.path.join(root, "genesis.json"), "w") as f:
            json.dump({"state": self._state,
                       "model_version": self._model_version,
                       "versions": sorted(self._models)}, f)
        self._wal = ckpt.WriteAheadLog(ckpt.wal_path(root), fsync=fsync)
        self._applied_seq = self._wal.last_seq
        return self

    @property
    def applied_seq(self) -> int:
        """Highest WAL seqno whose apply completed (0 = none / WAL off)."""
        return self._applied_seq

    def checkpoint(self, compact: bool = False) -> str:
        """Write one atomic checkpoint of the full streaming state at the
        current ``applied_seq``; with ``compact=True`` also drop the WAL
        prefix the checkpoint covers.  Returns the checkpoint directory.

        Quiesces the async refresh thread first (an in-flight stage 1 is
        mid-effect and has no consistent snapshot) but does NOT flush the
        worker queues — queued requests are checkpointed as queued, so the
        restored run's flush compositions (and hence its bit-exact scores)
        are unchanged."""
        from repro_torch.stream import checkpoint as ckpt

        self._ensure(_SERVABLE, "checkpoint")
        self._require_mode("streaming", "checkpoint")
        if self._wal is None:
            raise ServiceLifecycleError(
                "checkpoint() requires enable_wal() — a checkpoint without "
                "a log cannot bound what replay owes")
        self._engine.refresher.drain()
        path = ckpt.write_checkpoint(self._wal_root, self, self._applied_seq)
        if compact:
            self._wal.compact(self._applied_seq)
        return path

    def enable_auto_checkpoint(self, every_s: float | None = None,
                               every_windows: int | None = None,
                               keep_last: int | None = None,
                               clock=time.monotonic) -> "FraudService":
        """Arm scheduled checkpointing: after each applied event, a
        compacting :meth:`checkpoint` fires once ``every_s`` wall seconds
        have elapsed and/or ``every_windows`` snapshot windows have closed
        since the last one; ``keep_last`` additionally prunes all but the
        newest N ``ckpt-*`` directories (``prune_checkpoints``).

        Long runs stay bounded on disk: the WAL is truncated up to each
        checkpoint's ``applied_seq`` (open reader pins clamp the
        truncation — see ``WriteAheadLog.compact``) and old checkpoint
        directories age out.  ``clock`` is injectable for tests.  Cadence
        state is process-local: a restored service re-arms via this call."""
        if self._wal is None:
            raise ServiceLifecycleError(
                "enable_auto_checkpoint() requires enable_wal() first")
        if every_s is None and every_windows is None:
            raise ServiceLifecycleError(
                "enable_auto_checkpoint() needs every_s and/or every_windows")
        if every_s is not None and every_s <= 0:
            raise ValueError("every_s must be > 0 or None")
        if every_windows is not None and every_windows < 1:
            raise ValueError("every_windows must be >= 1 or None")
        if keep_last is not None and keep_last < 1:
            raise ValueError("keep_last must be >= 1 or None")
        self._auto_ckpt = {
            "every_s": every_s, "every_windows": every_windows,
            "keep_last": keep_last, "clock": clock,
            "last_t": clock(),
            "last_windows": self._engine.ingester.stats["windows_closed"],
            "checkpoints": 0, "pruned": 0,
        }
        return self

    def _maybe_auto_checkpoint(self) -> None:
        """Fire the scheduled checkpoint when its cadence is due (called
        after each applied submit/ingest; never during WAL replay)."""
        ac = self._auto_ckpt
        if ac is None or self._replaying or self._wal is None:
            return
        windows = self._engine.ingester.stats["windows_closed"]
        due = (ac["every_s"] is not None
               and ac["clock"]() - ac["last_t"] >= ac["every_s"])
        due = due or (ac["every_windows"] is not None
                      and windows - ac["last_windows"] >= ac["every_windows"])
        if not due:
            return
        self.checkpoint(compact=True)
        ac["last_t"] = ac["clock"]()
        ac["last_windows"] = windows
        ac["checkpoints"] += 1
        if ac["keep_last"] is not None:
            from repro_torch.stream import checkpoint as ckpt

            ac["pruned"] += len(
                ckpt.prune_checkpoints(self._wal_root, ac["keep_last"]))

    @classmethod
    def restore(cls, root: str, device=None) -> "FraudService":
        """Rebuild the service from WAL root ``root``: load the newest
        committed checkpoint (if any), then replay the log suffix with
        ``seq > applied_seq`` through the ordinary serving paths —
        **exactly once**: duplicate delivery is suppressed by seqno, and a
        record whose apply the crash interrupted is re-applied in full.

        The restored service keeps logging to the same WAL, so crash →
        restore → crash → restore chains compose.  Recovery details
        (checkpoint used, records replayed, responses produced during
        replay, seconds taken) land in ``self.last_recovery``.  ``root`` may
        have been written by either package; the models are restored onto
        ``device`` (default: CUDA)."""
        from repro_torch.models.hybrid import load_model_file
        from repro_torch.stream import checkpoint as ckpt

        t0 = time.perf_counter()
        dev = resolve_device(device)
        config = ServiceConfig.load(os.path.join(root, "service.json"))
        with open(os.path.join(root, "genesis.json")) as f:
            genesis = json.load(f)
        lnn_cfg = config.to_lnn_config()

        found = ckpt.latest_checkpoint(root)
        if found is not None:
            manifest, arrays = ckpt.read_checkpoint(found)
            registry = {int(v): p for v, p in manifest["models"].items()}
            active = int(manifest["model_version"])
            applied = int(manifest["applied_seq"])
        else:
            manifest = arrays = None
            registry = {int(v): os.path.join("models", f"v{v}.npz")
                        for v in genesis["versions"]}
            active = int(genesis["model_version"])
            applied = 0

        svc = cls(config, device=dev)
        svc._wal_root = root
        for v in sorted(registry):
            params = load_model_file(os.path.join(root, registry[v]), lnn_cfg, dev)
            svc.register_model(params, v)
        svc._params = svc._models[active]
        svc._model_version = active
        svc.build()
        if manifest is not None:
            ckpt.apply_checkpoint(svc, manifest, arrays)
        else:
            svc._state = genesis["state"]

        wal = ckpt.WriteAheadLog(ckpt.wal_path(root))
        svc._wal = wal
        svc._applied_seq = applied
        svc._replaying = True
        responses: list[ScoreResponse] = []
        replayed = 0
        try:
            for rec in wal.scan(after_seq=applied):
                if rec["kind"] == "model":
                    params = load_model_file(os.path.join(root, rec["path"]), lnn_cfg, dev)
                    svc.load_model(params, rec["version"])
                elif rec["kind"] == "drain":
                    responses.extend(svc.drain(rec["now"]))
                elif rec["kind"] == "submit":
                    responses.extend(svc.submit(ckpt.decode_event(rec)))
                else:
                    svc.ingest(ckpt.decode_event(rec))
                svc._applied_seq = int(rec["seq"])
                replayed += 1
        finally:
            svc._replaying = False
        svc.last_recovery = {
            "checkpoint": found,
            "applied_seq": svc._applied_seq,
            "replayed_records": replayed,
            "events_applied": svc._engine.ingester.num_events,
            "responses": responses,
            "seconds": time.perf_counter() - t0,
        }
        return svc

    # ----------------------------------------------------------------- stats
    def _account_scored(self, results: list) -> None:
        """Count delivered scores, split per model version (only admitted
        responses were actually scored by a version's weights)."""
        self._acct["scored"] += len(results)
        for r in results:
            v = int(r.model_version)
            self._scores_by_version[v] = self._scores_by_version.get(v, 0) + 1

    def stats(self) -> ServiceStats:
        """One structured snapshot of the whole service (``to_dict()`` is
        its JSON form)."""
        acct = self._acct
        st = ServiceStats(
            mode=self.mode, state=self._state,
            model_version=self._model_version,
            model_versions=self.model_versions(),
            model_swaps=self._model_swaps,
            requests=acct["requests"], scored=acct["scored"],
            shed=acct["shed"], blocked=acct["blocked"],
            block_timeouts=acct["block_timeouts"],
            queue_depth_peak=acct["queue_depth_peak"],
            in_flight_peak=acct["in_flight_peak"],
            scores_by_version=dict(self._scores_by_version),
            shadow=self.shadow_stats(),
            rollbacks=acct["rollbacks"],
            last_good_version=self._last_good,
        )
        if self.store is not None:
            st.store_size = len(self.store)
            st.store_stats = dict(self.store.stats)
            st.model_stale_reads = self.store.stats["model_stale_reads"]
        if self.mode == "streaming" and self._engine is not None:
            pool = self._engine.pool
            st.queue_depth = len(pool)
            st.flushes = pool.stats["flushes"]
            st.refreshes = self._engine.refresher.stats["refreshes"]
            st.entities_written = self._engine.refresher.stats["entities_written"]
            # ONE worker_summary() call: the typed field and the extra
            # entry alias the same tear-free snapshot
            workers = pool.worker_summary()
            st.workers = workers
            st.extra = {"pool": dict(pool.stats), "workers": workers}
            if self._autoscaler is not None:
                st.extra["autoscaler"] = dict(self._autoscaler.stats)
        elif self._batch_layer is not None:
            st.extra = {"speed_k_max": self.config.engine.k_max}
        if self._auto_ckpt is not None:
            st.extra = dict(st.extra or {})
            st.extra["auto_checkpoint"] = {
                "checkpoints": self._auto_ckpt["checkpoints"],
                "pruned": self._auto_ckpt["pruned"]}
        return st

    # ------------------------------------------------------------- internals
    def _require_mode(self, mode: str, op: str) -> None:
        if self.mode != mode:
            raise ServiceLifecycleError(
                f"FraudService.{op}() requires mode={mode!r}; this service "
                f"runs mode={self.mode!r}")

    @property
    def engine(self):
        """The wrapped StreamingEngine (streaming mode) — internals access
        for benches and tests; scoring must go through the facade."""
        return self._engine

    def __enter__(self) -> "FraudService":
        if self._state == "created":
            self.build()
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def build_service(config: ServiceConfig, params, *,
                  warmup: bool = False, device=None) -> FraudService:
    """One-liner construction: ``build()`` (and optionally ``warmup()``)."""
    svc = FraudService(config, params=params, device=device).build()
    return svc.warmup() if warmup else svc


def _map_sorted(fn, tree):
    """``tree`` with ``fn`` applied to each leaf, the leaves visited in the
    order ``jax.tree_util`` flattens a tree (dict keys sorted, lists in
    order) — the order the reference draws per-leaf noise in."""
    if isinstance(tree, dict):
        return {k: _map_sorted(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_map_sorted(fn, v) for v in tree]
    return fn(tree)


__all__ = ["FraudService", "ServiceLifecycleError", "build_service"]
