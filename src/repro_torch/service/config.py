"""``ServiceConfig`` — one serializable config tree for every serving path.

The artifact the port's :class:`~repro_torch.service.FraudService` is built
from, in the reference's layout (``repro.service.config``), section for
section and key for key, so an artifact either package writes the other
loads (``to_json`` of one config gives the same text in both):

* :class:`ModelSection`     — the LNN itself (mirrors ``LNNConfig``);
* :class:`EngineSection`    — speed-layer scheduling: micro-batch triggers,
  worker count, virtual service model, DDS ingest knobs;
* :class:`WorkersSection`   — how workers are realized (inline or process);
* :class:`StoreSection`     — KV store: capacity / TTL / sharding;
* :class:`RefreshSection`   — batch-layer cadence and threading;
* :class:`AdmissionSection` — overload policy: queue-depth / in-flight caps
  with shed-vs-block and a bounded block wait;
* :class:`GatewaySection`   — the HTTP front-end's knobs;
* :class:`LearnSection`     — the continuous-learning plane's knobs.

The port has no HTTP front-end and no learning plane yet (ROADMAP.md queue
1); their sections are kept so that an artifact round-trips whole.

The tree round-trips through ``to_dict``/``from_dict`` and JSON
(``to_json``/``from_json``, ``save``/``load``), with **unknown-key
rejection** at every level — a typo'd artifact fails loudly at load time,
never as a silently-defaulted knob.  Params travel separately as a
checkpoint.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field

from repro_torch.core.lnn import LNNConfig


def _section_from_dict(cls, d: dict, path: str):
    """Build a section dataclass from a plain dict, rejecting unknown keys
    (``path`` names the offending subtree in the error)."""
    if not isinstance(d, dict):
        raise TypeError(f"{path}: expected a dict, got {type(d).__name__}")
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(
            f"unknown key(s) {unknown} in {path} — valid keys: {sorted(names)}"
        )
    return cls(**d)


@dataclass(frozen=True)
class ModelSection:
    """The LNN model — field-for-field mirror of the reference's
    ``LNNConfig`` so a service artifact fully determines the architecture.
    ``use_pallas`` selects the reference's Pallas path and is kept so its
    artifacts load; the port ignores it (a CUDA tensor always launches the
    hand-written kernel, see ``kernels.ops``)."""

    gnn_type: str = "gcn"            # 'gcn' | 'gat' | 'sage'
    num_gnn_layers: int = 3
    hidden_dim: int = 64
    mlp_dims: tuple = (64, 32)
    feat_dim: int = 16
    use_pallas: bool = False
    pos_weight: float = 1.0
    # heterogeneous vocabulary (e.g. core.hetero.ENTITY_TYPE_NAMES); empty =
    # homogeneous model, no per-type towers, untagged entity ids accepted
    entity_types: tuple = ()

    def __post_init__(self):
        # JSON round-trips tuples as lists; normalize back
        object.__setattr__(self, "mlp_dims", tuple(self.mlp_dims))
        object.__setattr__(self, "entity_types",
                           tuple(str(t) for t in self.entity_types))

    def to_lnn_config(self) -> LNNConfig:
        kw = dataclasses.asdict(self)
        kw.pop("use_pallas")
        return LNNConfig(**kw)

    @classmethod
    def from_lnn_config(cls, cfg: LNNConfig) -> "ModelSection":
        return cls(**dataclasses.asdict(cfg))


@dataclass(frozen=True)
class EngineSection:
    """Speed-layer scheduling + ingest knobs (the old ``EngineConfig``)."""

    k_max: int = 8                  # entity slots per request
    max_batch: int = 16             # micro-batch size trigger (per worker)
    max_wait_s: float = 0.005       # micro-batch deadline trigger (virtual s)
    entity_history: str = "all"     # DDS history mode (see core.dds)
    max_history: int | None = 8
    max_deg: int = 32               # padded in-degree for the batch graph
    num_workers: int = 1            # sharded micro-batch queues (1 = classic)
    service_model_s: float = 0.0    # virtual service time per flush
    steal_threshold: int | None = None   # queue depth that triggers stealing

    def __post_init__(self):
        if self.num_workers < 1:
            raise ValueError("engine.num_workers must be >= 1")
        if self.max_batch < 1:
            raise ValueError("engine.max_batch must be >= 1")


@dataclass(frozen=True)
class WorkersSection:
    """Speed-layer worker *backend* — how workers are realized, orthogonal
    to how many there are (``engine.num_workers``).

    * ``backend="inline"`` (default) — workers simulated inside the serving
      process: private weight packs, shared GIL and address space.  Zero
      startup cost, the right choice for tests, replay analysis, and
      latency-bound single-core deployments.
    * ``backend="process"`` — each worker a spawned OS process owning its
      KV shard, its stage-2 calls and the stage-1 bins of a refresh, on the
      service's device (``repro_torch.stream.procpool``): compute off the
      serving GIL, for one spawn and one CUDA context per worker.
    * ``ring_bytes`` — per-worker shared-memory ring capacity for SCORE
      feature payloads (oversized batches fall back to in-frame copies).
    """

    backend: str = "inline"         # 'inline' | 'process'
    ring_bytes: int = 1 << 20       # shm ring capacity per worker process

    def __post_init__(self):
        if self.backend not in ("inline", "process"):
            raise ValueError(
                f"workers.backend must be 'inline' or 'process', "
                f"got {self.backend!r}")
        if self.ring_bytes < 4096:
            raise ValueError("workers.ring_bytes must be >= 4096")


@dataclass(frozen=True)
class StoreSection:
    """KV store bounds and layout."""

    capacity: int | None = None          # LRU cap (None = unbounded)
    ttl_seconds: float | None = None     # lazy expiry (None = no expiry)
    num_shards: int = 4                  # shard-by-key count
    # None = auto: entity-affine shards (num_shards == num_workers) when
    # the engine runs multiple workers, classic key-spread otherwise
    shard_by_entity: bool | None = None


@dataclass(frozen=True)
class RefreshSection:
    """Batch-layer cadence and scope.

    ``community_local=True`` (default) re-runs stage 1 only over the
    connected components of the order↔entity graph that contain dirty
    ``(entity, t)`` pairs — bit-identical to the whole-graph refresh but
    O(dirty communities) instead of O(total stream) per run (see
    ``repro_torch.stream.refresh``).  ``community_size`` is the node budget per
    stage-1 launch: dirty communities are bin-packed up to it, and each bin
    is padded to a power-of-two so stage 1 sees few shapes as communities
    grow.
    """

    refresh_every: int = 1          # closed windows per refresh (1 = exact)
    async_refresh: bool = False     # stage 1 on a background thread
    community_local: bool = True    # refresh only dirty communities (exact)
    community_size: int = 4096      # node budget per stage-1 refresh launch

    def __post_init__(self):
        if self.refresh_every < 1:
            raise ValueError("refresh.refresh_every must be >= 1")
        if self.community_size < 1:
            raise ValueError("refresh.community_size must be >= 1")


@dataclass(frozen=True)
class AdmissionSection:
    """Overload policy.  ``None`` caps disable the corresponding check.

    * ``max_queue_depth`` — total queued requests across workers a new
      request may observe; at the cap, ``shed`` rejects it (NaN score,
      ``admitted=False``) while ``block`` force-flushes the deepest queue
      until there is room (the producer stalls — backpressure).
    * ``max_in_flight`` — concurrently busy workers (open virtual service
      windows); at the cap, ``shed`` rejects, ``block`` admits but counts
      the stall.
    * ``block_max_wait_s`` — wall-clock bound on one block-policy stall.
      ``None`` keeps the legacy unbounded wait (the producer stalls until
      force-flushing frees capacity, and is admitted over-cap if it never
      does); a finite value times the stall out and **sheds** the request
      instead (counted in ``ServiceStats.block_timeouts``), which the HTTP
      gateway maps to ``503 Service Unavailable``.
    """

    max_queue_depth: int | None = None
    max_in_flight: int | None = None
    policy: str = "shed"            # 'shed' | 'block'
    block_max_wait_s: float | None = None   # wall bound on a block stall
    # ---------------------------------------- queue-depth autoscaling
    # watermark-with-hysteresis control over the worker count (and the
    # steal threshold) driven by observed queue depth — see
    # repro_torch.stream.workers.DepthAutoscaler.  Both backends support it;
    # the process backend reshards by respawning shard processes and
    # re-placing KV entries under the new rendezvous layout.
    autoscale: bool = False         # grow/shrink workers via pool.reshard
    autoscale_min_workers: int = 1
    autoscale_max_workers: int = 8
    autoscale_high_depth: float = 8.0    # mean depth/worker that arms growth
    autoscale_low_depth: float = 1.0     # mean depth/worker that arms shrink
    autoscale_sustain: int = 16     # consecutive observations before acting
    autoscale_cooldown: int = 64    # observations ignored after a reshard
    adaptive_steal: bool = False    # re-derive steal_threshold from depth

    def __post_init__(self):
        if self.policy not in ("shed", "block"):
            raise ValueError(
                f"admission.policy must be 'shed' or 'block', got {self.policy!r}"
            )
        for name in ("max_queue_depth", "max_in_flight"):
            v = getattr(self, name)
            if v is not None and v < 1:
                raise ValueError(f"admission.{name} must be >= 1 or None")
        if self.block_max_wait_s is not None and self.block_max_wait_s < 0:
            raise ValueError("admission.block_max_wait_s must be >= 0 or None")
        if not 1 <= self.autoscale_min_workers <= self.autoscale_max_workers:
            raise ValueError(
                "need 1 <= admission.autoscale_min_workers <= "
                "admission.autoscale_max_workers")
        if self.autoscale_low_depth >= self.autoscale_high_depth:
            raise ValueError(
                "admission.autoscale_low_depth must be < autoscale_high_depth")
        if self.autoscale_sustain < 1:
            raise ValueError("admission.autoscale_sustain must be >= 1")
        if self.autoscale_cooldown < 0:
            raise ValueError("admission.autoscale_cooldown must be >= 0")


@dataclass(frozen=True)
class GatewaySection:
    """HTTP front-end knobs (the reference's ``repro.gateway``; not ported yet).

    * ``host`` / ``port`` — bind address; port 0 asks the kernel for an
      ephemeral port (tests, CI smoke) which ``FraudGateway.port`` reports.
    * ``retry_after_s`` — the hint sent in the ``Retry-After`` header of a
      ``429`` shed response (seconds, rendered at millisecond precision).
    * ``max_body_bytes`` — request bodies above this are refused with
      ``413`` before JSON parsing (socket-level overload protection).
    * ``shadow_fraction`` / ``shadow_divergence_threshold`` — canary
      defaults: the fraction of scored traffic re-scored off the response
      path by the shadow model version, and the |primary − shadow| score
      gap that trips the divergence alert (``POST /admin/model`` with
      ``role="canary"`` may override both per activation).
    * ``latency_buckets`` — upper bounds (seconds) of the Prometheus
      request-latency histogram.
    * ``checkpoint_dir`` — when set, the gateway boots crash-consistent:
      ``serve_gateway`` restores the service from this directory if a
      durable state exists there (``FraudService.restore``), otherwise
      builds fresh and enables the write-ahead log under it
      (``enable_wal``).  ``POST /admin/checkpoint`` writes checkpoints
      into the same directory.
    * ``checkpoint_every_s`` / ``checkpoint_every_windows`` /
      ``checkpoint_keep_last`` — scheduled-checkpoint cadence wired into
      ``FraudService.enable_auto_checkpoint`` at boot (requires
      ``checkpoint_dir``): write a compacting checkpoint after this many
      wall seconds and/or closed snapshot windows, retaining only the
      newest ``checkpoint_keep_last`` ``ckpt-*`` directories.
    * ``auto_rollback`` — when True, a sticky shadow-divergence alert
      observed after canary scoring triggers an automatic
      ``FraudService.rollback_model`` to the last-good version (counted
      in ``rollbacks_total``) instead of page-only alerting.
    """

    host: str = "127.0.0.1"
    port: int = 0                   # 0 = ephemeral (kernel-assigned)
    retry_after_s: float = 0.05     # 429 Retry-After hint
    max_body_bytes: int = 1 << 20   # 413 above this
    shadow_fraction: float = 0.0    # default canary sampling fraction
    shadow_divergence_threshold: float = 0.25
    latency_buckets: tuple = (0.001, 0.0025, 0.005, 0.01, 0.025,
                              0.05, 0.1, 0.25, 1.0)
    checkpoint_dir: str | None = None   # durable WAL + checkpoint root
    checkpoint_every_s: float | None = None      # scheduled-ckpt wall cadence
    checkpoint_every_windows: int | None = None  # ...and/or closed-window cadence
    checkpoint_keep_last: int | None = None      # retention: keep newest N
    auto_rollback: bool = False     # sticky shadow alert -> rollback_model()

    def __post_init__(self):
        object.__setattr__(self, "latency_buckets",
                           tuple(float(b) for b in self.latency_buckets))
        if not 0 <= self.port <= 65535:
            raise ValueError("gateway.port must be in [0, 65535]")
        if not 0.0 <= self.shadow_fraction <= 1.0:
            raise ValueError("gateway.shadow_fraction must be in [0, 1]")
        if self.shadow_divergence_threshold < 0:
            raise ValueError("gateway.shadow_divergence_threshold must be >= 0")
        if self.max_body_bytes < 1:
            raise ValueError("gateway.max_body_bytes must be >= 1")
        if self.retry_after_s < 0:
            raise ValueError("gateway.retry_after_s must be >= 0")
        if list(self.latency_buckets) != sorted(set(self.latency_buckets)):
            raise ValueError("gateway.latency_buckets must be strictly increasing")
        if self.checkpoint_every_s is not None and self.checkpoint_every_s <= 0:
            raise ValueError("gateway.checkpoint_every_s must be > 0 or None")
        if self.checkpoint_every_windows is not None \
                and self.checkpoint_every_windows < 1:
            raise ValueError(
                "gateway.checkpoint_every_windows must be >= 1 or None")
        if self.checkpoint_keep_last is not None and self.checkpoint_keep_last < 1:
            raise ValueError("gateway.checkpoint_keep_last must be >= 1 or None")


@dataclass(frozen=True)
class LearnSection:
    """Continuous-learning plane knobs (the reference's ``repro.learn``; not
    ported yet).

    The WAL training tap, rolling-window trainer, and shadow-gated
    promotion controller are configured here; ``enabled=True`` makes
    ``serve_gateway`` attach a ``ContinuousLearner``
    (which needs ``gateway.checkpoint_dir`` for the WAL tap) and exposes
    ``POST /admin/train`` + ``GET /v1/learn/stats``.

    Window policy (Morpheus-DFP-style rolling window): a fine-tune fires
    once ``min_window`` new labeled examples accumulated; it trains on the
    newest ``max_window`` examples (per-window dedup by order id when
    ``dedup``), then the window advances by ``stride`` examples.

    Promotion: each candidate registers as a canary
    (``FraudService.enable_shadow``) sampled at ``shadow_fraction``; after
    ``min_eval`` labeled shadow samples (with at least ``min_eval_pos``
    positives), the candidate promotes only when its recall@``eval_budget``
    beats the incumbent's by ``promote_margin``.  Post-promotion, the
    displaced incumbent keeps shadow-scoring as the watch reference:
    divergence alerts or a recall drop of ``rollback_margin`` (after
    ``watch_min_eval`` labeled samples) auto-roll back to last-good.
    """

    enabled: bool = False
    # WAL tap / delayed-label join
    label_latency_s: float = 0.0    # 0 = event labels are final at ingest
    include_ingest: bool = True     # backfill events become examples too
    # rolling-window trainer
    min_window: int = 32            # new examples that arm a fine-tune
    max_window: int = 256           # newest examples per training window
    stride: int = 32                # examples consumed per window advance
    dedup: bool = True              # per-window dedup by order id
    optimizer: str = "adam"         # 'sgd' | 'adam'
    lr: float = 5e-3
    steps: int = 40                 # optimizer steps per fine-tune
    head: str = "mlp"               # 'mlp' | 'hybrid' (GBDT head retrain)
    gbdt_trees: int = 25            # booster size for head='hybrid'
    # run each fine-tune in a dedicated trainer process (off the serving
    # GIL): the window ships as an npz, candidate params come back as an
    # npz blob through the normal register/promotion path.  Deterministic:
    # the child runs the same _train_window on the same bytes.
    train_in_process: bool = False
    # promotion controller
    shadow_fraction: float = 1.0    # canary sampling during candidate eval
    promote_margin: float = 0.02    # candidate recall must beat incumbent by
    min_eval: int = 32              # labeled shadow samples before a verdict
    min_eval_pos: int = 3           # ...of which positives
    eval_budget: float = 0.15       # review-budget fraction for recall@budget
    eval_max: int = 4096            # eval-buffer cap (bounded memory)
    rollback_margin: float = 0.05   # post-promotion recall drop that rolls back
    watch_min_eval: int = 32        # labeled watch samples before rollback check
    watch_divergence_threshold: float = 5.0   # watch-phase alert threshold

    def __post_init__(self):
        if self.optimizer not in ("sgd", "adam"):
            raise ValueError(
                f"learn.optimizer must be 'sgd' or 'adam', got {self.optimizer!r}")
        if self.head not in ("mlp", "hybrid"):
            raise ValueError(
                f"learn.head must be 'mlp' or 'hybrid', got {self.head!r}")
        for name in ("min_window", "max_window", "stride", "steps",
                     "gbdt_trees", "min_eval", "min_eval_pos", "eval_max",
                     "watch_min_eval"):
            if getattr(self, name) < 1:
                raise ValueError(f"learn.{name} must be >= 1")
        if self.max_window < self.min_window:
            raise ValueError("learn.max_window must be >= learn.min_window")
        if self.stride > self.max_window:
            raise ValueError("learn.stride must be <= learn.max_window")
        if self.label_latency_s < 0:
            raise ValueError("learn.label_latency_s must be >= 0")
        if not 0.0 < self.shadow_fraction <= 1.0:
            raise ValueError("learn.shadow_fraction must be in (0, 1]")
        if not 0.0 < self.eval_budget <= 1.0:
            raise ValueError("learn.eval_budget must be in (0, 1]")
        if self.lr <= 0:
            raise ValueError("learn.lr must be > 0")
        for name in ("promote_margin", "rollback_margin",
                     "watch_divergence_threshold"):
            if getattr(self, name) < 0:
                raise ValueError(f"learn.{name} must be >= 0")


_SECTIONS = {
    "model": ModelSection,
    "engine": EngineSection,
    "workers": WorkersSection,
    "store": StoreSection,
    "refresh": RefreshSection,
    "admission": AdmissionSection,
    "gateway": GatewaySection,
    "learn": LearnSection,
}


@dataclass(frozen=True)
class ServiceConfig:
    """The one artifact every serving entry point is constructed from."""

    mode: str = "streaming"         # 'batch' | 'streaming'
    model: ModelSection = field(default_factory=ModelSection)
    engine: EngineSection = field(default_factory=EngineSection)
    workers: WorkersSection = field(default_factory=WorkersSection)
    store: StoreSection = field(default_factory=StoreSection)
    refresh: RefreshSection = field(default_factory=RefreshSection)
    admission: AdmissionSection = field(default_factory=AdmissionSection)
    gateway: GatewaySection = field(default_factory=GatewaySection)
    learn: LearnSection = field(default_factory=LearnSection)

    def __post_init__(self):
        if self.mode not in ("batch", "streaming"):
            raise ValueError(f"mode must be 'batch' or 'streaming', got {self.mode!r}")

    # ------------------------------------------------------------- conversion
    def to_lnn_config(self) -> LNNConfig:
        return self.model.to_lnn_config()

    def to_engine_config(self):
        """The ``repro_torch.stream.EngineConfig`` equivalent (the engine the
        streaming facade wraps is built from this)."""
        from repro_torch.stream.engine import EngineConfig

        e, s, r = self.engine, self.store, self.refresh
        return EngineConfig(
            k_max=e.k_max, max_batch=e.max_batch, max_wait_s=e.max_wait_s,
            refresh_every=r.refresh_every, community_local=r.community_local,
            community_size=r.community_size, entity_history=e.entity_history,
            max_history=e.max_history, max_deg=e.max_deg,
            async_refresh=r.async_refresh, store_capacity=s.capacity,
            store_ttl_s=s.ttl_seconds, store_shards=s.num_shards,
            num_workers=e.num_workers, service_model_s=e.service_model_s,
            steal_threshold=e.steal_threshold, shard_by_entity=s.shard_by_entity,
            backend=self.workers.backend,
        )

    # ---------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ServiceConfig":
        if not isinstance(d, dict):
            raise TypeError(f"ServiceConfig: expected a dict, got {type(d).__name__}")
        unknown = sorted(set(d) - set(_SECTIONS) - {"mode"})
        if unknown:
            raise ValueError(
                f"unknown key(s) {unknown} in ServiceConfig — valid keys: "
                f"{['mode', *sorted(_SECTIONS)]}"
            )
        sections = {
            name: _section_from_dict(sec_cls, d.get(name, {}), f"ServiceConfig.{name}")
            for name, sec_cls in _SECTIONS.items()
        }
        return cls(mode=d.get("mode", "streaming"), **sections)

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "ServiceConfig":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "ServiceConfig":
        with open(path) as f:
            return cls.from_json(f.read())

    # -------------------------------------------------------------- ergonomics
    def replace(self, **kwargs) -> "ServiceConfig":
        """``dataclasses.replace`` convenience accepting section dicts too:
        ``cfg.replace(engine={"num_workers": 4})`` rebuilds only the named
        section fields (unknown keys rejected as in ``from_dict``)."""
        resolved = {}
        for k, v in kwargs.items():
            if k in _SECTIONS and isinstance(v, dict):
                cur = getattr(self, k)
                merged = {**dataclasses.asdict(cur), **v}
                resolved[k] = _section_from_dict(
                    _SECTIONS[k], merged, f"ServiceConfig.{k}")
            else:
                resolved[k] = v
        return dataclasses.replace(self, **resolved)
