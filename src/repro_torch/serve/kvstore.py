"""Key-value embedding store — the paper's "distributed key-value store"
(production would be Couchbase/Redis; here an in-memory store with an
npz-backed persistence path and the same access pattern: batched point
lookups by entity key).

Keys are (entity_id, snapshot) pairs packed into int64; values are stage-1
entity embeddings.  ``lookup_batch`` returns a dense [B, K, H] tensor plus
mask — exactly the speed-layer input.

Serving-engine upgrades on top of the plain dict store:

* **shard-by-key** — entries hash over ``num_shards`` independent shards
  (the access pattern a real distributed KV imposes; eviction is per shard);
* **versioned puts** — every entry carries the batch-layer refresh version
  that wrote it, so the speed layer can report embedding staleness;
* **TTL / LRU eviction** — bounded memory under unbounded streams: a
  ``capacity`` cap evicts least-recently-used entries per shard, an optional
  ``ttl_seconds`` expires entries lazily on read;
* **snapshot fallback** — ``lookup_batch_versioned`` serves the freshest
  available snapshot ≤ the requested one when the exact key is missing
  (the batch layer hasn't caught up yet), reporting per-slot staleness in
  snapshots — the Lambda trade-off made measurable.
"""
from __future__ import annotations

import threading
import time
from bisect import bisect_right
from collections import OrderedDict

import numpy as np

from repro_torch.core.hetero import is_typed
from repro_torch.dist.sharding import rendezvous_shard, stable_shard
from repro_torch.utils import crashpoint

SNAPSHOT_BITS = 20
MAX_SNAPSHOT = (1 << SNAPSHOT_BITS) - 1
MAX_ENTITY = (1 << (63 - SNAPSHOT_BITS)) - 1


def _reject_untagged(entity: int) -> None:
    """Raise for an untagged entity id reaching a heterogeneous keyspace.

    With ``require_typed`` set, a legacy (untagged) id must fail loudly:
    silently admitting it would collapse buyer and device ids into one
    keyspace (identical raw ids shard — and collide — together)."""
    if not is_typed(entity):
        raise ValueError(
            f"entity id {int(entity)} carries no type tag but this keyspace "
            "is heterogeneous (require_typed=True) — tag ids with "
            "repro_torch.core.hetero.tag_entity to keep per-type keyspaces disjoint")


def pack_key(entity: int, snapshot: int, require_typed: bool = False) -> int:
    """Pack (entity, snapshot) into one int64: entity << 20 | snapshot.

    Guards the packing domain — out-of-range inputs used to alias other
    entities' keys silently (e.g. snapshot 2^20 bled into entity bits).
    ``require_typed`` additionally rejects entity ids without a
    :mod:`repro_torch.core.hetero` type tag (heterogeneous keyspaces).
    """
    e, t = int(entity), int(snapshot)
    if not 0 <= t <= MAX_SNAPSHOT:
        raise ValueError(f"snapshot {t} outside [0, {MAX_SNAPSHOT}] — would collide")
    if not 0 <= e <= MAX_ENTITY:
        raise ValueError(f"entity {e} outside [0, {MAX_ENTITY}] — would collide")
    if require_typed:
        _reject_untagged(e)
    return (e << SNAPSHOT_BITS) | t


def unpack_key(key: int) -> tuple[int, int]:
    """Inverse of :func:`pack_key`: ``(entity, snapshot)`` from one int64."""
    return int(key) >> SNAPSHOT_BITS, int(key) & MAX_SNAPSHOT


def entity_shard(entity: int, num_shards: int,
                 require_typed: bool = False) -> int:
    """Shard an *entity* (all its snapshots together) over ``num_shards``.

    Rendezvous placement over the entity id — the same function the
    speed-layer :class:`~repro.stream.workers.ShardRouter` uses, so a store
    built with ``shard_by_entity=True`` and ``num_shards == num_workers``
    puts every snapshot of an entity on exactly the worker that scores its
    requests (key-affinity, see docs/streaming.md).  ``require_typed``
    rejects untagged ids — sharding them would silently collapse per-type
    keyspaces (see :func:`pack_key`).
    """
    if require_typed:
        _reject_untagged(entity)
    return rendezvous_shard(int(entity), num_shards)


class _Entry:
    __slots__ = ("value", "version", "stamp", "model_version")

    def __init__(self, value, version, stamp, model_version=0):
        self.value = value
        self.version = version
        self.stamp = stamp
        # which parameter version computed this embedding: a hot-swapped
        # model makes pre-swap embeddings detectably stale (see
        # lookup_batch_versioned's expected_model_version)
        self.model_version = model_version


class KVStore:
    """In-memory sharded KV store for stage-1 entity embeddings.

    ``capacity``: max total entries (None = unbounded); enforced per shard
    with LRU order (gets refresh recency).  ``ttl_seconds``: entries older
    than this expire lazily on access.  ``clock``: injectable time source
    for deterministic TTL tests.  ``require_typed``: heterogeneous mode —
    every write or versioned read whose entity id lacks a
    :mod:`repro_torch.core.hetero` type tag raises instead of silently sharing
    the untyped keyspace.
    """

    def __init__(
        self,
        dim: int,
        capacity: int | None = None,
        ttl_seconds: float | None = None,
        num_shards: int = 1,
        clock=time.time,
        shard_by_entity: bool = False,
        require_typed: bool = False,
    ):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.dim = dim
        self.capacity = capacity
        self.ttl_seconds = ttl_seconds
        self.num_shards = num_shards
        self.shard_by_entity = shard_by_entity
        self.require_typed = bool(require_typed)
        self._clock = clock
        self._shards: list[OrderedDict[int, _Entry]] = [
            OrderedDict() for _ in range(num_shards)
        ]
        # per-entity sorted snapshot index, for the fallback lookup
        self._snaps: dict[int, list[int]] = {}
        # one coarse lock: the async refresh driver writes from a worker
        # thread while the speed layer reads (reads also mutate — LRU
        # touch, lazy TTL expiry), and the snapshot index must stay
        # consistent with the shards.  RLock: batched reads call get().
        self._lock = threading.RLock()
        self.stats = {"puts": 0, "gets": 0, "misses": 0,
                      "evictions": 0, "expired": 0, "stale_hits": 0,
                      "model_stale_reads": 0}

    # ---------------------------------------------------------------- shards
    def shard_of(self, key: int) -> int:
        """Shard index for a packed (entity, snapshot) key.

        Default: splitmix avalanche over the whole key, so consecutive
        snapshots spread shards (load balance).  ``shard_by_entity=True``
        switches to rendezvous placement over the entity bits alone, so all
        snapshots of an entity co-locate — the layout the multi-worker
        speed layer needs for key-affine routing (workers own whole
        entities, not scattered snapshots)."""
        if self.shard_by_entity:
            return entity_shard(int(key) >> SNAPSHOT_BITS, self.num_shards,
                                require_typed=self.require_typed)
        if self.require_typed:
            _reject_untagged(int(key) >> SNAPSHOT_BITS)
        return stable_shard(key, self.num_shards)

    def reshard(self, num_shards: int) -> None:
        """Re-place every entry under a new shard count (entity-affine or
        key-spread, per the store's mode).  O(total entries) — the explicit
        migration a real cluster would run; ``WorkerPool.reshard`` calls
        this so worker ownership and shard layout change together.
        Per-shard LRU recency is preserved within each old shard."""
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        with self._lock:
            entries = [(k, e) for shard in self._shards for k, e in shard.items()]
            self.num_shards = int(num_shards)
            self._shards = [OrderedDict() for _ in range(num_shards)]
            for k, e in entries:
                self._shards[self.shard_of(k)][k] = e

    def _index_add(self, key: int):
        ent, t = unpack_key(key)
        snaps = self._snaps.setdefault(ent, [])
        i = bisect_right(snaps, t)
        if not (i > 0 and snaps[i - 1] == t):
            snaps.insert(i, t)

    def _index_drop(self, key: int):
        ent, t = unpack_key(key)
        snaps = self._snaps.get(ent)
        if snaps is None:
            return
        i = bisect_right(snaps, t) - 1
        if i >= 0 and snaps[i] == t:
            snaps.pop(i)
            if not snaps:
                del self._snaps[ent]

    # ----------------------------------------------------------------- write
    def put(self, key: int, value: np.ndarray, version: int = 0,
            model_version: int = 0):
        key = int(key)
        with self._lock:
            shard = self._shards[self.shard_of(key)]
            shard[key] = _Entry(np.asarray(value, np.float32), int(version),
                                self._clock(), int(model_version))
            shard.move_to_end(key)
            self._index_add(key)
            self.stats["puts"] += 1
            if self.capacity is not None:
                # per-shard LRU cap (a distributed store can only evict locally)
                cap = max(1, self.capacity // self.num_shards)
                while len(shard) > cap:
                    old_key, _ = shard.popitem(last=False)
                    self._index_drop(old_key)
                    self.stats["evictions"] += 1

    def put_batch(self, keys, values, version: int = 0,
                  model_version: int = 0, stamp: float | None = None) -> int:
        """Write many (key, value) pairs under ONE lock acquisition and one
        clock read — the batch-layer refresh path.  Per-entry ``put`` pays
        lock + clock + eviction scan per embedding; a refresh writing
        thousands of entities amortizes all three here (eviction runs once
        per touched shard at the end).  Returns the number written.

        ``stamp`` overrides the clock read: a shard process applies puts
        with the stamp the parent recorded at the logical write, so TTL
        ages and checkpointed stamps stay identical to the inline store.
        """
        keys = [int(k) for k in keys]
        version, model_version = int(version), int(model_version)
        crashpoint.fire("kv.put_batch.before")
        with self._lock:
            stamp = self._clock() if stamp is None else float(stamp)
            touched = set()
            for k, v in zip(keys, values):
                s = self.shard_of(k)
                shard = self._shards[s]
                shard[k] = _Entry(np.asarray(v, np.float32), version, stamp,
                                  model_version)
                shard.move_to_end(k)
                self._index_add(k)
                touched.add(s)
            self.stats["puts"] += len(keys)
            if self.capacity is not None:
                cap = max(1, self.capacity // self.num_shards)
                for s in touched:
                    shard = self._shards[s]
                    while len(shard) > cap:
                        old_key, _ = shard.popitem(last=False)
                        self._index_drop(old_key)
                        self.stats["evictions"] += 1
        crashpoint.fire("kv.put_batch.after")
        return len(keys)

    # ------------------------------------------------------------------ read
    def _entry(self, key: int, touch: bool = True) -> _Entry | None:
        key = int(key)
        with self._lock:
            shard = self._shards[self.shard_of(key)]
            e = shard.get(key)
            if e is None:
                return None
            if (self.ttl_seconds is not None
                    and self._clock() - e.stamp > self.ttl_seconds):
                del shard[key]
                self._index_drop(key)
                self.stats["expired"] += 1
                return None
            if touch:
                shard.move_to_end(key)
            return e

    def get(self, key: int):
        self.stats["gets"] += 1
        e = self._entry(key)
        if e is None:
            self.stats["misses"] += 1
            return None
        return e.value

    def get_entry(self, key: int) -> tuple[np.ndarray, int, float] | None:
        """(value, version, stamp) or None."""
        e = self._entry(key)
        return None if e is None else (e.value, e.version, e.stamp)

    def version_of(self, key: int) -> int | None:
        e = self._entry(key, touch=False)
        return None if e is None else e.version

    def latest_snapshot(self, entity: int, t_max: int) -> int | None:
        """Freshest stored snapshot of ``entity`` that is <= ``t_max``."""
        with self._lock:
            snaps = self._snaps.get(int(entity))
            if not snaps:
                return None
            i = bisect_right(snaps, int(t_max)) - 1
            return snaps[i] if i >= 0 else None

    # --------------------------------------------------------------- batched
    def lookup_batch(self, key_lists: list, k_max: int):
        """key_lists: per request, a list of entity keys (<= k_max used).

        Returns (emb [B, K, H] float32, mask [B, K]) with zero rows for
        missing keys — cold entities contribute nothing, matching the DDS
        semantics for orders without history."""
        b = len(key_lists)
        emb = np.zeros((b, k_max, self.dim), np.float32)
        mask = np.zeros((b, k_max), np.float32)
        for i, keys in enumerate(key_lists):
            for j, key in enumerate(keys[:k_max]):
                v = self.get(key)
                if v is not None:
                    emb[i, j] = v
                    mask[i, j] = 1.0
        return emb, mask

    def lookup_batch_versioned(self, entity_t_lists: list, k_max: int,
                               expected_model_version: int | None = None):
        """Speed-layer lookup with snapshot fallback.

        ``entity_t_lists``: per request, a list of ``(entity, t_e)`` pairs.
        When the exact ``(entity, t_e)`` key is absent (batch layer behind),
        the freshest stored snapshot <= t_e is served instead and the slot's
        staleness is ``t_e - t_found`` snapshots; truly cold entities stay
        masked with staleness -1.

        ``expected_model_version``: when given, every served slot whose
        embedding was written by a *different* parameter version counts in
        ``stats["model_stale_reads"]`` — after a hot-swap, reads of
        pre-swap embeddings are detectable, not silent.

        Returns (emb [B, K, H], mask [B, K], staleness [B, K] int32).
        """
        b = len(entity_t_lists)
        emb = np.zeros((b, k_max, self.dim), np.float32)
        mask = np.zeros((b, k_max), np.float32)
        stale = np.full((b, k_max), -1, np.int32)
        with self._lock:
            self._lookup_versioned_into(entity_t_lists, k_max, emb, mask,
                                        stale, expected_model_version)
        return emb, mask, stale

    def _lookup_versioned_into(self, entity_t_lists, k_max, emb, mask, stale,
                               expected_model_version=None):
        for i, pairs in enumerate(entity_t_lists):
            for j, (ent, t_e) in enumerate(pairs[:k_max]):
                v, s = self._lookup_one(ent, t_e, expected_model_version)
                if v is not None:
                    emb[i, j] = v
                    mask[i, j] = 1.0
                    stale[i, j] = s

    def _lookup_one(self, ent, t_e, expected_model_version=None):
        """One slot of the versioned lookup: ``(value | None, staleness)``
        with all the side effects of the batched path (get/miss/stale/LRU
        counters).  The per-pair primitive both the inline lookup and a
        shard process's owner-side READ protocol are built on — counter
        sums and recency stay identical whichever side serves the slot.
        Callers hold ``_lock``."""
        if self.require_typed:
            _reject_untagged(ent)
        self.stats["gets"] += 1
        t_found = self.latest_snapshot(ent, t_e)
        if t_found is None:
            self.stats["misses"] += 1
            return None, -1
        e = self._entry(pack_key(ent, t_found))
        if e is None:  # expired between index and read
            self.stats["misses"] += 1
            return None, -1
        if t_found != t_e:
            self.stats["stale_hits"] += 1
        if (expected_model_version is not None
                and e.model_version != expected_model_version):
            self.stats["model_stale_reads"] += 1
        return e.value, int(t_e) - int(t_found)

    def lookup_versioned_one(self, ent: int, t_e: int,
                             expected_model_version: int | None = None):
        """Locked single-slot lookup (cross-shard owner reads)."""
        with self._lock:
            return self._lookup_one(ent, t_e, expected_model_version)

    def __len__(self):
        with self._lock:
            return sum(len(s) for s in self._shards)

    def keys(self):
        with self._lock:
            return [k for shard in self._shards for k in shard.keys()]

    # ------------------------------------------------------- state transfer
    def shard_items(self) -> list[list[tuple]]:
        """Per-shard ``(key, value, version, stamp, model_version)`` tuples
        in LRU order (oldest first) — the exact state a checkpoint snapshot
        or a shard-process SNAPSHOT reply must carry.  Values are the live
        arrays; callers serialize, they must not mutate."""
        with self._lock:
            return [[(k, e.value, e.version, e.stamp, e.model_version)
                     for k, e in shard.items()]
                    for shard in self._shards]

    def load_items(self, shards_items: list[list[tuple]]) -> None:
        """Install per-shard entries exactly as :meth:`shard_items` reported
        them (restore path): shard placement, LRU order, and entry fields
        are taken verbatim — no re-hash, no eviction, no stat counting."""
        if len(shards_items) != self.num_shards:
            raise ValueError(
                f"load_items got {len(shards_items)} shards for a "
                f"{self.num_shards}-shard store")
        with self._lock:
            for s, items in enumerate(shards_items):
                shard = self._shards[s]
                for k, v, ver, stamp, mv in items:
                    k = int(k)
                    shard[k] = _Entry(np.asarray(v, np.float32), int(ver),
                                      float(stamp), int(mv))
                    self._index_add(k)

    def restore_stats(self, stats: dict) -> None:
        """Overwrite counters from a checkpoint manifest."""
        self.stats.update(stats)

    # ------------------------------------------------------------- persistence
    def save(self, path: str):
        with self._lock:
            items = [(k, e) for shard in self._shards for k, e in shard.items()]
        keys = np.asarray([k for k, _ in items], np.int64)
        vals = (
            np.stack([e.value for _, e in items])
            if items
            else np.zeros((0, self.dim), np.float32)
        )
        versions = np.asarray([e.version for _, e in items], np.int64)
        stamps = np.asarray([e.stamp for _, e in items], np.float64)
        model_versions = np.asarray([e.model_version for _, e in items], np.int64)
        np.savez(path, keys=keys, values=vals.astype(np.float32),
                 versions=versions, stamps=stamps,
                 model_versions=model_versions, dim=self.dim)

    @classmethod
    def load(cls, path: str, **kwargs) -> "KVStore":
        with np.load(path) as data:
            store = cls(int(data["dim"]), **kwargs)
            n = len(data["keys"])
            versions = data["versions"] if "versions" in data else np.zeros(n, np.int64)
            stamps = data["stamps"] if "stamps" in data else None
            model_versions = (data["model_versions"] if "model_versions" in data
                              else np.zeros(n, np.int64))
            values = data["values"].astype(np.float32)
            for i, (k, v, ver) in enumerate(zip(data["keys"], values, versions)):
                k = int(k)
                store.put(k, v, int(ver), model_version=int(model_versions[i]))
                if stamps is not None:
                    # restore the original write time: TTL must keep counting
                    # from the real put, not restart at load
                    e = store._shards[store.shard_of(k)].get(k)
                    if e is not None:
                        e.stamp = float(stamps[i])
            store.stats["puts"] = 0
        return store
