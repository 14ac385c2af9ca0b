"""Crash-consistent checkpoint/restore of the full streaming state, plus the
append-only write-ahead event log — ``repro_torch.stream.checkpoint``.

Host code copied from the reference (``repro.stream.checkpoint``); the
on-disk format is the reference's (``CHECKPOINT_FORMAT``, manifest keys,
array names, the WAL's JSON lines), so a root either package writes, the
other restores.

The engine's state is entirely deterministic given the event sequence
(virtual-clock scheduling, pow2 bucket padding, host-side sigmoid — see
``repro_torch.stream.engine``), which makes recovery a pure state problem:

* :class:`WriteAheadLog` — one JSON line per state-changing action
  (``submit`` / ``ingest`` events, ``model`` hot-swaps, ``drain``
  barriers), each carrying a monotonic sequence number and a CRC-32.
  Appends are written **before** the action is applied (write-ahead), so a
  crash between append and apply is repaired by replay, never lost.  A
  torn tail (crash mid-append) is detected by CRC/JSON damage and
  truncated on open; damage *followed by valid records* is real corruption
  and raises.  Features round-trip as base64 of the raw little-endian
  float32 bytes — bit-exact, no decimal detour.

* :func:`write_checkpoint` / :func:`read_checkpoint` /
  :func:`apply_checkpoint` — a versioned snapshot of everything the engine
  owns: the accumulated order log the :class:`IncrementalDDSBuilder` and
  :class:`IncrementalPartitioner` are deterministically rebuilt from, the
  dirty ``(entity, t)`` set and open snapshot, every KV shard **in LRU
  order** with version / stamp / model-version metadata, every worker's
  queued requests and the reorder buffer's held results (field-exact,
  including submission seqnos), the refresh driver's cadence counters, and
  the service's lifecycle/admission/accounting scalars.  Checkpoints are
  written to a temp directory and committed by one atomic rename —
  ``manifest.json`` is written last, so a directory that scans as a
  checkpoint is always complete.  Model files (``models/v{v}.npz``) are
  written by the facade from host copies of the device tensors.

Restore = build the service from the manifest's config + model registry,
``apply_checkpoint``, then replay the WAL suffix (``seq > applied_seq``)
through the ordinary ``submit``/``ingest``/``load_model`` paths exactly
once.  Determinism does the rest: scores and KV bytes after
crash-restore-replay are bit-identical to an uninterrupted run, at every
crash point the inline backend crosses.

The driving wrappers live on the facade: ``FraudService.enable_wal`` /
``.checkpoint()`` / ``FraudService.restore(root)``.
"""
from __future__ import annotations

import base64
import json
import os
import shutil
import tempfile
import zlib

import numpy as np

from repro_torch.service.types import ScoreRequest, ScoreResponse
from repro_torch.stream.events import CheckoutEvent
from repro_torch.utils import crashpoint

#: bumped on any incompatible change to the manifest / state.npz layout
CHECKPOINT_FORMAT = 1

_WAL_NAME = "wal.jsonl"
_CKPT_DIR = "checkpoints"
_CKPT_PREFIX = "ckpt-"


class CheckpointError(RuntimeError):
    """Unrecoverable damage in a WAL or checkpoint artifact."""


# --------------------------------------------------------------------- events
def encode_event(event: CheckoutEvent) -> dict:
    """JSON-able payload for one checkout; features as base64 of the raw
    float32 little-endian bytes (bit-exact round-trip; floats themselves
    ride on JSON's shortest-repr round-trip, which is also exact)."""
    feats = np.ascontiguousarray(np.asarray(event.features, np.float32))
    return {
        "order_id": int(event.order_id),
        "snapshot": int(event.snapshot),
        "entities": [int(e) for e in event.entities],
        "features": base64.b64encode(feats.astype("<f4").tobytes()).decode("ascii"),
        "label": float(event.label),
        "arrival": float(event.arrival),
    }


def decode_event(record: dict) -> CheckoutEvent:
    """Inverse of :func:`encode_event` — rebuild the event from one WAL
    JSON record (features decode little-endian f32, platform-independent)."""
    feats = np.frombuffer(
        base64.b64decode(record["features"]), dtype="<f4"
    ).astype(np.float32)
    return CheckoutEvent(
        order_id=int(record["order_id"]),
        snapshot=int(record["snapshot"]),
        entities=tuple(int(e) for e in record["entities"]),
        features=feats,
        label=float(record["label"]),
        arrival=float(record["arrival"]),
    )


def _crc(payload: dict) -> int:
    return zlib.crc32(
        json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()
    )


# ------------------------------------------------------------------------ WAL
class WriteAheadLog:
    """Append-only JSON-lines log with monotonic seqnos and per-line CRC.

    Record kinds: ``submit`` / ``ingest`` (one checkout event each, see
    :func:`encode_event`) and ``model`` (a hot-swap: the parameter file is
    persisted *before* its record is appended, so a logged swap is always
    replayable).  ``fsync=True`` forces each append to stable storage; the
    default flushes to the OS, which is durable against process death (the
    failure the fault-injection harness models) but not power loss.
    """

    def __init__(self, path: str, fsync: bool = False):
        self.path = path
        self.fsync = bool(fsync)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.first_seq = 0   # seq of the first on-disk record (post-compaction)
        self.last_seq = 0    # highest durable seq; append() hands out last_seq+1
        # reader pins: pin_id -> after_seq.  A pin at ``s`` promises its
        # holder every record with seq > s stays readable, so compaction may
        # never drop past min(pins) (see compact()).  A training tap holds
        # one pin at its scan cursor.
        self._pins: dict[int, int] = {}
        self._next_pin = 1
        self._recover_tail()
        self._f = open(path, "a", encoding="utf-8")

    # ------------------------------------------------------------- open/scan
    def _validate_line(self, line: str, prev_seq: int | None) -> dict:
        rec = json.loads(line)
        crc = rec.pop("crc")
        if crc != _crc(rec):
            raise CheckpointError("crc mismatch")
        if prev_seq is not None and rec["seq"] != prev_seq + 1:
            raise CheckpointError(
                f"seq gap: {rec['seq']} after {prev_seq}")
        return rec

    def _recover_tail(self) -> None:
        """Scan the log; truncate a torn final record, raise on interior
        damage (a bad line *followed by* parseable records)."""
        if not os.path.exists(self.path):
            return
        good_end = 0
        bad_at: int | None = None
        prev = None
        with open(self.path, "rb") as f:
            offset = 0
            for raw in f:
                nxt = offset + len(raw)
                try:
                    # past the first damaged line, continuity vs ``prev`` is
                    # meaningless — validate standalone so a healthy record
                    # after the damage is still recognized as one
                    rec = self._validate_line(
                        raw.decode("utf-8"), prev if bad_at is None else None)
                except (CheckpointError, ValueError, KeyError, UnicodeDecodeError):
                    if bad_at is None:
                        bad_at = offset
                    offset = nxt
                    continue
                if bad_at is not None:
                    raise CheckpointError(
                        f"{self.path}: damaged record at byte {bad_at} is "
                        "followed by valid records — interior corruption, "
                        "not a torn tail")
                if prev is None:
                    self.first_seq = int(rec["seq"])
                prev = int(rec["seq"])
                good_end = nxt
                offset = nxt
        if prev is not None:
            self.last_seq = prev
        if bad_at is not None:
            with open(self.path, "r+b") as f:
                f.truncate(good_end)

    def scan(self, after_seq: int = 0):
        """Yield decoded records with ``seq > after_seq``, in order (reads
        the file fresh — safe to call on a log another handle appends to)."""
        if not os.path.exists(self.path):
            return
        prev = None
        with open(self.path, encoding="utf-8") as f:
            for line in f:
                rec = self._validate_line(line, prev)
                prev = int(rec["seq"])
                if rec["seq"] > after_seq:
                    yield rec

    # ---------------------------------------------------------------- append
    def _append(self, record: dict) -> int:
        seq = self.last_seq + 1
        record = {"seq": seq, **record}
        record["crc"] = _crc(record)
        line = json.dumps(record, separators=(",", ":")) + "\n"
        crashpoint.fire("wal.append.before")
        self._f.write(line)
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self.last_seq = seq
        crashpoint.fire("wal.append.after")
        return seq

    def append_event(self, kind: str, event: CheckoutEvent) -> int:
        """Log one checkout before it is applied.  Returns its seq."""
        if kind not in ("submit", "ingest"):
            raise ValueError(f"unknown event record kind {kind!r}")
        return self._append({"kind": kind, **encode_event(event)})

    def append_model(self, version: int, path: str) -> int:
        """Log a hot-swap to ``version`` whose params live at WAL-root
        relative ``path`` (already persisted — write params, THEN log)."""
        return self._append({"kind": "model", "version": int(version),
                             "path": str(path)})

    def append_drain(self, now: float | None) -> int:
        """Log a mid-stream drain barrier — it force-flushes every queue,
        which changes flush composition, so replay must reproduce it."""
        return self._append({"kind": "drain",
                             "now": None if now is None else float(now)})

    # ------------------------------------------------------------ reader pins
    def pin(self, after_seq: int) -> int:
        """Register a reader pin: records with ``seq > after_seq`` are
        protected from :meth:`compact` until the pin is moved past them or
        released.  Returns the pin id.

        This closes the WAL-compaction vs. reader race: with a reader
        holding a pin at its cursor, a checkpoint's ``compact(applied_seq)``
        is clamped to what every open reader has already read.
        """
        pin_id = self._next_pin
        self._next_pin += 1
        self._pins[pin_id] = int(after_seq)
        return pin_id

    def move_pin(self, pin_id: int, after_seq: int) -> None:
        """Advance a pin to a new cursor (monotonic: moving a pin backwards
        would retro-claim records compaction may already have dropped)."""
        cur = self._pins.get(pin_id)
        if cur is None:
            raise KeyError(f"unknown WAL pin {pin_id}")
        if after_seq < cur:
            raise ValueError(
                f"pin {pin_id} may only advance (at {cur}, got {after_seq})")
        self._pins[pin_id] = int(after_seq)

    def unpin(self, pin_id: int) -> None:
        """Release a reader pin (idempotent)."""
        self._pins.pop(pin_id, None)

    def min_pinned(self) -> int | None:
        """The most conservative pin cursor (None = no open readers)."""
        return min(self._pins.values()) if self._pins else None

    # --------------------------------------------------------------- compact
    def compact(self, upto_seq: int) -> int:
        """Atomically drop records with ``seq <= upto_seq`` (they are covered
        by a checkpoint).  Returns the number of records dropped.

        Open reader pins clamp the drop: a pin at ``s`` keeps every record
        with ``seq > s``, so the effective bound is
        ``min(upto_seq, min_pinned())`` — compaction behind a lagging
        training tap is deferred, never destructive."""
        floor = self.min_pinned()
        if floor is not None:
            upto_seq = min(int(upto_seq), floor)
        keep = list(self.scan(after_seq=int(upto_seq)))
        total = sum(1 for _ in self.scan())
        dropped = total - len(keep)
        if dropped <= 0:
            return 0
        d = os.path.dirname(os.path.abspath(self.path))
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".wal.tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                for rec in keep:
                    rec = dict(rec)
                    rec["crc"] = _crc(rec)
                    f.write(json.dumps(rec, separators=(",", ":")) + "\n")
                f.flush()
                os.fsync(f.fileno())
            self._f.close()
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        self._f = open(self.path, "a", encoding="utf-8")
        self.first_seq = keep[0]["seq"] if keep else self.last_seq + 1
        return dropped

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


# ----------------------------------------------------------- state snapshots
def _ragged(seqs, dtype=np.int64):
    """(flat, offsets[len+1]) encoding of a list of int sequences."""
    offsets = np.zeros(len(seqs) + 1, np.int64)
    flat: list = []
    for i, s in enumerate(seqs):
        flat.extend(s)
        offsets[i + 1] = len(flat)
    return np.asarray(flat, dtype), offsets


def _unragged(flat, offsets):
    return [flat[offsets[i]:offsets[i + 1]] for i in range(len(offsets) - 1)]


def _snapshot_requests(requests, results, feat_dim: int) -> dict:
    """Field-exact arrays for queued ScoreRequests + reorder-held
    ScoreResponses.  ``requests`` is [(worker_id, req)] in per-worker queue
    order; ``results`` is the held responses sorted by seq (location -1)."""
    rows = [(w, r) for w, r in requests] + [(-1, r.request) for r in results]
    t = len(rows)
    arr = {
        "rq_location": np.asarray([w for w, _ in rows], np.int64),
        "rq_seq": np.asarray([r.seq for _, r in rows], np.int64),
        "rq_arrival": np.asarray([r.arrival for _, r in rows], np.float64),
        "rq_order_id": np.asarray(
            [r.tag.order_id for _, r in rows], np.int64),
        "rq_snapshot": np.asarray(
            [r.tag.snapshot for _, r in rows], np.int64),
        "rq_label": np.asarray([r.tag.label for _, r in rows], np.float64),
        "rq_features": (np.stack([r.features for _, r in rows])
                        if rows else np.zeros((0, feat_dim), np.float32)),
    }
    arr["rq_ent_flat"], arr["rq_ent_off"] = _ragged(
        [r.tag.entities for _, r in rows])
    key_flat, key_off = _ragged(
        [[c for pair in r.entity_keys for c in pair] for _, r in rows])
    arr["rq_key_flat"], arr["rq_key_off"] = key_flat.reshape(-1, 2), key_off
    arr["rs_score"] = np.asarray([r.score for r in results], np.float64)
    arr["rs_staleness"] = np.asarray([r.staleness for r in results], np.int64)
    arr["rs_queued"] = np.asarray([r.queued_s for r in results], np.float64)
    arr["rs_service"] = np.asarray([r.service_s for r in results], np.float64)
    arr["rs_batch"] = np.asarray([r.batch_size for r in results], np.int64)
    arr["rs_worker"] = np.asarray([r.worker for r in results], np.int64)
    arr["rs_model_version"] = np.asarray(
        [r.model_version for r in results], np.int64)
    assert len(arr["rq_seq"]) == t
    return arr


def _rebuild_requests(arr):
    """Inverse of :func:`_snapshot_requests` — [(location, ScoreRequest)]
    plus the held ScoreResponses in saved order."""
    ents = _unragged(arr["rq_ent_flat"], arr["rq_ent_off"])
    key_off = arr["rq_key_off"] // 2
    keys = _unragged(arr["rq_key_flat"], key_off)
    out = []
    for i in range(len(arr["rq_seq"])):
        feats = np.ascontiguousarray(arr["rq_features"][i], np.float32)
        ev = CheckoutEvent(
            order_id=int(arr["rq_order_id"][i]),
            snapshot=int(arr["rq_snapshot"][i]),
            entities=tuple(int(e) for e in ents[i]),
            features=feats,
            label=float(arr["rq_label"][i]),
            arrival=float(arr["rq_arrival"][i]),
        )
        req = ScoreRequest(
            features=feats,
            entity_keys=[(int(e), int(s)) for e, s in keys[i]],
            arrival=float(arr["rq_arrival"][i]),
            tag=ev, seq=int(arr["rq_seq"][i]),
        )
        out.append((int(arr["rq_location"][i]), req))
    held = []
    j = 0
    for loc, req in out:
        if loc != -1:
            continue
        held.append(ScoreResponse(
            request=req,
            score=float(arr["rs_score"][j]),
            staleness=int(arr["rs_staleness"][j]),
            queued_s=float(arr["rs_queued"][j]),
            service_s=float(arr["rs_service"][j]),
            batch_size=int(arr["rs_batch"][j]),
            worker=int(arr["rs_worker"][j]),
            model_version=int(arr["rs_model_version"][j]),
        ))
        j += 1
    return [(loc, req) for loc, req in out if loc != -1], held


def snapshot_state(service, applied_seq: int) -> tuple[dict, dict]:
    """(manifest, arrays) capturing the full streaming state of a built
    ``FraudService`` (mode='streaming').  Call with the refresh driver
    drained — an in-flight async stage-1 is mid-effect by definition and
    has no consistent snapshot."""
    eng = service.engine
    ing, store, pool, refr = (eng.ingester, eng.store, eng.pool,
                              eng.refresher)
    b = ing.builder

    arrays: dict = {
        "order_snapshot": np.asarray(b._order_snapshot, np.int64),
        "order_features": (np.stack(b._order_features)
                           if b._order_features
                           else np.zeros((0, b.feat_dim), np.float32)),
        "order_labels": np.asarray(b._labels, np.float64),
    }
    arrays["order_ent_flat"], arrays["order_ent_off"] = _ragged(
        b._order_entities)
    dirty = sorted(ing._dirty)
    arrays["dirty_pairs"] = np.asarray(dirty, np.int64).reshape(-1, 2)

    # KV shards in iteration (= LRU) order, with shard boundaries: restore
    # must reproduce eviction order, not just contents
    shards = store.shard_items()
    items: list = [it for shard in shards for it in shard]
    shard_off = [0]
    for shard in shards:
        shard_off.append(shard_off[-1] + len(shard))
    arrays["kv_keys"] = np.asarray([it[0] for it in items], np.int64)
    arrays["kv_values"] = (np.stack([it[1] for it in items])
                           if items else np.zeros((0, store.dim), np.float32))
    arrays["kv_versions"] = np.asarray([it[2] for it in items], np.int64)
    arrays["kv_stamps"] = np.asarray([it[3] for it in items], np.float64)
    arrays["kv_model_versions"] = np.asarray(
        [it[4] for it in items], np.int64)
    arrays["kv_shard_off"] = np.asarray(shard_off, np.int64)

    queued = [(w.wid, r) for w in pool.workers
              for r in list(w.batcher._queue)]
    held = [pool._reorder._held[s] for s in sorted(pool._reorder._held)]
    arrays.update(_snapshot_requests(queued, held, b.feat_dim))

    refr_stats = dict(refr.stats)
    refr_stats["budget_history"] = list(refr_stats["budget_history"])
    refr_stats["per_shard_written"] = {
        str(k): v for k, v in refr_stats["per_shard_written"].items()}

    manifest = {
        "format": CHECKPOINT_FORMAT,
        "applied_seq": int(applied_seq),
        "config": service.config.to_dict(),
        "state": service.state,
        "model_version": int(service.model_version),
        "models": {str(v): f"models/v{v}.npz"
                   for v in service.model_versions()},
        "model_swaps": service._model_swaps,
        "last_good": service._last_good,
        "acct": dict(service._acct),
        "scores_by_version": {
            str(k): v for k, v in service._scores_by_version.items()},
        "shadow": service._shadow,
        "shadow_acc": service._shadow_acc,
        "events_logged": ing.num_events,
        "ingester": {"open_snapshot": ing._open_snapshot,
                     "stats": dict(ing.stats)},
        "store": {"stats": dict(store.stats)},
        "refresher": {"version": refr.version,
                      "model_version": refr.model_version,
                      "windows_since_refresh": refr._windows_since_refresh,
                      "stats": refr_stats},
        "pool": {
            "seq": pool._seq,
            "router_epoch": pool.router.epoch,
            "pool_stats": dict(pool.pool_stats),
            "reorder_next": pool._reorder._next,
            "reorder_max_held": pool._reorder.max_held,
            "workers": [
                {"busy_until": w.busy_until, "stamp_floor": w.stamp_floor,
                 "stats": dict(w.stats),
                 "batcher_stats": dict(w.batcher.stats)}
                for w in pool.workers
            ],
        },
    }
    scaler = getattr(service, "_autoscaler", None)
    if scaler is not None:
        # hysteresis counters + rolling depth window: WAL-replayed traffic
        # must reproduce every scale decision exactly
        manifest["autoscaler"] = scaler.state_dict()
    return manifest, arrays


def apply_checkpoint(service, manifest: dict, arrays: dict) -> None:
    """Impose a snapshot onto a freshly-built ``FraudService`` whose config
    and model registry already match the manifest (``FraudService.restore``
    arranges that).  The DDS builder and partitioner are rebuilt by
    replaying ``add_order`` over the saved order log — deterministic and
    exact — rather than pickling their internals; everything else is
    restored field by field."""
    if manifest.get("format") != CHECKPOINT_FORMAT:
        raise CheckpointError(
            f"checkpoint format {manifest.get('format')} != "
            f"{CHECKPOINT_FORMAT}")
    eng = service.engine
    ing, store, pool, refr = (eng.ingester, eng.store, eng.pool,
                              eng.refresher)

    # an autoscaled pool may have checkpointed at a different worker count
    # than the freshly-built config default: reshard (workers + router +
    # entity-affine store shards together) before any state is imposed
    if len(manifest["pool"]["workers"]) != len(pool.workers):
        pool.reshard(len(manifest["pool"]["workers"]))

    # --- ingester: replay the order log through the builder + partitioner
    ents = _unragged(arrays["order_ent_flat"], arrays["order_ent_off"])
    for i in range(len(arrays["order_snapshot"])):
        entities = [int(e) for e in ents[i]]
        ing.builder.add_order(
            entities, int(arrays["order_snapshot"][i]),
            np.ascontiguousarray(arrays["order_features"][i], np.float32),
            float(arrays["order_labels"][i]))
        ing.partitioner.add_order(entities)
    ing._open_snapshot = int(manifest["ingester"]["open_snapshot"])
    ing._dirty = {(int(e), int(t)) for e, t in arrays["dirty_pairs"]}
    ing.stats.update(manifest["ingester"]["stats"])

    # --- KV store: per-shard insertion order IS the LRU order
    shard_off = arrays["kv_shard_off"]
    if len(shard_off) - 1 != store.num_shards:
        raise CheckpointError(
            f"checkpoint has {len(shard_off) - 1} KV shards, store has "
            f"{store.num_shards}")
    store.load_items([
        [(int(arrays["kv_keys"][i]),
          np.ascontiguousarray(arrays["kv_values"][i], np.float32),
          int(arrays["kv_versions"][i]),
          float(arrays["kv_stamps"][i]),
          int(arrays["kv_model_versions"][i]))
         for i in range(int(shard_off[s]), int(shard_off[s + 1]))]
        for s in range(len(shard_off) - 1)
    ])
    store.restore_stats(manifest["store"]["stats"])

    # --- refresh driver cadence + counters
    rm = manifest["refresher"]
    refr.version = int(rm["version"])
    refr.model_version = int(rm["model_version"])
    refr._windows_since_refresh = int(rm["windows_since_refresh"])
    stats = dict(rm["stats"])
    stats["per_shard_written"] = {
        int(k): v for k, v in stats["per_shard_written"].items()}
    hist = refr.stats["budget_history"]
    hist.clear()
    hist.extend(stats.pop("budget_history"))
    stats["budget_history"] = hist
    refr.stats.update(stats)

    # --- worker pool: queues, occupancy, reorder buffer
    pm = manifest["pool"]
    queued, held = _rebuild_requests(arrays)
    for loc, req in queued:
        pool.workers[loc].batcher._queue.append(req)
    for wm, w in zip(pm["workers"], pool.workers):
        w.busy_until = float(wm["busy_until"])
        w.stamp_floor = float(wm["stamp_floor"])
        w.stats.update(wm["stats"])
        w.batcher.stats.update(wm["batcher_stats"])
    pool._seq = int(pm["seq"])
    pool.router._epoch = int(pm["router_epoch"])
    pool.pool_stats.update(pm["pool_stats"])
    pool._reorder._next = int(pm["reorder_next"])
    pool._reorder.max_held = int(pm["reorder_max_held"])
    for r in held:
        pool._reorder._held[r.request.seq] = r

    # --- service scalars
    service._acct.update(manifest["acct"])
    service._scores_by_version = {
        int(k): v for k, v in manifest["scores_by_version"].items()}
    service._model_swaps = int(manifest["model_swaps"])
    lg = manifest.get("last_good")
    service._last_good = None if lg is None else int(lg)
    service._shadow = manifest["shadow"]
    service._shadow_acc = float(manifest["shadow_acc"])
    service._state = manifest["state"]

    scaler = getattr(service, "_autoscaler", None)
    if scaler is not None and manifest.get("autoscaler") is not None:
        scaler.load_state(manifest["autoscaler"])


# -------------------------------------------------------------- disk layout
def checkpoint_dir(root: str, applied_seq: int) -> str:
    """Directory one checkpoint occupies under ``root`` — named by the
    zero-padded WAL sequence it covers, so lexical order is replay order."""
    return os.path.join(root, _CKPT_DIR, f"{_CKPT_PREFIX}{applied_seq:012d}")


def write_checkpoint(root: str, service, applied_seq: int) -> str:
    """Atomically write one checkpoint under ``root/checkpoints/``.

    Layout: ``ckpt-{seq:012d}/`` holding ``state.npz`` + ``manifest.json``,
    staged in a ``.tmp`` sibling and committed by a single directory
    rename — recovery only ever sees complete checkpoints (the
    ``checkpoint.mid`` crash point dies between payload and commit, and the
    fault-injection sweep proves the torn stage directory is ignored)."""
    crashpoint.fire("checkpoint.before")
    manifest, arrays = snapshot_state(service, applied_seq)
    final = checkpoint_dir(root, applied_seq)
    if os.path.isdir(final):      # same applied_seq == identical state
        crashpoint.fire("checkpoint.after")
        return final
    tmp = final + ".tmp"
    if os.path.isdir(tmp):        # stage leftover from an earlier crash
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    with open(os.path.join(tmp, "state.npz"), "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    crashpoint.fire("checkpoint.mid")
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    crashpoint.fire("checkpoint.after")
    return final


def list_checkpoints(root: str) -> list[str]:
    """Committed checkpoint directories under ``root``, ascending by seq
    (stage ``.tmp`` leftovers and malformed names are ignored)."""
    d = os.path.join(root, _CKPT_DIR)
    if not os.path.isdir(d):
        return []
    out = []
    for name in os.listdir(d):
        if not name.startswith(_CKPT_PREFIX) or name.endswith(".tmp"):
            continue
        try:
            seq = int(name[len(_CKPT_PREFIX):])
        except ValueError:
            continue
        path = os.path.join(d, name)
        if os.path.isfile(os.path.join(path, "manifest.json")):
            out.append((seq, path))
    return [p for _, p in sorted(out)]


def latest_checkpoint(root: str) -> str | None:
    """The newest committed checkpoint under ``root``, or None."""
    found = list_checkpoints(root)
    return found[-1] if found else None


def prune_checkpoints(root: str, keep_last: int) -> list[str]:
    """Delete all but the newest ``keep_last`` committed checkpoints under
    ``root`` (retention for scheduled checkpointing — a long run would
    otherwise grow ``checkpoints/`` without bound).  Returns the
    removed directories, oldest first."""
    if keep_last < 1:
        raise ValueError("prune_checkpoints keep_last must be >= 1")
    found = list_checkpoints(root)
    doomed = found[:-keep_last] if len(found) > keep_last else []
    for path in doomed:
        shutil.rmtree(path)
    return doomed


def read_checkpoint(path: str) -> tuple[dict, dict]:
    """(manifest, arrays) from one committed checkpoint directory."""
    try:
        with open(os.path.join(path, "manifest.json"), encoding="utf-8") as f:
            manifest = json.load(f)
    except (OSError, ValueError) as exc:
        raise CheckpointError(f"unreadable checkpoint manifest at {path}: "
                              f"{exc}") from exc
    with np.load(os.path.join(path, "state.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    return manifest, arrays


def wal_path(root: str) -> str:
    """The write-ahead log file under a recovery root."""
    return os.path.join(root, _WAL_NAME)


__all__ = [
    "CHECKPOINT_FORMAT",
    "CheckpointError",
    "WriteAheadLog",
    "apply_checkpoint",
    "checkpoint_dir",
    "decode_event",
    "encode_event",
    "latest_checkpoint",
    "list_checkpoints",
    "prune_checkpoints",
    "read_checkpoint",
    "snapshot_state",
    "wal_path",
    "write_checkpoint",
]
