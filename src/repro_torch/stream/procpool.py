"""Process-backed speed layer — ``repro_torch.stream.procpool``.

The inline :class:`~repro_torch.stream.workers.WorkerPool` simulates N
workers inside one interpreter: private weight packs, but one GIL and one
address space.  This module makes the workers real OS processes:

* each :class:`SpeedLayerWorker`'s *compute* (its stage-2 calls, the
  stage-1 bins of a refresh, and its KV shard) lives in its own spawned
  process, on the pool's device (default: CUDA; each child then holds a
  CUDA context of its own on the card);
* the parent keeps ALL scheduling — queues, flush triggers, work stealing,
  the reorder buffer, the virtual clock — byte-for-byte identical to the
  inline pool, so replay parity is a property of the compute protocol, not
  of scheduler luck;
* feature payloads travel through a per-child shared-memory ``<f4`` ring
  buffer; control goes over a pickle-free framed pipe protocol (u32
  header length + JSON header + raw binary sections), byte for byte the
  reference's frames;
* cross-shard KV reads are explicit owner-process READ frames, resolved by
  the parent *before* a SCORE is posted, in the inline lookup's per-owner
  order — per-shard LRU recency and counter sums stay inline-identical.

Topology (one parent, N shard processes)::

    parent: router ─ queues ─ steal ─ reorder ─ virtual clock
       │ READ/PUT/LOAD/REFRESH/SET_MODEL/SNAPSHOT frames (pipe)
       │ SCORE feats ───────────────── shm ring ──────────────┐
       └─> child w: KVStore shard w + Stage2Scorer packs <────┘

Nothing CUDA crosses a process boundary: models cross as npz files
(``train.checkpoint``'s layout, ``models.hybrid`` for a hybrid), features
through the ring, embeddings as frame sections.  Children are spawned,
never forked, so none inherits the parent's CUDA context; on the card the
parent builds the kernel library before it spawns, and the children load
it.

Determinism: a child runs the inline path's own calls — ``Stage2Scorer``'s
tail for a SCORE (fixed pow2 buckets floored at 2, the host f64 sigmoid)
and ``lnn_stage1(..., mm=row_stable_matmul)`` under ``no_grad`` for a
REFRESH bin, exactly as ``RefreshDriver._run_stage1`` calls it — on the
same device with the parent's intra-op thread count, from parameters with
the same bits, so its scores and embeddings are bit-identical to the
parent's inline ones.  ``tests/test_torch_procpool.py`` and the process
axes of ``tests/test_torch_{stream,checkpoint}.py`` lock this in for N=1
and N=4, across hot swaps, checkpoint/restore, and a SIGKILLed worker.

Failure model: a dead child is detected by the liveness sweep at the top
of every :meth:`ProcessWorkerPool.poll` (and by any post/wait hitting the
broken pipe).  Recovery respawns the process, replays the model chain,
restores the shard from the parent's put-journal (reset to a LOAD of the
last SNAPSHOT sweep, then the puts since), and re-posts any in-flight
SCORE frame exactly once.  Lost with the process: that shard's LRU
touches and read counters since the last snapshot, and its kernel launch
counts.
"""
from __future__ import annotations

import json
import os
import shutil
import signal
import struct
import tempfile
import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from multiprocessing import get_context, shared_memory

import numpy as np
import torch

from repro_torch.core.graph import PaddedGraph
from repro_torch.core.layers import row_stable_matmul
from repro_torch.core.lnn import lnn_stage1
from repro_torch.dist.sharding import stable_shard
from repro_torch.kernels import _build
from repro_torch.models.hybrid import HybridModel, load_model_file, save_hybrid
from repro_torch.serve.kvstore import SNAPSHOT_BITS, KVStore, _reject_untagged, entity_shard
from repro_torch.stream.engine import _stage1_params
from repro_torch.stream.microbatch import DeferredScore
from repro_torch.stream.workers import SpeedLayerWorker, Stage2Scorer, WorkerPool
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.utils import crashpoint
from repro_torch.utils.device import resolve_device

DEFAULT_RING_BYTES = 1 << 20


# ------------------------------------------------------------------ framing
def pack_frame(header: dict, sections=()) -> bytes:
    """``u32 header-length | JSON header | raw section bytes``.

    ``sections`` is an ordered list of ``(name, ndarray)``; their dtype and
    shape descriptors are appended to the header under ``"sections"`` so
    the receiver can slice the binary tail without pickling anything.
    """
    header = dict(header)
    secs = [(name, np.ascontiguousarray(arr)) for name, arr in sections]
    header["sections"] = [
        {"name": name, "dtype": arr.dtype.str, "shape": list(arr.shape)}
        for name, arr in secs
    ]
    hj = json.dumps(header).encode("utf-8")
    return b"".join([struct.pack("<I", len(hj)), hj]
                    + [arr.tobytes() for _, arr in secs])


def unpack_frame(buf: bytes) -> tuple[dict, dict]:
    """Inverse of :func:`pack_frame`: ``(header, {name: array})``.

    Arrays are zero-copy read-only views into ``buf`` — copy before
    mutating or before the frame buffer must be released.
    """
    (hl,) = struct.unpack_from("<I", buf, 0)
    header = json.loads(bytes(buf[4:4 + hl]).decode("utf-8"))
    off = 4 + hl
    out: dict[str, np.ndarray] = {}
    for sec in header.pop("sections", []):
        dt = np.dtype(sec["dtype"])
        n = int(np.prod(sec["shape"], dtype=np.int64)) * dt.itemsize
        out[sec["name"]] = np.frombuffer(
            buf, dtype=dt, count=n // dt.itemsize if dt.itemsize else 0,
            offset=off).reshape(sec["shape"])
        off += n
    return header, out


class ShmRing:
    """FIFO region allocator over one SharedMemory block.

    The parent allocates a contiguous region per SCORE's ``<f4`` feature
    matrix and frees it when that message's reply arrives; because a child
    answers its pipe FIFO, regions free in allocation order and the
    classic head-chases-tail ring layout holds.  ``alloc`` returns None
    when the payload cannot fit — the caller falls back to shipping the
    features inline in the frame, so the ring size is a fast path, never a
    correctness bound.
    """

    def __init__(self, nbytes: int = DEFAULT_RING_BYTES, name: str | None = None):
        if name is None:
            self.shm = shared_memory.SharedMemory(create=True, size=int(nbytes))
        else:
            self.shm = shared_memory.SharedMemory(name=name)
        self.capacity = self.shm.size
        self._live: OrderedDict[int, tuple[int, int]] = OrderedDict()
        self._head = 0

    def alloc(self, msg_id: int, nbytes: int) -> int | None:
        nbytes = int(nbytes)
        if nbytes > self.capacity:
            return None
        if not self._live:
            off = 0
        else:
            tail = next(iter(self._live.values()))[0]
            if self._head >= tail:
                if self._head + nbytes <= self.capacity:
                    off = self._head
                elif nbytes <= tail:
                    off = 0
                else:
                    return None
            elif self._head + nbytes <= tail:
                off = self._head
            else:
                return None
        self._live[msg_id] = (off, nbytes)
        self._head = off + nbytes
        return off

    def write(self, off: int, arr: np.ndarray) -> None:
        self.shm.buf[off:off + arr.nbytes] = arr.tobytes()

    def free(self, msg_id) -> None:
        self._live.pop(msg_id, None)

    def destroy(self) -> None:
        try:
            self.shm.close()
            self.shm.unlink()
        except (FileNotFoundError, OSError):  # already gone (child unlinked)
            pass


# ------------------------------------------------------------ child server
class ShardServer:
    """Child-side command executor for one shard process.

    Owns the child's :class:`KVStore` (built with the SAME constructor
    arguments as the inline store — a child only ever receives keys it
    owns, which all land in its own local shard, so per-shard capacity and
    LRU semantics match the inline layout exactly) and its
    :class:`Stage2Scorer` on ``device`` (default: CUDA) with per-version
    weight packs.

    Deliberately process-agnostic: ``handle(header, sections)`` maps one
    request frame to one reply frame, so unit tests drive the full command
    surface in-parent while ``_worker_main`` is only the recv loop around
    it.
    """

    def __init__(self, wid: int, cfg, store_cfg: dict, k_max: int,
                 max_batch: int, model_path: str, model_version: int,
                 shm_buf=None, device=None):
        self.wid = int(wid)
        self.cfg = cfg
        self.max_batch = int(max_batch)
        self.shm_buf = shm_buf
        self.device = resolve_device(device)
        self.store = KVStore(**store_cfg)
        params = load_model_file(model_path, cfg, self.device)
        self.scorer = Stage2Scorer(params, cfg, self.store, k_max,
                                   model_version=int(model_version), device=self.device)
        self._params_by_version = {int(model_version): params}

    # ---------------------------------------------------------------- dispatch
    def handle(self, header: dict, sections: dict) -> tuple[dict, list]:
        cmd = header.get("cmd")
        reply = {"id": header.get("id"), "ok": 1}
        try:
            fn = getattr(self, f"_cmd_{cmd}", None)
            if fn is None:
                raise ValueError(f"unknown command {cmd!r}")
            secs = fn(header, sections, reply) or []
        except Exception as e:  # noqa: BLE001 — child must reply, not die
            return {"id": header.get("id"), "error": f"{type(e).__name__}: {e}"}, []
        return reply, secs

    # ---------------------------------------------------------------- commands
    def _feats_of(self, header, sections):
        if "shm_off" in header:
            off = int(header["shm_off"])
            rows, cols = header["shm_shape"]
            # copy: the parent reclaims the ring region once our reply lands
            return np.frombuffer(self.shm_buf, dtype="<f4", count=rows * cols,
                                 offset=off).reshape(rows, cols).copy()
        # copy: frame sections are read-only views, and torch wants to own
        return np.array(sections["feats"], np.float32)

    def _cmd_score(self, header, sections, reply):
        version = int(header["version"])
        if self.scorer.model_version != version:
            self.scorer.set_model(self._params_by_version[version], version)
        key_lists = header["keys"]
        feats = self._feats_of(header, sections)
        k_max = self.scorer.k_max
        b = len(key_lists)
        emb = np.zeros((b, k_max, self.store.dim), np.float32)
        mask = np.zeros((b, k_max), np.float32)
        stale = np.full((b, k_max), -1, np.int32)
        remote = {(int(i), int(j)): (r, int(has), int(st))
                  for r, (i, j, has, st) in enumerate(header.get("remote", []))}
        remote_emb = sections.get("remote_emb")
        for i, pairs in enumerate(key_lists):
            for j, (ent, t) in enumerate(pairs[:k_max]):
                hit = remote.get((i, j))
                if hit is not None:
                    r, has, st = hit
                    if has:
                        emb[i, j] = remote_emb[r]
                        mask[i, j] = 1.0
                        stale[i, j] = st
                    continue
                v, s = self.store.lookup_versioned_one(
                    int(ent), int(t), expected_model_version=version)
                if v is not None:
                    emb[i, j] = v
                    mask[i, j] = 1.0
                    stale[i, j] = s
        probs, stale_max, ver = self.scorer.score_slots(
            feats, key_lists, emb, mask, stale)
        reply["version"] = int(ver)
        return [("probs", np.asarray(probs, np.float32)),
                ("stale", np.asarray(stale_max, np.int32))]

    def _cmd_read(self, header, sections, reply):
        expected = header.get("version")
        pairs = header["pairs"]
        emb = np.zeros((len(pairs), self.store.dim), np.float32)
        has = np.zeros(len(pairs), np.int8)
        stale = np.full(len(pairs), -1, np.int32)
        for r, (ent, t) in enumerate(pairs):
            v, s = self.store.lookup_versioned_one(
                int(ent), int(t), expected_model_version=expected)
            if v is not None:
                emb[r] = v
                has[r] = 1
                stale[r] = s
        return [("emb", emb), ("has", has), ("stale", stale)]

    def _cmd_put(self, header, sections, reply):
        n = self.store.put_batch(
            np.asarray(sections["keys"], np.int64),
            np.asarray(sections["values"], np.float32),
            version=int(header["pver"]),
            model_version=int(header["model_version"]),
            stamp=float(header["stamp"]),
        )
        reply["n"] = n

    def _cmd_load(self, header, sections, reply):
        s = int(header["shard"])
        keys = np.asarray(sections["keys"], np.int64)
        vals = np.asarray(sections["values"], np.float32)
        vers = np.asarray(sections["versions"], np.int64)
        stamps = np.asarray(sections["stamps"], np.float64)
        mvs = np.asarray(sections["model_versions"], np.int64)
        items = [(int(keys[i]), vals[i], int(vers[i]), float(stamps[i]),
                  int(mvs[i])) for i in range(len(keys))]
        shards = [[] for _ in range(self.store.num_shards)]
        shards[s] = items
        self.store.load_items(shards)
        reply["n"] = len(items)

    def _cmd_snapshot(self, header, sections, reply):
        shards = self.store.shard_items()
        ks, vs, vers, stamps, mvs = [], [], [], [], []
        shard_off = [0]
        for items in shards:
            for k, v, ver, st, mv in items:
                ks.append(int(k))
                vs.append(np.asarray(v, np.float32))
                vers.append(int(ver))
                stamps.append(float(st))
                mvs.append(int(mv))
            shard_off.append(len(ks))
        reply["shard_off"] = shard_off
        reply["stats"] = dict(self.store.stats)
        reply["len"] = len(self.store)
        vals = (np.stack(vs) if vs
                else np.zeros((0, self.store.dim), np.float32))
        return [("keys", np.asarray(ks, np.int64)), ("values", vals),
                ("versions", np.asarray(vers, np.int64)),
                ("stamps", np.asarray(stamps, np.float64)),
                ("model_versions", np.asarray(mvs, np.int64))]

    def _cmd_stats(self, header, sections, reply):
        reply["stats"] = dict(self.store.stats)
        reply["len"] = len(self.store)
        # this process's kernel launches (the counters are per process);
        # ``reset_launches`` zeroes them once read
        reply["launches"] = dict(_build.LAUNCHES)
        if header.get("reset_launches"):
            _build.reset_launches()

    def _cmd_set_model(self, header, sections, reply):
        version = int(header["version"])
        if version not in self._params_by_version:
            self._params_by_version[version] = load_model_file(
                header["path"], self.cfg, self.device)
        self.scorer.set_model(self._params_by_version[version], version)

    def _cmd_warmup(self, header, sections, reply):
        others = {int(v): self._params_by_version[int(v)]
                  for v in header.get("versions", ())
                  if int(v) != self.scorer.model_version}
        self.scorer.warmup(self.max_batch, others)

    def _cmd_refresh(self, header, sections, reply):
        """Stage 1 over one padded bin: the call ``RefreshDriver._run_stage1``
        makes inline, so the rows have the inline bits on the same device."""
        version = int(header["version"])
        params = _stage1_params(self._params_by_version[version])
        pg = PaddedGraph(**{name: np.array(sections[name]) for name in header["fields"]})
        with torch.no_grad():
            h = lnn_stage1(params, self.cfg, pg.to(self.device), mm=row_stable_matmul)
        return [("h", h.cpu().numpy())]

    def _cmd_ping(self, header, sections, reply):
        reply["wid"] = self.wid

    def _cmd_stop(self, header, sections, reply):
        reply["stopped"] = 1


def _worker_main(conn, shm_name, init: dict) -> None:  # pragma: no cover
    """Child entry point: one ShardServer behind a framed recv loop.

    Runs only inside the spawned shard process; its body is one recv loop
    around :meth:`ShardServer.handle`, whose command surface the tests
    drive in-parent.  The child computes with the parent's intra-op thread
    count (on the CPU a product's bits can depend on it) on the device
    ``init`` names, raising without a card when that is CUDA."""
    # NOTE on the resource tracker: Python <= 3.12 registers the segment on
    # ATTACH too (bpo-38119), but spawn children share the parent's tracker
    # process and its name cache is a set — the duplicate registration
    # collapses, and the parent's unlink() clears the single entry.  No
    # child-side unregister needed (it would double-remove and spam
    # KeyErrors from the tracker).
    torch.set_num_threads(int(init["threads"]))
    shm = shared_memory.SharedMemory(name=shm_name) if shm_name else None
    server = ShardServer(
        init["wid"], init["cfg"], init["store_cfg"], init["k_max"],
        init["max_batch"], init["model_path"], init["model_version"],
        shm_buf=shm.buf if shm is not None else None, device=init["device"],
    )
    try:
        while True:
            try:
                buf = conn.recv_bytes()
            except (EOFError, OSError):
                break
            header, sections = unpack_frame(buf)
            rh, rs = server.handle(header, sections)
            conn.send_bytes(pack_frame(rh, rs))
            if rh.get("stopped"):
                break
    finally:
        # drop the buffer views before closing the mapping, then close but
        # do NOT unlink — the parent owns the segment's lifetime
        del server
        if shm is not None:
            shm.close()
        conn.close()


# ------------------------------------------------------------- parent side
class WorkerDied(RuntimeError):
    """A shard process exited (crash or SIGKILL) under an in-flight frame."""

    def __init__(self, wid: int):
        super().__init__(f"shard process {wid} died")
        self.wid = wid


class ChildError(RuntimeError):
    """A shard process answered a frame with an error reply."""


@contextmanager
def _patched_env(env: dict | None):
    """Temporarily patch os.environ around a spawn — the child inherits the
    patched environment while the parent's is restored immediately."""
    if not env:
        yield
        return
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _ChildHandle:
    """Parent-side endpoint for one shard process: the pipe, the shm ring,
    and a msg-id demultiplexer (a reply for a message another thread is
    waiting on is stashed, not dropped — the serving thread and the async
    refresh thread share each child)."""

    def __init__(self, wid: int, ctx, init: dict, ring_bytes: int,
                 child_env: dict | None):
        self.wid = int(wid)
        self.ring = ShmRing(ring_bytes)
        parent_conn, child_conn = ctx.Pipe()
        with _patched_env(child_env):
            self.proc = ctx.Process(
                target=_worker_main,
                args=(child_conn, self.ring.shm.name, init),
                daemon=True,
                name=f"repro-torch-shard-{wid}",
            )
            self.proc.start()
        self.spawned_at = time.perf_counter()
        child_conn.close()
        self.conn = parent_conn
        self._lock = threading.Lock()
        self._stash: dict[int, tuple[dict, dict]] = {}
        self._count = 0

    def alive(self) -> bool:
        return self.proc.is_alive()

    def post(self, header: dict, sections=(), feats: np.ndarray | None = None) -> int:
        """Send one frame; large ``<f4`` payloads ride the shm ring (inline
        fallback when the ring is momentarily full).  Returns the msg id."""
        with self._lock:
            msg_id = self._count
            self._count += 1
            header = dict(header)
            header["id"] = msg_id
            secs = list(sections)
            if feats is not None:
                feats = np.ascontiguousarray(feats, "<f4")
                off = self.ring.alloc(msg_id, feats.nbytes)
                if off is None:
                    secs.append(("feats", feats))
                else:
                    self.ring.write(off, feats)
                    header["shm_off"] = off
                    header["shm_shape"] = list(feats.shape)
            buf = pack_frame(header, secs)
            try:
                self.conn.send_bytes(buf)
            except (BrokenPipeError, OSError):
                self.ring.free(msg_id)
                raise WorkerDied(self.wid) from None
            return msg_id

    def wait(self, msg_id: int) -> tuple[dict, dict]:
        """Block for the reply to ``msg_id``; replies to other messages are
        stashed for their waiters.  Frees the ring region of whichever
        message each arriving reply answers."""
        while True:
            with self._lock:
                if msg_id in self._stash:
                    h, s = self._stash.pop(msg_id)
                    break
                try:
                    buf = self.conn.recv_bytes()
                except (EOFError, OSError):
                    raise WorkerDied(self.wid) from None
                h, s = unpack_frame(buf)
                self.ring.free(h.get("id"))
                if h.get("id") == msg_id:
                    break
                self._stash[h["id"]] = (h, s)
        if "error" in h:
            raise ChildError(f"shard process {self.wid}: {h['error']}")
        return h, s

    def request(self, header: dict, sections=()) -> tuple[dict, dict]:
        return self.wait(self.post(header, sections))

    def destroy(self, stop: bool = False, timeout: float = 5.0) -> None:
        """Tear down: optionally a polite STOP, then join/terminate, close
        the pipe, and unlink the ring segment."""
        if stop and self.proc.is_alive():
            try:
                self.request({"cmd": "stop"})
            except (WorkerDied, ChildError):
                pass
        try:
            self.conn.close()
        except OSError:
            pass
        self.proc.join(timeout=timeout)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=timeout)
        self.ring.destroy()


class ProcStoreView:
    """Parent-side facade over the children's KV shards.

    Implements the slice of the :class:`KVStore` surface the parent needs —
    versioned batch lookups (shadow scoring), batched puts (refresh feeds,
    WAL replay), length/stats, and the checkpoint state-transfer trio
    ``shard_items``/``load_items``/``restore_stats`` — by translating each
    call into owner-routed frames.  Counter sums equal the inline store's
    because every logical operation executes exactly once at its owner.
    """

    def __init__(self, pool: "ProcessWorkerPool", dim: int,
                 capacity: int | None = None, ttl_seconds: float | None = None,
                 num_shards: int = 1, shard_by_entity: bool = False,
                 require_typed: bool = False):
        self.pool = pool
        self.dim = int(dim)
        self.capacity = capacity
        self.ttl_seconds = ttl_seconds
        self.num_shards = int(num_shards)
        self.shard_by_entity = bool(shard_by_entity)
        self.require_typed = bool(require_typed)
        # parent-held counter base: merged stats = base + sum(child stats).
        # restore_stats() folds a checkpointed dict into the base so the
        # merged view equals the restored counters exactly.
        self._stats_base = {k: 0 for k in KVStore(1).stats}

    # --------------------------------------------------------------- placement
    def shard_of(self, key: int) -> int:
        if self.shard_by_entity:
            return entity_shard(int(key) >> SNAPSHOT_BITS, self.num_shards,
                                require_typed=self.require_typed)
        if self.require_typed:
            _reject_untagged(int(key) >> SNAPSHOT_BITS)
        return stable_shard(key, self.num_shards)

    # ------------------------------------------------------------------- reads
    def lookup_batch_versioned(self, entity_t_lists: list, k_max: int,
                               expected_model_version: int | None = None):
        b = len(entity_t_lists)
        emb = np.zeros((b, k_max, self.dim), np.float32)
        mask = np.zeros((b, k_max), np.float32)
        stale = np.full((b, k_max), -1, np.int32)
        per_owner: dict[int, list] = {}
        for i, pairs in enumerate(entity_t_lists):
            for j, (ent, t) in enumerate(pairs[:k_max]):
                if self.require_typed:
                    _reject_untagged(int(ent))
                per_owner.setdefault(self.pool.owner_of(int(ent)), []).append(
                    (i, j, int(ent), int(t)))
        for o in sorted(per_owner):
            plist = per_owner[o]
            e, has, st = self.pool.read_pairs(
                o, [[ent, t] for _, _, ent, t in plist], expected_model_version)
            for r, (i, j, _, _) in enumerate(plist):
                if has[r]:
                    emb[i, j] = e[r]
                    mask[i, j] = 1.0
                    stale[i, j] = st[r]
        return emb, mask, stale

    def lookup_versioned_one(self, ent: int, t_e: int,
                             expected_model_version: int | None = None):
        if self.require_typed:
            _reject_untagged(int(ent))
        e, has, st = self.pool.read_pairs(
            self.pool.owner_of(int(ent)), [[int(ent), int(t_e)]],
            expected_model_version)
        return (e[0] if has[0] else None), int(st[0])

    # ------------------------------------------------------------------ writes
    def put_batch(self, keys, values, version: int = 0,
                  model_version: int = 0, stamp: float | None = None) -> int:
        keys = [int(k) for k in keys]
        vals = [np.asarray(v, np.float32) for v in values]
        crashpoint.fire("kv.put_batch.before")
        stamp = time.time() if stamp is None else float(stamp)
        groups: dict[int, list[int]] = {}
        for idx, k in enumerate(keys):
            self.shard_of(k)  # typed-keyspace validation, same as inline
            ent = k >> SNAPSHOT_BITS
            groups.setdefault(self.pool.owner_of(ent), []).append(idx)
        for o in sorted(groups):
            idxs = groups[o]
            self.pool.put_group(
                o, np.asarray([keys[i] for i in idxs], np.int64),
                (np.stack([vals[i] for i in idxs]) if idxs
                 else np.zeros((0, self.dim), np.float32)),
                int(version), int(model_version), stamp)
        crashpoint.fire("kv.put_batch.after")
        return len(keys)

    def put(self, key: int, value, version: int = 0, model_version: int = 0):
        self.put_batch([key], [value], version=version,
                       model_version=model_version)

    # ----------------------------------------------------------- introspection
    def __len__(self) -> int:
        return self.pool.store_len()

    @property
    def stats(self) -> dict:
        merged = dict(self._stats_base)
        for k, v in self.pool.child_stats_sum().items():
            merged[k] = merged.get(k, 0) + v
        return merged

    def keys(self) -> list[int]:
        return [k for shard in self.shard_items() for (k, *_rest) in shard]

    # ------------------------------------------------------- state transfer
    def shard_items(self) -> list[list[tuple]]:
        """SNAPSHOT sweep over every child, merged into the logical shard
        layout (child w's local shard s feeds logical shard s — nonowned
        local shards are empty by construction).  Also resets each child's
        put-journal to a LOAD of this snapshot, keeping recovery replay
        bounded."""
        out: list[list[tuple]] = [[] for _ in range(self.num_shards)]
        for items_by_shard in self.pool.snapshot_children():
            for s, items in enumerate(items_by_shard):
                out[s].extend(items)
        return out

    def load_items(self, shards_items: list[list[tuple]]) -> None:
        if len(shards_items) != self.num_shards:
            raise ValueError(
                f"load_items got {len(shards_items)} shards for a "
                f"{self.num_shards}-shard store")
        for s, items in enumerate(shards_items):
            self.pool.load_shard(self.pool.owner_of_shard(s), s, items)

    def restore_stats(self, stats: dict) -> None:
        sums = self.pool.child_stats_sum()
        base = dict(self._stats_base)
        for k, v in stats.items():
            base[k] = v - sums.get(k, 0)
        self._stats_base = base


class ProcessWorkerPool(WorkerPool):
    """The inline :class:`WorkerPool` with its compute plane moved into
    real processes on ``device`` (default: CUDA).  Scheduling (queues,
    triggers, stealing, reorder, virtual clock) is inherited unchanged;
    each worker's ``score_fn`` is replaced by one that posts a SCORE frame
    to its shard process and returns a :class:`DeferredScore` — the pool's
    ``_collect`` resolves all of a pump pass's in-flight flushes together,
    which is where the multi-process parallelism comes from.
    """

    def __init__(self, params, cfg, store_cfg: dict, num_workers: int = 1,
                 k_max: int = 8, max_batch: int = 16, max_wait_s: float = 0.005,
                 service_model_s: float = 0.0, steal_threshold: int | None = None,
                 model_version: int = 0, ring_bytes: int = DEFAULT_RING_BYTES,
                 child_env: dict | None = None, device=None):
        store_cfg = dict(store_cfg)
        if num_workers > 1:
            if not store_cfg.get("shard_by_entity"):
                raise ValueError(
                    "the process backend needs shard_by_entity=True for "
                    "num_workers > 1 — shard ownership is what makes each "
                    "child's KV reads local")
            if store_cfg.get("num_shards") != num_workers:
                raise ValueError(
                    "process backend: store num_shards must equal "
                    f"num_workers (got {store_cfg.get('num_shards')} vs "
                    f"{num_workers})")
        device = resolve_device(device)
        if device.type == "cuda":
            # build (or find) the kernel library once, here: N children that
            # found none would each run nvcc.  Loading it makes no context.
            _build.load_library()
        self._ctx = get_context("spawn")
        self._cfg = cfg
        self._device = device
        self._k_max = int(k_max)
        self._max_batch = int(max_batch)
        self._store_cfg = store_cfg
        self._ring_bytes = int(ring_bytes)
        self._child_env = child_env
        self._model_dir = tempfile.mkdtemp(prefix="repro-torch-procpool-")
        self._model_paths: dict[int, str] = {}
        self._model_order: list[int] = []
        self._model_version = int(model_version)
        self._save_model(params, model_version)
        self._closed = False
        self._journal: dict[int, list] = {}
        self._children: list[_ChildHandle] = [
            self._spawn_child(w) for w in range(num_workers)]
        store = ProcStoreView(self, **store_cfg)
        super().__init__(params, cfg, store, num_workers=num_workers,
                         k_max=k_max, max_batch=max_batch,
                         max_wait_s=max_wait_s,
                         service_model_s=service_model_s,
                         steal_threshold=steal_threshold, device=device)
        self._attach_score_fns()

    # ----------------------------------------------------------- child plumbing
    def _save_model(self, params, version: int) -> str:
        version = int(version)
        if version not in self._model_paths:
            path = os.path.join(self._model_dir, f"v{version}.npz")
            if isinstance(params, HybridModel):
                save_hybrid(path, params)
            else:
                save_checkpoint(path, params)
            self._model_paths[version] = path
            self._model_order.append(version)
        return self._model_paths[version]

    def _spawn_child(self, wid: int) -> _ChildHandle:
        first = self._model_order[0]
        init = {
            "wid": wid,
            # the port's LNNConfig: a reference object would import repro
            # (and jax) in the child to unpickle
            "cfg": self._cfg,
            "store_cfg": self._store_cfg,
            "k_max": self._k_max,
            "max_batch": self._max_batch,
            "model_path": self._model_paths[first],
            "model_version": first,
            "device": str(self._device),
            "threads": torch.get_num_threads(),
        }
        self._journal.setdefault(wid, [])
        return _ChildHandle(wid, self._ctx, init, self._ring_bytes,
                            self._child_env)

    def _replay_model_chain(self, wid: int) -> None:
        """Bring a fresh child's model registry to the pool's: every version
        ever registered, activating the current one last."""
        child = self._children[wid]
        for v in self._model_order[1:]:
            child.request({"cmd": "set_model", "version": v,
                           "path": self._model_paths[v]})
        if self._model_version != self._model_order[-1]:
            # a rollback re-activated an older version: make it current
            child.request({"cmd": "set_model", "version": self._model_version,
                           "path": self._model_paths[self._model_version]})

    def _replay_journal(self, wid: int) -> None:
        child = self._children[wid]
        for header, sections in self._journal[wid]:
            child.request(dict(header), sections)

    def _restart_child(self, wid: int) -> None:
        """Respawn a dead shard process and restore its state: model chain,
        then the put-journal (last snapshot LOAD + puts since).  In-flight
        SCORE frames are re-posted by their waiters — exactly once, since
        cross-shard reads were resolved before the original post."""
        self._children[wid].destroy()
        self._children[wid] = self._spawn_child(wid)
        self._replay_model_chain(wid)
        self._replay_journal(wid)
        workers = getattr(self, "workers", None)
        if workers is not None and wid < len(workers):
            workers[wid].stats["restarts"] += 1

    def _request(self, wid: int, header: dict, sections=()) -> tuple[dict, dict]:
        """Synchronous round-trip with one restart-and-retry on child death."""
        if self._closed:
            raise RuntimeError(
                "ProcessWorkerPool is shut down — no shard process to ask")
        try:
            return self._children[wid].request(dict(header), sections)
        except WorkerDied:
            self._restart_child(wid)
            return self._children[wid].request(dict(header), sections)

    # ------------------------------------------------------------- owner routing
    def owner_of(self, entity: int) -> int:
        n = len(self._children)
        return 0 if n == 1 else entity_shard(int(entity), n)

    def owner_of_shard(self, shard: int) -> int:
        return 0 if len(self._children) == 1 else int(shard)

    # --------------------------------------------------------------- store ops
    def read_pairs(self, wid: int, pairs: list,
                   expected_model_version: int | None):
        h, s = self._request(wid, {"cmd": "read", "pairs": pairs,
                                   "version": expected_model_version})
        return s["emb"], s["has"], s["stale"]

    def put_group(self, wid: int, keys: np.ndarray, values: np.ndarray,
                  version: int, model_version: int, stamp: float) -> None:
        header = {"cmd": "put", "pver": version,
                  "model_version": model_version, "stamp": stamp}
        sections = [("keys", keys), ("values", values)]
        self._request(wid, header, sections)
        self._journal[wid].append((header, sections))

    def load_shard(self, wid: int, shard: int, items: list) -> None:
        keys = np.asarray([k for k, *_r in items], np.int64)
        vals = (np.stack([np.asarray(v, np.float32) for _, v, *_r in items])
                if items else np.zeros((0, self.store.dim), np.float32))
        header = {"cmd": "load", "shard": int(shard)}
        sections = [
            ("keys", keys), ("values", vals),
            ("versions", np.asarray([ver for _, _, ver, _, _ in items], np.int64)),
            ("stamps", np.asarray([st for _, _, _, st, _ in items], np.float64)),
            ("model_versions", np.asarray([mv for *_r, mv in items], np.int64)),
        ]
        self._request(wid, header, sections)
        self._journal[wid].append((header, sections))

    def snapshot_children(self) -> list[list[list[tuple]]]:
        """One SNAPSHOT round-trip per child; returns each child's local
        shard item lists and resets its journal to an equivalent LOAD."""
        out = []
        for wid in range(len(self._children)):
            h, s = self._request(wid, {"cmd": "snapshot"})
            off = h["shard_off"]
            keys, vals = s["keys"], s["values"]
            vers, stamps, mvs = s["versions"], s["stamps"], s["model_versions"]
            shards = []
            journal = []
            for ls in range(len(off) - 1):
                lo, hi = int(off[ls]), int(off[ls + 1])
                shards.append([
                    (int(keys[i]), np.array(vals[i]), int(vers[i]),
                     float(stamps[i]), int(mvs[i])) for i in range(lo, hi)])
                if hi > lo:
                    journal.append((
                        {"cmd": "load", "shard": ls},
                        [("keys", np.array(keys[lo:hi])),
                         ("values", np.array(vals[lo:hi])),
                         ("versions", np.array(vers[lo:hi])),
                         ("stamps", np.array(stamps[lo:hi])),
                         ("model_versions", np.array(mvs[lo:hi]))]))
            self._journal[wid] = journal
            out.append(shards)
        return out

    def child_stats_sum(self) -> dict:
        if self._closed:
            return dict(self._final_stats)
        agg: dict = {}
        for wid in range(len(self._children)):
            h, _ = self._request(wid, {"cmd": "stats"})
            for k, v in h["stats"].items():
                agg[k] = agg.get(k, 0) + v
        return agg

    def child_launches(self, reset: bool = False) -> dict:
        """Kernel launches counted in the shard processes, summed over them
        (each process keeps its own ``kernels._build.LAUNCHES``); ``reset``
        sets each child's counts to 0 once read.  A respawned child starts
        from 0."""
        agg: dict = {}
        for wid in range(len(self._children)):
            h, _ = self._request(wid, {"cmd": "stats", "reset_launches": int(reset)})
            for k, v in h["launches"].items():
                agg[k] = agg.get(k, 0) + v
        return agg

    def store_len(self) -> int:
        if self._closed:
            return self._final_len
        total = 0
        for wid in range(len(self._children)):
            h, _ = self._request(wid, {"cmd": "stats"})
            total += int(h["len"])
        return total

    # ------------------------------------------------------------------ scoring
    def _attach_score_fns(self) -> None:
        for w in self.workers:
            w.batcher.score_fn = self._make_score_fn(w.wid)

    def _make_score_fn(self, wid: int):
        def score_fn(feats, key_lists):
            return self._score_via_child(wid, feats, key_lists)
        return score_fn

    def _resolve_remote(self, wid: int, key_lists: list, version: int):
        """Pre-resolve every slot NOT owned by the scoring child via READ
        frames to its owner, in the inline lookup's (i, j) order per owner
        — counters and LRU recency land exactly where the inline store
        would put them, once."""
        n = len(self._children)
        remote: list[list[int]] = []
        rows: list[np.ndarray] = []
        if n > 1:
            per_owner: dict[int, list] = {}
            for i, pairs in enumerate(key_lists):
                for j, (ent, t) in enumerate(pairs[:self._k_max]):
                    o = self.owner_of(ent)
                    if o != wid:
                        per_owner.setdefault(o, []).append((i, j, ent, t))
            for o in sorted(per_owner):
                plist = per_owner[o]
                emb, has, stale = self.read_pairs(
                    o, [[e, t] for _, _, e, t in plist], version)
                for r, (i, j, _, _) in enumerate(plist):
                    remote.append([i, j, int(has[r]), int(stale[r])])
                    rows.append(np.asarray(emb[r], np.float32))
        remote_emb = (np.stack(rows) if rows
                      else np.zeros((0, self.store.dim), np.float32))
        return remote, remote_emb

    def _score_via_child(self, wid: int, feats, key_lists) -> DeferredScore:
        version = self._model_version
        kl = [[[int(e), int(t)] for e, t in pairs] for pairs in key_lists]
        remote, remote_emb = self._resolve_remote(wid, kl, version)
        header = {"cmd": "score", "version": version, "keys": kl,
                  "remote": remote}
        secs = [("remote_emb", remote_emb)] if len(remote_emb) else []
        feats = np.ascontiguousarray(feats, "<f4")
        # the fault-injection harness arms "worker_kill": the k-th SCORE
        # post becomes a SIGKILL of the target shard process, and the
        # recovery path below must still deliver this flush exactly once
        try:
            crashpoint.fire("worker_kill")
        except crashpoint.SimulatedCrash:
            self.kill_worker(wid)
        try:
            handle = self._children[wid]
            msg_id = handle.post(header, secs, feats=feats)
        except WorkerDied:
            self._restart_child(wid)
            handle = self._children[wid]
            msg_id = handle.post(header, secs, feats=feats)
        return DeferredScore(
            lambda: self._await_score(wid, handle, msg_id, header, secs, feats))

    def _await_score(self, wid, handle, msg_id, header, secs, feats):
        for _ in range(2):
            if self._children[wid] is not handle:
                # the child this flush was posted to died and was replaced:
                # re-dispatch the saved frame once on the restored process
                handle = self._children[wid]
                msg_id = handle.post(header, secs, feats=feats)
            try:
                h, s = handle.wait(msg_id)
                return (np.asarray(s["probs"], np.float32),
                        np.asarray(s["stale"], np.int32), int(h["version"]))
            except WorkerDied:
                self._restart_child(wid)
        raise RuntimeError(f"shard process {wid} died twice on one flush")

    def kill_worker(self, wid: int) -> None:
        """SIGKILL one shard process (fault-injection harness)."""
        p = self._children[wid].proc
        if p.is_alive() and p.pid is not None:
            os.kill(p.pid, signal.SIGKILL)
        p.join()

    # ---------------------------------------------------------------- liveness
    def dead_workers(self) -> int:
        return sum(1 for c in self._children if not c.alive())

    def ping(self) -> list[int]:
        """Round-trip heartbeat: wids that answered a PING frame."""
        ok = []
        for wid, c in enumerate(self._children):
            if not c.alive():
                continue
            try:
                c.request({"cmd": "ping"})
                ok.append(wid)
            except (WorkerDied, ChildError):
                pass
        return ok

    def check_workers(self) -> int:
        """Heartbeat sweep: restart any dead child (shard restored from the
        last snapshot + put-journal suffix).  Returns restarts performed."""
        if self._closed:
            return 0
        n = 0
        for wid, c in enumerate(self._children):
            if not c.alive():
                self._restart_child(wid)
                n += 1
        return n

    def poll(self, now: float):
        self.check_workers()
        return super().poll(now)

    # ------------------------------------------------------------- lifecycle
    def set_model(self, params, model_version: int) -> None:
        version = int(model_version)
        path = self._save_model(params, version)
        for wid in range(len(self._children)):
            self._request(wid, {"cmd": "set_model", "version": version,
                                "path": path})
        self._model_version = version
        super().set_model(params, version)

    def warmup(self, models: dict | None = None) -> list[float]:
        """Run every bucket shape in every child, under the active version
        and under each registered version in ``models`` (``{version:
        params}``), all children at once.  Returns, per child, the seconds
        from its spawn to the end of its warmup."""
        versions = sorted(int(v) for v in (models or {}))
        posts = [(c, c.post({"cmd": "warmup", "versions": versions}))
                 for c in self._children]
        ready = []
        for c, mid in posts:
            c.wait(mid)
            ready.append(time.perf_counter() - c.spawned_at)
        return ready

    def refresh_bins(self, pgs: list, entity_hints: list,
                     model_version: int) -> list[np.ndarray]:
        """Stage-1 executor for :class:`RefreshDriver`: each padded bin is
        posted to the shard process owning the bin's first dirty entity and
        the children compute their bins concurrently — the batch layer
        comes off the serving GIL.  Pure compute: any child gives
        bit-identical ``h``.

        A child has at most one bin in flight: its next bin is posted once
        its reply to the last one is read.  Posting them all first can
        deadlock on large bins — the parent blocked sending bin 2 into a
        full pipe while the child is blocked sending bin 1's rows back."""
        n = len(self._children)
        jobs = []
        queued: dict[int, list[int]] = {}
        for i, (pg, ent) in enumerate(zip(pgs, entity_hints)):
            wid = 0 if n == 1 else entity_shard(int(ent), n)
            secs = [(name, np.asarray(v))
                    for name, v in pg._asdict().items() if v is not None]
            header = {"cmd": "refresh", "version": int(model_version),
                      "fields": [name for name, _ in secs]}
            jobs.append((wid, header, secs))
            queued.setdefault(wid, []).append(i)
        inflight: dict[int, tuple] = {}

        def post_next(wid: int) -> None:
            i = queued[wid].pop(0)
            _, header, secs = jobs[i]
            try:
                c = self._children[wid]
                inflight[wid] = (c, c.post(dict(header), secs), i)
            except WorkerDied:
                self._restart_child(wid)
                c = self._children[wid]
                inflight[wid] = (c, c.post(dict(header), secs), i)

        for wid in sorted(queued):
            post_next(wid)
        out: list = [None] * len(jobs)
        while inflight:
            for wid in sorted(inflight):
                c, mid, i = inflight.pop(wid)
                try:
                    _, s = c.wait(mid)
                except WorkerDied:
                    self._restart_child(wid)
                    _, s = self._request(wid, jobs[i][1], jobs[i][2])
                out[i] = np.asarray(s["h"], np.float32)
                if queued[wid]:
                    post_next(wid)
        return out

    def reshard(self, num_workers: int):
        """Drain, snapshot every shard, respawn the topology at the new
        width, and re-place all entries under the new rendezvous layout —
        the process backend's equivalent of the inline pool's atomic
        router+store+workers migration."""
        num_workers = int(num_workers)
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if num_workers > 1 and not self.store.shard_by_entity:
            raise ValueError(
                "process backend reshard to >1 workers requires "
                "shard_by_entity=True")
        out = self.flush()
        items = [it for shard in self.store.shard_items() for it in shard]
        for c in self._children:
            c.destroy(stop=True)
        if self.store.shard_by_entity:
            self._store_cfg["num_shards"] = num_workers
            self.store.num_shards = num_workers
        self._journal = {}
        self._children = [self._spawn_child(w) for w in range(num_workers)]
        for w in range(num_workers):
            self._replay_model_chain(w)
        self.router.reshard(num_workers)
        tmpl = self.workers[0]
        self.workers = [
            SpeedLayerWorker(
                w,
                Stage2Scorer(tmpl.scorer.params, tmpl.scorer.cfg, self.store,
                             tmpl.scorer.k_max,
                             model_version=tmpl.scorer.model_version,
                             device=self.device),
                max_batch=tmpl.batcher.max_batch,
                max_wait_s=tmpl.batcher.max_wait_s,
                service_model_s=tmpl.service_model_s,
            )
            for w in range(num_workers)
        ]
        self._attach_score_fns()
        new_shards: list[list] = [[] for _ in range(self.store.num_shards)]
        for it in items:
            new_shards[self.store.shard_of(it[0])].append(it)
        self.store.load_items(new_shards)
        return out

    def shutdown(self) -> None:
        """Stop every shard process, unlink shared memory, drop the model
        spool.  Idempotent — the service calls it from ``close()`` and
        tests call it directly.  Store size and stats are cached first so
        post-close summaries (ReplayReport, final ServiceStats) still
        render without reaching for a dead child."""
        if self._closed:
            return
        try:
            self._final_stats = self.child_stats_sum()
            self._final_len = self.store_len()
        except (WorkerDied, ChildError, OSError):
            # a child died during teardown: freeze whatever we know
            self._final_stats = getattr(self, "_final_stats", {})
            self._final_len = getattr(self, "_final_len", 0)
        self._closed = True
        for c in self._children:
            c.destroy(stop=True)
        shutil.rmtree(self._model_dir, ignore_errors=True)

    # ------------------------------------------------------------------- stats
    def worker_summary(self) -> list[dict]:
        out = super().worker_summary()
        for row in out:
            row["alive"] = (not self._closed
                            and self._children[row["worker"]].alive())
        return out


__all__ = [
    "ChildError",
    "DEFAULT_RING_BYTES",
    "ProcStoreView",
    "ProcessWorkerPool",
    "ShardServer",
    "ShmRing",
    "WorkerDied",
    "pack_frame",
    "unpack_frame",
]
