"""Crash consistency on the port (``repro_torch.stream.checkpoint`` and the
facade's ``enable_wal`` / ``checkpoint`` / ``restore``), on the CPU:

* the reference's write-ahead-log tests against the port's
  ``WriteAheadLog``, and WAL lines byte-equal to the reference's for the
  same events;
* the checkpoint commit protocol and lifecycle rules;
* the crash matrix: at every crash point the inline backend crosses (all of
  ``CRASH_POINTS`` but ``worker_kill``), at one and four workers, with a
  mid-stream hot swap and checkpoint, crash → restore → replay → resume
  gives the uninterrupted run's scores and KV bytes bit for bit;
* the process backend (``repro_torch.stream.procpool``) at one and four
  workers: a checkpoint gathers the shards out of the shard processes and
  a restore re-seeds fresh ones, and ``worker_kill`` SIGKILLs a shard
  process mid-stream — each bit for bit against the inline backend's
  uninterrupted run;
* the reference's hypothesis property over random crash, checkpoint and
  swap positions;
* a crash on the async refresh thread reaches the caller and leaves no
  thread running, and recovery is exact;
* a recovery root the reference wrote restores in the port and resumes
  within 1e-5 (scores) / 2e-5 (KV) of the reference's own uninterrupted
  run, and one the port wrote restores in the reference.
"""
import dataclasses
import functools
import json
import os
import shutil
import tempfile
import warnings

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as R
import repro.data as RD
import repro.service as RSV
import repro.stream.checkpoint as RC
import repro.stream.events as RE
from repro_torch.core import LNNConfig, lnn_init
from repro_torch.data import SynthConfig, generate_event_stream
from repro_torch.params import from_numpy
from repro_torch.service import FraudService, ModelSection, ServiceConfig, ServiceLifecycleError
from repro_torch.stream.checkpoint import (CheckpointError, WriteAheadLog, decode_event,
                                           encode_event, latest_checkpoint, list_checkpoints,
                                           prune_checkpoints, read_checkpoint, wal_path)
from repro_torch.stream.events import CheckoutEvent
from repro_torch.utils import crashpoint
from repro_torch.utils.crashpoint import CRASH_POINTS, SimulatedCrash

SCORE_TOL = 1e-5
STORE_TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: many small products, and under several test
    workers torch's default of a thread per core oversubscribes the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ev(i, cls=CheckoutEvent, snapshot=0, feats=(0.5, -0.25)):
    return cls(order_id=i, snapshot=snapshot, entities=(i % 3, 10 + i % 2),
               features=np.asarray(feats, np.float32), label=float(i % 2),
               arrival=0.001 * i)


# ------------------------------------------------------------------ WAL core
def test_wal_append_scan_roundtrip(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal.jsonl"))
    seqs = [wal.append_event("submit", _ev(i)) for i in range(5)]
    seqs.append(wal.append_model(1, "models/v1.npz"))
    seqs.append(wal.append_drain(0.125))
    assert seqs == list(range(1, 8))
    recs = list(wal.scan())
    assert [r["seq"] for r in recs] == seqs
    assert [r["kind"] for r in recs] == ["submit"] * 5 + ["model", "drain"]
    assert recs[5]["version"] == 1 and recs[5]["path"] == "models/v1.npz"
    assert recs[6]["now"] == 0.125
    assert [r["seq"] for r in wal.scan(after_seq=5)] == [6, 7]
    wal.close()


def test_event_codec_is_bit_exact():
    feats = np.asarray([np.float32(1e-42), np.float32(-0.0),
                        np.float32(1.0) / np.float32(3.0), np.float32(3.4e38)], np.float32)
    ev = CheckoutEvent(order_id=7, snapshot=3, entities=(2, 5, 9), features=feats,
                       label=1.0, arrival=0.75)
    back = decode_event(encode_event(ev))
    assert (back.order_id, back.snapshot, back.entities) == (7, 3, (2, 5, 9))
    assert back.features.tobytes() == feats.tobytes()
    assert back.label == 1.0 and back.arrival == 0.75
    assert encode_event(ev) == RC.encode_event(ev)


def test_wal_lines_equal_the_reference(tmp_path):
    """The same actions give the same bytes on disk, and each package reads
    the other's log."""
    a, b = str(tmp_path / "port.jsonl"), str(tmp_path / "ref.jsonl")
    wal, ref = WriteAheadLog(a), RC.WriteAheadLog(b)
    for i in range(6):
        wal.append_event("submit" if i % 3 else "ingest", _ev(i))
        ref.append_event("submit" if i % 3 else "ingest", _ev(i, RE.CheckoutEvent))
    wal.append_model(2, "models/v2.npz"), ref.append_model(2, "models/v2.npz")
    wal.append_drain(None), ref.append_drain(None)
    wal.close(), ref.close()
    assert open(a, "rb").read() == open(b, "rb").read()
    assert list(WriteAheadLog(b).scan()) == list(RC.WriteAheadLog(a).scan())


def test_wal_truncates_torn_tail(tmp_path):
    path = str(tmp_path / "wal.jsonl")
    wal = WriteAheadLog(path)
    for i in range(5):
        wal.append_event("submit", _ev(i))
    wal.close()
    with open(path, "a", encoding="utf-8") as f:
        f.write('{"seq":6,"kind":"submit","order')   # the crash mid-write
    wal2 = WriteAheadLog(path)
    assert wal2.last_seq == 5 and len(list(wal2.scan())) == 5
    assert wal2.append_event("submit", _ev(5)) == 6
    assert [r["seq"] for r in wal2.scan()] == [1, 2, 3, 4, 5, 6]
    wal2.close()


def test_wal_rejects_interior_corruption(tmp_path):
    path = str(tmp_path / "wal.jsonl")
    wal = WriteAheadLog(path)
    for i in range(5):
        wal.append_event("submit", _ev(i))
    wal.close()
    lines = open(path, encoding="utf-8").read().splitlines()
    lines[2] = lines[2][:10] + "X" + lines[2][11:]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    with pytest.raises(CheckpointError, match="interior corruption"):
        WriteAheadLog(path)


def test_wal_crc_catches_field_tampering(tmp_path):
    path = str(tmp_path / "wal.jsonl")
    wal = WriteAheadLog(path)
    for i in range(3):
        wal.append_event("submit", _ev(i))
    wal.close()
    lines = open(path, encoding="utf-8").read().splitlines()
    rec = json.loads(lines[-1])
    rec["label"] = 1.0 - rec["label"]   # tamper, keep the stale crc
    lines[-1] = json.dumps(rec, separators=(",", ":"))
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    wal2 = WriteAheadLog(path)
    assert wal2.last_seq == 2
    wal2.close()


def test_wal_compaction_preserves_suffix_and_respects_pins(tmp_path):
    path = str(tmp_path / "wal.jsonl")
    wal = WriteAheadLog(path)
    for i in range(10):
        wal.append_event("submit", _ev(i))
    pin = wal.pin(4)
    assert wal.compact(upto_seq=6) == 4          # clamped to the pin
    wal.move_pin(pin, 6)
    with pytest.raises(ValueError, match="only advance"):
        wal.move_pin(pin, 5)
    wal.unpin(pin)
    assert wal.compact(upto_seq=6) == 2
    assert wal.first_seq == 7 and wal.last_seq == 10
    assert [r["seq"] for r in wal.scan()] == [7, 8, 9, 10]
    assert wal.append_event("submit", _ev(10)) == 11
    wal.close()
    wal2 = WriteAheadLog(path)
    assert (wal2.first_seq, wal2.last_seq) == (7, 11)
    assert wal2.compact(upto_seq=3) == 0
    wal2.close()


def test_wal_rejects_unknown_event_kind(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal.jsonl"))
    with pytest.raises(ValueError, match="unknown event record kind"):
        wal.append_event("mystery", _ev(0))
    wal.close()


# ------------------------------------------------- service + checkpoint dirs
@pytest.fixture(scope="module")
def tiny_world():
    events, g, _ = generate_event_stream(
        SynthConfig(num_users=30, num_rings=2, feature_noise=0.8, seed=5), rate_per_s=500.0)
    cfg = LNNConfig(num_gnn_layers=2, hidden_dim=8, feat_dim=g.order_features.shape[1],
                    mlp_dims=(8,))
    params = lnn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    return events[:24], cfg, params


def _build(cfg, params, num_workers=1, **sections):
    sc = ServiceConfig(mode="streaming", model=ModelSection.from_lnn_config(cfg)).replace(
        engine={"num_workers": num_workers, "max_batch": 4}, **sections)
    return FraudService(sc, params=params, device="cpu").build()


def test_enable_wal_lifecycle_rules(tiny_world, tmp_path):
    events, cfg, params = tiny_world
    svc = _build(cfg, params)
    with pytest.raises(ServiceLifecycleError, match="requires enable_wal"):
        svc.checkpoint()
    with pytest.raises(ServiceLifecycleError, match="requires enable_wal"):
        svc.enable_auto_checkpoint(every_windows=1)
    svc.enable_wal(str(tmp_path / "a"))
    with pytest.raises(ServiceLifecycleError, match="called twice"):
        svc.enable_wal(str(tmp_path / "b"))
    late = _build(cfg, params)
    late.submit(events[0])
    with pytest.raises(ServiceLifecycleError, match="illegal in state"):
        late.enable_wal(str(tmp_path / "c"))
    smuggled = _build(cfg, params)
    smuggled.engine.ingest(events[0])
    with pytest.raises(ServiceLifecycleError, match="before any traffic"):
        smuggled.enable_wal(str(tmp_path / "c"))


def test_checkpoint_commit_is_atomic_and_idempotent(tiny_world, tmp_path):
    events, cfg, params = tiny_world
    root = str(tmp_path)
    svc = _build(cfg, params).enable_wal(root)
    for ev in events[:8]:
        svc.submit(ev)
    crashpoint.arm("checkpoint.mid")
    with pytest.raises(SimulatedCrash):
        svc.checkpoint()
    assert latest_checkpoint(root) is None
    assert any(d.endswith(".tmp") for d in os.listdir(os.path.join(root, "checkpoints")))
    path = svc.checkpoint()
    assert latest_checkpoint(root) == path
    assert not any(d.endswith(".tmp") for d in os.listdir(os.path.join(root, "checkpoints")))
    assert svc.checkpoint() == path
    manifest, arrays = read_checkpoint(path)
    assert manifest["applied_seq"] == svc.applied_seq and manifest["events_logged"] == 8
    assert manifest["models"] == {"0": "models/v0.npz"}
    os.makedirs(os.path.join(root, "checkpoints", "ckpt-garbage"))
    os.makedirs(os.path.join(root, "checkpoints", "ckpt-999999999999"))
    assert list_checkpoints(root) == [path]
    for ev in events[8:16]:
        svc.submit(ev)
    later = svc.checkpoint(compact=True)
    assert latest_checkpoint(root) == later
    assert svc.wal.first_seq == svc.applied_seq + 1
    assert prune_checkpoints(root, 1) == [path] and list_checkpoints(root) == [later]


def test_auto_checkpoint_compacts_and_prunes(tiny_world, tmp_path):
    events, cfg, params = tiny_world
    root = str(tmp_path)
    svc = _build(cfg, params).enable_wal(root)
    svc.enable_auto_checkpoint(every_windows=1, keep_last=1)
    for ev in events:
        svc.submit(ev)
    auto = svc.stats().extra["auto_checkpoint"]
    assert auto["checkpoints"] >= 2 and auto["pruned"] == auto["checkpoints"] - 1
    assert len(list_checkpoints(root)) == 1
    restored = FraudService.restore(root, device="cpu")
    assert restored.engine.ingester.num_events == len(events)


def test_restore_without_checkpoint_replays_genesis(tiny_world, tmp_path):
    events, cfg, params = tiny_world
    root = str(tmp_path)
    svc = _build(cfg, params).enable_wal(root)
    for ev in events[:10]:
        svc.submit(ev)
    svc2 = FraudService.restore(root, device="cpu")
    rec = svc2.last_recovery
    assert rec["checkpoint"] is None and rec["replayed_records"] == svc.applied_seq
    assert svc2.applied_seq == svc.applied_seq and svc2.engine.ingester.num_events == 10
    assert rec["seconds"] > 0
    assert svc2.model_params(0)["input"]["w"].device.type == "cpu"


def test_restore_keeps_logging_so_recoveries_chain(tiny_world, tmp_path):
    events, cfg, params = tiny_world
    root = str(tmp_path)
    svc = _build(cfg, params).enable_wal(root)
    for ev in events[:6]:
        svc.submit(ev)
    svc2 = FraudService.restore(root, device="cpu")
    for ev in events[6:12]:
        svc2.submit(ev)
    svc3 = FraudService.restore(root, device="cpu")
    assert svc3.engine.ingester.num_events == 12 and svc3.applied_seq == svc2.applied_seq
    wal = WriteAheadLog(wal_path(root))
    assert wal.last_seq >= 12
    wal.close()


def test_restore_rejects_future_format(tiny_world, tmp_path):
    events, cfg, params = tiny_world
    root = str(tmp_path)
    svc = _build(cfg, params).enable_wal(root)
    svc.submit(events[0])
    path = svc.checkpoint()
    mpath = os.path.join(path, "manifest.json")
    manifest = json.load(open(mpath))
    manifest["format"] = 999
    json.dump(manifest, open(mpath, "w"))
    with pytest.raises(CheckpointError, match="format"):
        FraudService.restore(root, device="cpu")


# ------------------------------------------------------- the fault harness
# (the reference's tests/faultinject.py binds repro's FraudService; this is
# the same client + supervisor pair around the port's)
def store_contents(store) -> dict:
    """key -> (embedding bytes, model version) for every entry, every shard."""
    return {k: (np.asarray(v).tobytes(), mv)
            for shard in store.shard_items() for k, v, _ver, _st, mv in shard}


def drive(svc, events, start=0, *, swap=None, checkpoint_at=None, out=None):
    """Feed ``events[start:]`` through ``svc.submit`` and drain; ``swap =
    (index, params, version)`` hot-swaps after ``events[index]``,
    ``checkpoint_at`` checkpoints after that event.  Responses land in
    ``out`` as they are delivered."""
    responses = out if out is not None else []
    for i in range(start, len(events)):
        responses.extend(svc.submit(events[i]))
        if swap is not None and i == swap[0]:
            svc.load_model(swap[1], version=swap[2])
        if checkpoint_at is not None and i == checkpoint_at:
            svc.checkpoint()
    responses.extend(svc.drain())
    return responses


def merge_close(merged: dict, responses) -> dict:
    """:func:`merge_responses` across the two packages: a duplicate delivery
    (one package's before the crash, the other's on replay) agrees within
    the scores' tolerance and in its model version."""
    for r in responses:
        if not r.admitted:
            continue
        oid = r.request.tag.order_id
        if oid in merged:
            assert merged[oid][1] == r.model_version
            assert abs(merged[oid][0] - r.score) <= SCORE_TOL
        merged[oid] = (r.score, r.model_version)
    return merged


def merge_responses(merged: dict, responses) -> dict:
    """Fold responses into ``order_id -> (score, model_version)``; a
    duplicate delivery must agree bit for bit."""
    for r in responses:
        if not r.admitted:
            continue
        oid = r.request.tag.order_id
        val = (r.score, r.model_version)
        if oid in merged and merged[oid] != val:
            raise AssertionError(f"duplicate delivery disagrees for order {oid}: "
                                 f"{merged[oid]} vs {val}")
        merged[oid] = val
    return merged


def run_uninterrupted(make_service, events, *, swap=None):
    svc = make_service()
    responses = drive(svc, events, swap=swap)
    return merge_responses({}, responses), store_contents(svc.store)


def run_with_crash(make_service, events, root, point, hit=1, *, swap=None,
                   checkpoint_at=None):
    """Crash at the ``hit``-th firing of ``point``, restore, resume."""
    svc = make_service().enable_wal(root)
    delivered: list = []
    crashed = None
    crashpoint.arm(point, hit=hit)
    try:
        drive(svc, events, swap=swap, checkpoint_at=checkpoint_at, out=delivered)
    except SimulatedCrash as exc:
        crashed = exc
    finally:
        crashpoint.disarm()
    svc.wal.close()           # the dead process's file handles die with it

    svc2 = FraudService.restore(root, device="cpu")
    merged = merge_responses({}, delivered)
    merge_responses(merged, svc2.last_recovery["responses"])
    resume = svc2.engine.ingester.num_events
    if swap is not None and resume > swap[0] and svc2.model_version < swap[2]:
        svc2.load_model(swap[1], version=swap[2])
    resumed = drive(
        svc2, events, start=resume,
        swap=swap if (swap is not None and resume <= swap[0]) else None,
        checkpoint_at=checkpoint_at
        if (checkpoint_at is not None and resume <= checkpoint_at) else None)
    merge_responses(merged, resumed)
    return {"scores": merged, "store": store_contents(svc2.store), "crashed": crashed}


# ------------------------------------------------------------ crash matrix
N_EVENTS = 60
SWAP_AT = 25
CHECKPOINT_AT = 12
#: hit count per point, so that the crash lands mid-stream (the reference's)
_HITS = {
    "wal.append.before": 40, "wal.append.after": 40,
    "ingest.before": 35, "ingest.after": 35,
    "flush.before_score": 8, "flush.after_score": 8,
    "refresh.before_stage1": 6, "refresh.before_puts": 6, "refresh.after": 6,
    "kv.put_batch.before": 5, "kv.put_batch.after": 5,
    "checkpoint.before": 1, "checkpoint.mid": 1, "checkpoint.after": 1,
}
#: ``worker_kill`` is a shard-process death, crossed by the process backend only
_INLINE_POINTS = [p for p in CRASH_POINTS if p != "worker_kill"]


def test_the_matrix_covers_every_inline_crash_point():
    assert sorted(_HITS) == sorted(_INLINE_POINTS)


@pytest.fixture(scope="module")
def crash_world():
    events, g, _ = generate_event_stream(
        SynthConfig(num_users=40, num_rings=2, feature_noise=0.8, seed=3), rate_per_s=500.0)
    cfg = LNNConfig(num_gnn_layers=2, hidden_dim=8, feat_dim=g.order_features.shape[1],
                    mlp_dims=(8,))
    params = lnn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    swap_params = lnn_init(torch.Generator().manual_seed(7), cfg, device="cpu")
    return events[:N_EVENTS], cfg, params, swap_params


@pytest.fixture(scope="module")
def baselines(crash_world):
    events, cfg, params, swap_params = crash_world
    return {n: run_uninterrupted(lambda n=n: _build(cfg, params, n), events,
                                 swap=(SWAP_AT, swap_params, 1)) for n in (1, 4)}


@pytest.mark.parametrize("num_workers", [1, 4])
@pytest.mark.parametrize("point", _INLINE_POINTS)
def test_crash_matrix(crash_world, baselines, tmp_path, point, num_workers):
    events, cfg, params, swap_params = crash_world
    res = run_with_crash(lambda: _build(cfg, params, num_workers), events, str(tmp_path),
                         point, hit=_HITS[point], swap=(SWAP_AT, swap_params, 1),
                         checkpoint_at=CHECKPOINT_AT)
    assert res["crashed"] is not None and res["crashed"].point == point
    assert crashpoint.armed() is None
    base_scores, base_store = baselines[num_workers]
    assert set(res["scores"]) == set(base_scores)
    assert res["scores"] == base_scores
    assert res["store"] == base_store


@pytest.mark.parametrize("num_workers", [1, 4])
def test_worker_kill_process_backend(crash_world, baselines, num_workers):
    """SIGKILL a shard process mid-stream (the ``worker_kill`` crash point
    turns the 8th SCORE post into a kill of its target child).  The pool
    restores the shard from its last snapshot + put-journal suffix and
    re-dispatches the in-flight flush exactly once: every order answered
    once, scores AND KV bytes bit-identical to the inline backend's
    uninterrupted run, and the one restart visible in the per-worker
    stats."""
    events, cfg, params, swap_params = crash_world
    svc = _build(cfg, params, num_workers, workers={"backend": "process"})
    try:
        crashpoint.arm("worker_kill", hit=8)
        try:
            responses = drive(svc, events, swap=(SWAP_AT, swap_params, 1))
        finally:
            crashpoint.disarm()
        pool = svc.engine.pool
        assert sum(row["restarts"] for row in pool.worker_summary()) == 1
        assert pool.dead_workers() == 0
        assert sorted(r.request.tag.order_id for r in responses) == \
            sorted(ev.order_id for ev in events)
        base_scores, base_store = baselines[num_workers]
        assert merge_responses({}, responses) == base_scores
        assert store_contents(svc.store) == base_store
    finally:
        svc.close()


@pytest.mark.parametrize("num_workers", [1, 4])
@pytest.mark.parametrize("backend", ["inline", "process"])
def test_checkpoint_restore_roundtrip_backends(crash_world, baselines, tmp_path, backend,
                                               num_workers):
    """Mid-stream checkpoint → abandon → restore → finish, with a hot swap
    in the feed: merged scores and KV bytes equal the inline backend's
    uninterrupted run, for BOTH worker backends.  With backend='process'
    the checkpoint gathers shard state out of the worker processes and
    restore re-seeds a fresh set of them."""
    events, cfg, params, swap_params = crash_world
    root = str(tmp_path / "root")
    svc = _build(cfg, params, num_workers, workers={"backend": backend}).enable_wal(root)
    delivered: list = []
    for i, ev in enumerate(events[:40]):
        delivered.extend(svc.submit(ev))
        if i == SWAP_AT:
            svc.load_model(swap_params, version=1)
        if i == CHECKPOINT_AT:
            svc.checkpoint()
    # abandon mid-stream (the crash): no flush, no drain — just release the
    # shard processes and the WAL handle the restore will reopen
    svc.engine.pool.shutdown()
    svc.wal.close()
    svc2 = FraudService.restore(root, device="cpu")
    try:
        assert svc2.engine.ecfg.backend == backend and svc2.model_version == 1
        merged = merge_responses({}, delivered)
        merge_responses(merged, svc2.last_recovery["responses"])
        assert svc2.engine.ingester.num_events == 40
        merge_responses(merged, drive(svc2, events, start=40))
        base_scores, base_store = baselines[num_workers]
        assert merged == base_scores
        assert store_contents(svc2.store) == base_store
    finally:
        svc2.close()


def test_crash_on_the_async_refresh_thread(crash_world, tmp_path):
    """A crash raised on the async refresh thread reaches the caller (once:
    at the next window close or barrier), ``close`` then leaves no thread
    behind, and the recovery from the WAL answers every order and ends with
    the uninterrupted run's KV bytes.  Scores are not compared: with the
    refresh on its own thread, which snapshot a flush reads depends on
    timing, in the reference as in the port."""
    events, cfg, params, _ = crash_world
    _, base_store = run_uninterrupted(lambda: _build(cfg, params), events)
    root = str(tmp_path)
    svc = _build(cfg, params, refresh={"async_refresh": True}).enable_wal(root)
    delivered: list = []
    crashpoint.arm("refresh.before_puts", hit=4)
    try:
        with pytest.raises(SimulatedCrash):
            drive(svc, events, out=delivered)
    finally:
        crashpoint.disarm()
    threads = list(svc.engine.refresher._pool._threads)
    svc.close()
    assert svc.state == "closed" and threads and not any(t.is_alive() for t in threads)

    svc2 = FraudService.restore(root, device="cpu")
    answered = {r.request.tag.order_id for r in delivered}
    answered |= {r.request.tag.order_id for r in svc2.last_recovery["responses"]}
    rest = drive(svc2, events, start=svc2.engine.ingester.num_events)
    answered |= {r.request.tag.order_id for r in rest}
    assert answered == {ev.order_id for ev in events}
    assert store_contents(svc2.store) == base_store
    svc2.close()


# --------------------------------------------------------- property (hypothesis)
MAX_EVENTS = 32


@functools.lru_cache(maxsize=None)
def _prop_world():
    events, g, _ = generate_event_stream(
        SynthConfig(num_users=30, num_rings=2, feature_noise=0.8, seed=9), rate_per_s=500.0)
    cfg = LNNConfig(num_gnn_layers=2, hidden_dim=8, feat_dim=g.order_features.shape[1],
                    mlp_dims=(8,))
    params = lnn_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    swap_params = lnn_init(torch.Generator().manual_seed(3), cfg, device="cpu")
    return tuple(events[:MAX_EVENTS]), cfg, params, swap_params


@functools.lru_cache(maxsize=None)
def _prop_baseline(n: int, use_swap: bool):
    events, cfg, params, swap_params = _prop_world()
    swap = (n // 2, swap_params, 1) if use_swap else None
    return run_uninterrupted(lambda: _build(cfg, params), events[:n], swap=swap)


@settings(max_examples=8, deadline=None)
@given(n=st.integers(6, MAX_EVENTS), crash_at=st.integers(0, MAX_EVENTS),
       ckpt_at=st.integers(0, MAX_EVENTS), use_ckpt=st.booleans(), use_swap=st.booleans())
def test_crash_restore_replay_equals_uninterrupted(n, crash_at, ckpt_at, use_ckpt, use_swap):
    events, cfg, params, swap_params = _prop_world()
    evs = list(events[:n])
    crash_at = min(crash_at, n)
    swap = (n // 2, swap_params, 1) if use_swap else None
    checkpoint_at = min(ckpt_at, max(crash_at - 1, 0)) if use_ckpt else None
    base_scores, base_store = _prop_baseline(n, use_swap)
    root = tempfile.mkdtemp()
    try:
        svc = _build(cfg, params).enable_wal(root)
        delivered: list = []
        for i in range(crash_at):
            delivered.extend(svc.submit(evs[i]))
            if swap is not None and i == swap[0]:
                svc.load_model(swap[1], version=swap[2])
            if checkpoint_at is not None and i == checkpoint_at:
                svc.checkpoint()
        svc.wal.close()      # the crash: the service object is abandoned
        svc2 = FraudService.restore(root, device="cpu")
        merged = merge_responses({}, delivered)
        merge_responses(merged, svc2.last_recovery["responses"])
        resume = svc2.engine.ingester.num_events
        assert resume == crash_at
        if swap is not None and resume > swap[0] and svc2.model_version < 1:
            svc2.load_model(swap_params, version=1)
        merge_responses(merged, drive(
            svc2, evs, start=resume,
            swap=swap if (swap is not None and resume <= swap[0]) else None))
        assert merged == base_scores
        assert store_contents(svc2.store) == base_store
    finally:
        shutil.rmtree(root)


# ------------------------------------------------- across the two packages
@pytest.fixture(scope="module")
def shared_world():
    """The reference's stream and the port's (equal, from one seed), and one
    reference parameter set with its port copy."""
    world = dict(num_users=40, num_rings=2, feature_noise=0.8, seed=11)
    ref_events, g, _ = RD.generate_event_stream(RD.SynthConfig(**world), rate_per_s=500.0)
    events, _, _ = generate_event_stream(SynthConfig(**world), rate_per_s=500.0)
    ref_cfg = R.LNNConfig(num_gnn_layers=2, hidden_dim=16, mlp_dims=(16,),
                          feat_dim=g.order_features.shape[1])
    ref_params = R.lnn_init(jax.random.PRNGKey(4), ref_cfg)
    ref_swap = R.lnn_init(jax.random.PRNGKey(5), ref_cfg)
    to_port = lambda p: from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")  # noqa: E731
    sc = RSV.ServiceConfig(model=RSV.ModelSection.from_lnn_config(ref_cfg)).replace(
        engine={"num_workers": 2, "max_batch": 4})
    return dict(ref_events=ref_events[:70], events=events[:70], ref_params=ref_params,
                ref_swap=ref_swap, params=to_port(ref_params), swap=to_port(ref_swap),
                ref_sc=sc, sc=ServiceConfig.from_json(sc.to_json()),
                cfg=LNNConfig(**{f.name: getattr(ref_cfg, f.name)
                                 for f in dataclasses.fields(LNNConfig)}))


def _close_enough(merged, want, store, want_store):
    assert merged.keys() == want.keys()
    orders = sorted(want)
    np.testing.assert_allclose([merged[o][0] for o in orders], [want[o][0] for o in orders],
                               atol=SCORE_TOL, rtol=SCORE_TOL)
    assert [merged[o][1] for o in orders] == [want[o][1] for o in orders]
    assert store.keys() == want_store.keys()
    keys = sorted(want_store)
    np.testing.assert_allclose(
        np.stack([np.frombuffer(store[k][0], np.float32) for k in keys]),
        np.stack([np.frombuffer(want_store[k][0], np.float32) for k in keys]),
        atol=STORE_TOL, rtol=STORE_TOL)
    assert [store[k][1] for k in keys] == [want_store[k][1] for k in keys]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_root_written_by_one_package_restores_in_the_other(shared_world, tmp_path, writer):
    """Half the stream with a checkpoint and a hot swap, then the crash;
    the other package restores the root and finishes the stream: its merged
    scores and KV store are the writer's uninterrupted run's."""
    w = shared_world
    half, ckpt_at, swap_at = 40, 20, 30
    ref_first = writer == "reference"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        if ref_first:
            make = lambda: RSV.FraudService(w["ref_sc"], params=w["ref_params"]).build()  # noqa: E731
            events, swap = w["ref_events"], (swap_at, w["ref_swap"], 1)
        else:
            make = lambda: FraudService(w["sc"], params=w["params"], device="cpu").build()  # noqa: E731
            events, swap = w["events"], (swap_at, w["swap"], 1)
        want, want_store = run_uninterrupted(make, events, swap=swap)
        root = str(tmp_path)
        svc = make().enable_wal(root)
        delivered: list = []
        for i in range(half):
            delivered.extend(svc.submit(events[i]))
            if i == swap_at:
                svc.load_model(swap[1], version=1)
            if i == ckpt_at:
                svc.checkpoint()
        svc.wal.close()                               # the crash
        if ref_first:
            svc2, rest = FraudService.restore(root, device="cpu"), w["events"]
        else:
            svc2, rest = RSV.FraudService.restore(root), w["ref_events"]
    assert svc2.model_version == 1 and svc2.last_recovery["checkpoint"] is not None
    merged = merge_responses({}, delivered)
    merge_close(merged, svc2.last_recovery["responses"])
    resume = svc2.engine.ingester.num_events
    assert resume == half
    merge_close(merged, drive(svc2, rest, start=resume))
    _close_enough(merged, want, store_contents(svc2.store), want_store)
