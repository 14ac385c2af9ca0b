"""Micro-batching scheduler — coalesces concurrent score requests.

The speed layer's stage-2 call is one small kernel launch; dispatch and the
host's KV lookup dominate per-request scoring.  The scheduler queues requests and flushes
them as one fixed-shape batch when either trigger fires:

* **size** — the queue reaches ``max_batch``;
* **deadline** — the oldest queued request has waited ``max_wait_s``
  (virtual seconds), bounding tail latency under light traffic.

Flushed batches are right-padded up to the next power-of-two bucket
(2, 4, ..., max_batch), so the speed layer sees O(log max_batch) shapes
forever, all of them warmed up front — the classic serving-engine
shape-bucketing trick.  Padding rows carry zero features and empty key
lists; their scores are sliced off before results are returned, so batched
scores are bit-identical to unbatched ones (tested).

The queue is guarded by a lock: the multi-worker pool's work stealing
(:meth:`MicroBatcher.take`) and the async refresh thread may drain or grow
the queue between a flush trigger firing and the flush popping the batch.
A flush that loses that race simply emits nothing — it never scores an
empty batch and never inflates the flush counters (regression-tested).
"""
from __future__ import annotations

import threading
import time

import numpy as np

# the canonical typed request/response — repro_torch.service.types is a numpy-only
# leaf module, so this import introduces no package cycle.  ScoredResult is
# the historical streaming name for the service-wide ScoreResponse.
from repro_torch.service.types import ScoreRequest, ScoreResponse
from repro_torch.utils import crashpoint

ScoredResult = ScoreResponse


def bucket_size(n: int, max_batch: int) -> int:
    """Smallest power-of-two >= n, floored at 2, capped at max_batch.

    The floor of 2 is a determinism guarantee, not a perf knob: on the CPU
    a one-row ``X @ W`` goes through a matrix-vector path whose reduction
    order differs bitwise from the matrix product used at two rows or more,
    so singleton flushes are padded to bucket 2 — every request's score is
    then bit-identical no matter which flush composition it rode in.  (On
    the card the ``stage2_score`` kernel computes each row alike at every
    batch size; the floor keeps the two paths' bucket sets equal.)  That invariance is what
    makes N-worker replay scores equal single-worker scores exactly
    (``tests/test_stream.py`` replay-parity)."""
    b = 2
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


class DeferredScore:
    """A score_fn result still in flight (process-backed scorers).

    An inline ``score_fn`` returns ``(probs, staleness[, model_version])``
    synchronously; a process-backed scorer posts the padded batch to its
    owner process and returns one of these instead.  ``wait()`` blocks
    until the reply frame lands and returns the same tuple the inline call
    would have.  :meth:`MicroBatcher.flush` turns a deferred result into a
    :class:`PendingFlush`, which the pool resolves before any result is
    released — delivery order and accounting stay inline-identical while
    several posted flushes overlap in flight across worker processes.
    """

    def __init__(self, wait):
        self._wait = wait

    def wait(self):
        return self._wait()


class PendingFlush:
    """A flush whose scores are still crossing a process boundary.

    Carries everything :meth:`MicroBatcher.flush` had already decided —
    the popped batch, its real row count, the trigger stamp — so
    ``resolve()`` can finish result construction exactly as the inline
    path would have.  Truthiness mirrors a non-empty result list, so the
    worker's per-kind flush accounting is unchanged.
    """

    def __init__(self, batcher, batch, n, now, deferred, t0):
        self.batcher = batcher
        self.batch = batch
        self.n = n
        self.now = now
        self.deferred = deferred
        self.worker = None          # stamped by the worker that flushed
        self._t0 = t0

    def __bool__(self) -> bool:
        return True

    def resolve(self) -> list:
        """Block on the reply and build the ScoredResults (parent side)."""
        probs, staleness, model_version = self.deferred.wait()
        service = time.perf_counter() - self._t0
        out = self.batcher._results(self.batch, self.n, self.now, probs,
                                    staleness, int(model_version), service)
        if self.worker is not None:
            for r in out:
                r.worker = self.worker
        return out


class MicroBatcher:
    """Queue + flush policy for speed-layer micro-batches.

    ``score_fn(features [B, F], key_lists) -> (probs [B], staleness [B])``
    is supplied by the engine; the batcher owns only queueing policy:
    ``submit(request, now)`` enqueues and size-flushes at ``max_batch``,
    ``poll(now)`` deadline-flushes once the oldest request has waited
    ``max_wait_s``, and ``flush(now)`` drains unconditionally.  Flushes are
    right-padded to the next power-of-two bucket (``bucket_size``) so the
    speed layer sees O(log max_batch) shapes.  ``enqueue``/``take`` are the
    policy-free primitives the multi-worker pool composes: enqueue without
    flushing, and atomically steal the oldest queued requests.
    """

    def __init__(self, score_fn, max_batch: int = 16, max_wait_s: float = 0.005,
                 clock=time.monotonic):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.score_fn = score_fn
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_s)
        # deadline scheduling clock, used whenever a caller does not supply
        # ``now``.  Monotonic by default: a wall-clock (``time.time``) here
        # would let an NTP step fire every deadline at once (clock jumps
        # forward) or starve deadline flushes entirely (clock jumps back).
        # Injectable so tests and the replay harness drive virtual time.
        self.clock = clock
        self._queue: list[ScoreRequest] = []
        self._lock = threading.Lock()
        self.stats = {"flushes": 0, "size_flushes": 0, "deadline_flushes": 0,
                      "forced_flushes": 0, "requests": 0, "padded_rows": 0,
                      "empty_flushes": 0, "stolen": 0}

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def oldest_arrival(self) -> float | None:
        with self._lock:
            return self._queue[0].arrival if self._queue else None

    def deadline(self) -> float | None:
        """Virtual time at which the current queue must flush."""
        with self._lock:
            return None if not self._queue \
                else self._queue[0].arrival + self.max_wait_s

    def nth_arrival(self, i: int) -> float | None:
        """Arrival time of the i-th oldest queued request (trigger stamps)."""
        with self._lock:
            return self._queue[i].arrival if i < len(self._queue) else None

    # ------------------------------------------------------------------ queue
    def enqueue(self, request: ScoreRequest) -> None:
        """Append without any flush decision (pool-managed workers)."""
        with self._lock:
            self._queue.append(request)
            self.stats["requests"] += 1

    def take(self, n: int) -> list[ScoreRequest]:
        """Atomically pop up to ``n`` oldest queued requests (work stealing —
        the thief re-enqueues them on another worker)."""
        if n <= 0:
            return []
        with self._lock:
            taken, self._queue = self._queue[:n], self._queue[n:]
            self.stats["stolen"] += len(taken)
        return taken

    def submit(self, request: ScoreRequest,
               now: float | None = None) -> list[ScoredResult]:
        """Enqueue; flush immediately if the size trigger fires.

        When ``now`` is omitted (internal-clock mode) an unstamped request
        (``arrival == 0.0``, the dataclass default) is stamped from the
        same clock — deadline math must never mix clock bases, or a
        wall-clock arrival against a monotonic ``now`` would starve (or
        instantly fire) every deadline flush."""
        if now is None:
            now = self.clock()
            if request.arrival == 0.0:
                request.arrival = now
        self.enqueue(request)
        with self._lock:
            full = len(self._queue) >= self.max_batch
        if not full:
            return []
        out = self.flush(now)
        if out:
            self.stats["size_flushes"] += 1
        return out

    def poll(self, now: float | None = None) -> list[ScoredResult]:
        """Deadline trigger: flush if the oldest request exceeded max_wait.

        The flush is timestamped *at the deadline* (a real engine's timer
        fires then), not at ``now`` — otherwise a request's recorded queue
        wait would stretch to the next arrival under light traffic."""
        if now is None:
            now = self.clock()
        dl = self.deadline()
        if dl is None or now < dl:
            return []
        out = self.flush(dl)
        if out:
            self.stats["deadline_flushes"] += 1
        return out

    # ------------------------------------------------------------------ flush
    def flush(self, now: float | None = None):
        """Score everything queued as one padded fixed-shape batch.

        Returns the ``ScoredResult`` list, or a :class:`PendingFlush` when
        the scorer answered with a :class:`DeferredScore` (process backend
        — the pool resolves it before releasing results).

        The pop is atomic and re-checks emptiness: a concurrent drain (work
        steal, another flush) between the trigger firing and this pop must
        yield an empty no-op, never a zero-row ``score_fn`` call."""
        if now is None:
            now = self.clock()
        with self._lock:
            if not self._queue:
                self.stats["empty_flushes"] += 1
                return []
            batch, self._queue = (self._queue[: self.max_batch],
                                  self._queue[self.max_batch:])
            n = len(batch)
            b = bucket_size(n, self.max_batch)
            self.stats["padded_rows"] += b - n
        feat_dim = batch[0].features.shape[0]
        feats = np.zeros((b, feat_dim), np.float32)
        key_lists: list[list] = [[] for _ in range(b)]
        for i, r in enumerate(batch):
            feats[i] = r.features
            key_lists[i] = list(r.entity_keys)

        crashpoint.fire("flush.before_score")
        t0 = time.perf_counter()
        # scorers may return (probs, staleness) or, when version-aware,
        # (probs, staleness, model_version) — the version whose weights
        # served this flush (hot-swap observability) — or a DeferredScore
        # when the batch was posted to a worker process
        out = self.score_fn(feats, key_lists)
        if isinstance(out, DeferredScore):
            return PendingFlush(self, batch, n, now, out, t0)
        service = time.perf_counter() - t0
        probs, staleness = out[0], out[1]
        model_version = int(out[2]) if len(out) > 2 else 0
        return self._results(batch, n, now, probs, staleness, model_version,
                             service)

    def _results(self, batch, n, now, probs, staleness, model_version,
                 service) -> list[ScoredResult]:
        """Post-score half of a flush — shared by the synchronous path and
        :meth:`PendingFlush.resolve` so accounting and result construction
        cannot drift between backends."""
        crashpoint.fire("flush.after_score")
        with self._lock:        # flushes may run on several threads at once
            self.stats["flushes"] += 1
        return [
            ScoredResult(
                request=r,
                score=float(probs[i]),
                staleness=int(staleness[i]),
                queued_s=max(0.0, now - r.arrival),
                service_s=service,
                batch_size=n,
                model_version=model_version,
            )
            for i, r in enumerate(batch)
        ]
