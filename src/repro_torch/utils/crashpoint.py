"""Crash-point fault injection — the hooks the recovery harness kills at.

A *crash point* is a named boundary on a durability-relevant code path
(WAL append, DDS ingest, micro-batch flush, batch-layer refresh, KV put,
checkpoint write).  In production every ``fire()`` is a no-op costing one
attribute read; the fault-injection harness (``tests/faultinject.py``)
arms exactly one point and the k-th crossing raises
:class:`SimulatedCrash` — modeling a process death at that instruction
boundary.  The recovery sweep then proves that restoring from the last
checkpoint + replaying the write-ahead log reproduces the uninterrupted
run bit-for-bit, whichever boundary the "process" died at.

This module is a dependency-free leaf on purpose: ``serve.kvstore`` and
``stream.*`` both import it, and neither may import the other (the
checkpoint layer in ``repro.stream.checkpoint`` already imports
``serve.kvstore``).

Only names in :data:`CRASH_POINTS` may fire or be armed — a typo'd name
is an error at arm/fire time, so the sweep in ``tests/test_faultinject.py``
(parametrized over ``CRASH_POINTS``) can never silently skip a boundary.
"""
from __future__ import annotations

#: every registered boundary, in rough hot-path order.  ``.before``/
#: ``.after`` pairs model dying just before vs just after the operation's
#: side effects; ``checkpoint.mid`` fires after the state payload is on
#: disk but before the manifest rename that commits it (a torn checkpoint
#: must be invisible to recovery).
CRASH_POINTS = (
    "wal.append.before",
    "wal.append.after",
    "ingest.before",
    "ingest.after",
    "flush.before_score",
    "flush.after_score",
    "refresh.before_stage1",
    "refresh.before_puts",
    "refresh.after",
    "kv.put_batch.before",
    "kv.put_batch.after",
    "checkpoint.before",
    "checkpoint.mid",
    "checkpoint.after",
    # process-backend only: fires in the parent just before a SCORE frame is
    # posted to a shard process; the harness converts it into a SIGKILL of
    # that child (tests/test_procpool.py) — the inline pool never crosses it
    "worker_kill",
)

_KNOWN = frozenset(CRASH_POINTS)


class SimulatedCrash(BaseException):
    """The injected process death.

    Derives from ``BaseException`` so no hot-path ``except Exception``
    recovery handler can swallow it — a real SIGKILL is not catchable
    either.  Carries the point name and the firing count at which it
    tripped.
    """

    def __init__(self, point: str, hit: int):
        super().__init__(f"simulated crash at {point!r} (hit #{hit})")
        self.point = point
        self.hit = hit


# module-level armed state: (name, trip-on-hit) or None.  One point at a
# time — the harness models one process death per run.
_ARMED: tuple | None = None
_fired = 0


def arm(name: str, hit: int = 1) -> None:
    """Arm ``name``: the ``hit``-th ``fire(name)`` raises SimulatedCrash."""
    global _ARMED, _fired
    if name not in _KNOWN:
        raise ValueError(f"unknown crash point {name!r}; registered: {CRASH_POINTS}")
    if hit < 1:
        raise ValueError("hit must be >= 1")
    _ARMED = (name, int(hit))
    _fired = 0


def disarm() -> None:
    """Return to the production no-op state (idempotent)."""
    global _ARMED, _fired
    _ARMED = None
    _fired = 0


def armed() -> str | None:
    """The armed point name, or None."""
    return _ARMED[0] if _ARMED is not None else None


def fire(name: str) -> None:
    """Cross the boundary ``name``.  No-op unless that point is armed."""
    global _fired
    if _ARMED is None or _ARMED[0] != name:
        return
    _fired += 1
    if _fired >= _ARMED[1]:
        disarm()  # one death per arm(); recovery code must not re-trip
        raise SimulatedCrash(name, _fired)


__all__ = ["CRASH_POINTS", "SimulatedCrash", "arm", "armed", "disarm", "fire"]
