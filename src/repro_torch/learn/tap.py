"""WAL training tap — committed log suffixes as a training-data stream
(``repro_torch.learn.tap``, the reference's ``repro.learn.tap``, copied:
host code over the port's WAL and DDS builder).

The write-ahead log already records every scored checkout in
arrival order, bit-exactly.  That makes it the one place training data
can come from without a second ingestion path: the tap re-reads committed
``submit``/``ingest`` records, reconstructs each order's **receptive
cone** with its own :class:`~repro_torch.core.dds.IncrementalDDSBuilder`
(mirroring the serving ingest exactly: ``entity_keys`` is computed
*before* ``add_order``, so the cone is strictly past), and emits
:class:`TrainingExample` rows.

**Delayed-label join.**  Fraud outcomes arrive hours after checkout
(chargebacks, manual review).  :class:`LabelLog` is the authoritative
outcome store keyed by order id; the tap holds each example *pending*
until either its label lands in the log or its ``label_latency_s`` window
expires, at which point the example is finalized with the event-time
label (the generator's ground truth in this repo; a weak/heuristic label
in production).  ``label_latency_s=0`` short-circuits the join: event
labels are final at ingest.

**Compaction interlock.**  The tap holds a :meth:`WriteAheadLog.pin` at
its scan cursor, so a concurrent ``compact()`` (e.g. the scheduled
checkpointer) can never delete records the tap has not consumed yet —
the pin clamps the truncation point
(``tests/test_torch_learn.py::test_tap_pins_survive_interleaved_compaction``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from repro_torch.core.dds import IncrementalDDSBuilder
from repro_torch.stream.checkpoint import WriteAheadLog, decode_event

__all__ = ["LabelLog", "TrainingExample", "WalTrainingTap"]


@dataclass(frozen=True)
class TrainingExample:
    """One labeled checkout, ready for a rolling-window fine-tune.

    ``entity_keys`` is the strictly-past receptive cone — the same
    ``(entity, snapshot)`` KV keys the speed layer would have fetched for
    this order, reconstructed from the tap's own builder state at the
    moment the record was read.  ``label`` is the *joined* outcome (see
    :class:`LabelLog`); ``label_source`` records where it came from
    (``"event"`` or ``"label_log"``).
    """

    order_id: int               # source order id (-1 for live traffic)
    snapshot: int               # event-time snapshot
    entities: tuple             # linked (possibly type-tagged) entity ids
    features: np.ndarray        # [F] raw checkout features
    label: float                # joined outcome
    arrival: float              # virtual arrival time, seconds
    seq: int                    # WAL seqno of the source record
    entity_keys: tuple = ()     # strictly-past ((entity, t), ...) cone
    label_source: str = "event"


class LabelLog:
    """Authoritative delayed-outcome store, keyed by order id.

    ``record`` registers a confirmed outcome (chargeback, manual-review
    verdict); the tap consults :meth:`get` when an example's label-latency
    window closes.  Later records for the same order overwrite earlier
    ones — the freshest verdict wins.
    """

    def __init__(self):
        self._labels: dict[int, float] = {}
        self.recorded = 0

    def record(self, order_id: int, label: float) -> None:
        """Register the confirmed outcome for ``order_id``."""
        self._labels[int(order_id)] = float(label)
        self.recorded += 1

    def get(self, order_id: int) -> float | None:
        """The recorded outcome, or None if no verdict has landed."""
        return self._labels.get(int(order_id))

    def __len__(self) -> int:
        return len(self._labels)


@dataclass
class _Pending:
    example: TrainingExample = None  # label still provisional
    deadline: float = 0.0            # arrival + label_latency_s


class WalTrainingTap:
    """Incremental reader: WAL records → labeled :class:`TrainingExample` s.

    ``poll(now)`` consumes every committed record past the cursor, feeds
    the internal DDS builder (receptive-cone reconstruction), and returns
    the examples whose labels are *final* — immediately when
    ``label_latency_s == 0``, otherwise once the label-log join resolves
    or the latency window expires.  ``now`` defaults to the latest arrival
    seen, so virtual-time streams drive the join without a wall clock.

    The tap pins the WAL at its cursor for its whole lifetime; call
    :meth:`close` (or use as a context manager) to release the pin and let
    compaction advance past consumed records.
    """

    def __init__(self, wal: WriteAheadLog, feat_dim: int, *,
                 label_log: LabelLog | None = None,
                 label_latency_s: float = 0.0,
                 include_ingest: bool = True,
                 entity_history: str = "all",
                 max_history: int | None = None,
                 start_after_seq: int = 0):
        if label_latency_s < 0:
            raise ValueError("label_latency_s must be >= 0")
        self.wal = wal
        self.label_log = label_log if label_log is not None else LabelLog()
        self.label_latency_s = float(label_latency_s)
        self.include_ingest = bool(include_ingest)
        self.builder = IncrementalDDSBuilder(
            feat_dim=int(feat_dim), entity_history=entity_history,
            max_history=max_history)
        self._cursor = int(start_after_seq)
        self._pin = wal.pin(self._cursor)
        self._pending: list[_Pending] = []   # arrival order
        self._now = 0.0
        self.stats = {"records": 0, "skipped": 0, "examples": 0,
                      "label_joins": 0, "label_defaults": 0}

    # ------------------------------------------------------------------ poll
    @property
    def cursor(self) -> int:
        """Last WAL seqno consumed (the pin sits here)."""
        return self._cursor

    @property
    def pending(self) -> int:
        """Examples read but still awaiting their label-latency window."""
        return len(self._pending)

    def poll(self, now: float | None = None) -> list[TrainingExample]:
        """Consume new WAL records; return label-final examples in order."""
        for rec in self.wal.scan(after_seq=self._cursor):
            self._cursor = int(rec["seq"])
            self.stats["records"] += 1
            kind = rec.get("kind")
            if kind == "submit" or (kind == "ingest" and self.include_ingest):
                ev = decode_event(rec)
                self._now = max(self._now, float(ev.arrival))
                # mirror StreamIngester.ingest: cone BEFORE add_order,
                # so the keys are strictly past (no self-leak)
                keys = self.builder.entity_keys(ev.entities, ev.snapshot)
                self.builder.add_order(
                    ev.entities, ev.snapshot, ev.features, ev.label)
                ex = TrainingExample(
                    order_id=int(ev.order_id), snapshot=int(ev.snapshot),
                    entities=tuple(ev.entities), features=ev.features,
                    label=float(ev.label), arrival=float(ev.arrival),
                    seq=int(rec["seq"]), entity_keys=tuple(keys))
                self._pending.append(_Pending(
                    example=ex, deadline=ex.arrival + self.label_latency_s))
            else:
                self.stats["skipped"] += 1
        self.wal.move_pin(self._pin, self._cursor)
        return self._resolve(self._now if now is None else float(now))

    def _resolve(self, now: float) -> list[TrainingExample]:
        """Finalize pending examples: joined label beats the event label;
        a pending example is released early the moment its verdict lands,
        or at window expiry with the event-time label as fallback."""
        out, still = [], []
        for p in self._pending:
            ex = p.example
            verdict = self.label_log.get(ex.order_id)
            if verdict is not None:
                out.append(dataclasses.replace(
                    ex, label=float(verdict), label_source="label_log"))
                self.stats["label_joins"] += 1
            elif now >= p.deadline:
                out.append(ex)          # event label stands
                self.stats["label_defaults"] += 1
            else:
                still.append(p)
        self._pending = still
        self.stats["examples"] += len(out)
        return out

    # ----------------------------------------------------------------- close
    def close(self) -> None:
        """Release the compaction pin (idempotent)."""
        self.wal.unpin(self._pin)

    def __enter__(self) -> "WalTrainingTap":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
