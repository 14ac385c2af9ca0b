"""Checkout event model + replay-stream construction.

A :class:`CheckoutEvent` is the unit the streaming engine consumes: one
checkout with its linked entities, raw features, and a (virtual) arrival
time.  ``events_from_static`` turns any :class:`~repro_torch.core.dds.StaticGraph`
(e.g. the synthetic generator's output) into an event-time-ordered stream
with Poisson arrivals — the replay harness and benchmarks drive the engine
with it.

Arrival times are *virtual seconds*: the replay harness advances a virtual
clock, so queueing behavior (micro-batch flush deadlines, wait times) is
deterministic and independent of host speed, while the service times of
the stage-2 calls are measured on the real clock.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.dds import StaticGraph


@dataclass(frozen=True)
class CheckoutEvent:
    """One checkout on the wire: the unit of streaming ingest and scoring.

    ``entities`` may be raw ids (homogeneous) or type-tagged ids
    (``core.hetero.tag_entity``) — both travel as plain ints through the
    WAL and checkpoints."""

    order_id: int             # id in the source static graph (-1 for live traffic)
    snapshot: int             # event-time snapshot index (paper: one day)
    entities: tuple           # linked global entity ids, in entity-type order
    features: np.ndarray      # [F] raw checkout features
    label: float              # ground truth (evaluation only — never an input)
    arrival: float            # virtual arrival time, seconds


def order_event_tuples(g: StaticGraph):
    """Yield (order_id, snapshot, entities, features, label) in event-time
    order (stable by static order id within a snapshot).

    Entity order per checkout preserves the static edge order, so a DDS
    graph built incrementally from this stream is bit-identical to the batch
    build on the same transactions.
    """
    ents_of: dict[int, list[int]] = {}
    for o, e in g.edges:
        ents_of.setdefault(int(o), []).append(int(e))
    for o in np.argsort(g.order_snapshot, kind="stable"):
        o = int(o)
        yield (o, int(g.order_snapshot[o]), tuple(ents_of.get(o, ())),
               g.order_features[o], float(g.labels[o]))


def events_from_static(
    g: StaticGraph,
    rate_per_s: float = 200.0,
    seed: int = 0,
) -> list[CheckoutEvent]:
    """Replay stream: the static graph's checkouts in event-time order with
    Poisson inter-arrival gaps at ``rate_per_s`` events/second."""
    rng = np.random.default_rng(seed)
    events = []
    now = 0.0
    for o, t, ents, feats, label in order_event_tuples(g):
        now += float(rng.exponential(1.0 / rate_per_s))
        events.append(CheckoutEvent(order_id=o, snapshot=t, entities=ents,
                                    features=feats, label=label, arrival=now))
    return events
