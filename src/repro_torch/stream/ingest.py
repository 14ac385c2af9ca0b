"""Event-time streaming ingester — extends the DDS graph as checkouts arrive.

Wraps :class:`repro_torch.core.dds.IncrementalDDSBuilder` with the window
bookkeeping the Lambda loop needs:

* tracks the **open snapshot** (events still arriving) vs **closed
  snapshots** (event time moved past them — their DDS in-neighborhoods are
  final, per the no-future-leak invariant, so the batch layer may refresh
  their embeddings exactly once);
* answers the speed-layer question per event: the exact ``(entity, t_e)``
  KV keys that feed this checkout's final-hop edges;
* marks touched entities **dirty** so the refresh driver knows which
  embeddings the next batch run must (re)write;
* maintains the **community assignment** (connected components of the
  order↔entity graph, ``core.partition.IncrementalPartitioner``) alongside
  the dirty pairs, so the community-local refresh driver can materialize
  and recompute only the components that actually changed — O(dirty
  communities) batch-layer work per refresh instead of O(total stream).

The ingester never runs the model — it is pure host-side graph state, cheap
enough to sit on the hot path (O(K·history) per event).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.dds import DDSGraph, IncrementalDDSBuilder
from repro_torch.core.partition import IncrementalPartitioner
from repro_torch.stream.events import CheckoutEvent
from repro_torch.utils import crashpoint


@dataclass
class IngestResult:
    """Per-event ingest outcome handed to the engine."""

    order_id: int                   # builder-local order id (arrival order)
    entity_keys: list               # [(entity, t_e)] exact speed-layer keys
    # (first, last) snapshot range this event's arrival closed, or None.
    # Kept as bounds, never materialized: sparse snapshot indices (e.g.
    # epoch hours) would make an explicit range huge
    closed_window: tuple | None = None


class StreamIngester:
    """Event-at-a-time DDS growth: feeds each :class:`CheckoutEvent` to the
    incremental builder, tracks the open snapshot window, marks dirty
    ``(entity, t)`` pairs for the refresh driver, and maintains the
    incremental community partition."""

    def __init__(
        self,
        feat_dim: int,
        entity_history: str = "all",
        max_history: int | None = 8,
    ):
        self.builder = IncrementalDDSBuilder(
            feat_dim, entity_history=entity_history, max_history=max_history
        )
        self._open_snapshot = -1
        self._dirty: set = set()          # (entity, t) pairs awaiting refresh
        self.partitioner = IncrementalPartitioner()
        self.stats = {"events": 0, "windows_closed": 0}

    @property
    def open_snapshot(self) -> int:
        return self._open_snapshot

    @property
    def num_events(self) -> int:
        return self.stats["events"]

    def ingest(self, event: CheckoutEvent) -> IngestResult:
        """Consume one checkout: compute its speed-layer keys, extend the
        DDS graph, and report any snapshot windows the arrival closed."""
        crashpoint.fire("ingest.before")
        t = int(event.snapshot)
        closed = None
        if t > self._open_snapshot:
            if self._open_snapshot >= 0:
                closed = (self._open_snapshot, t - 1)
                self.stats["windows_closed"] += t - self._open_snapshot
            self._open_snapshot = t
        # keys BEFORE this event activates (entity, t): strictly-past only
        keys = self.builder.entity_keys(event.entities, t)
        o = self.builder.add_order(event.entities, t, event.features, event.label)
        self.partitioner.add_order(event.entities)
        for ent in event.entities:
            self._dirty.add((int(ent), t))
        self.stats["events"] += 1
        crashpoint.fire("ingest.after")
        return IngestResult(order_id=o, entity_keys=keys, closed_window=closed)

    # ---------------------------------------------------------------- refresh
    def take_refreshable(self, up_to_snapshot: int) -> list:
        """Drain dirty (entity, t) pairs with ``t <= up_to_snapshot`` — the
        embeddings whose in-neighborhoods are final and must be (re)written
        by the next batch-layer run.  Pairs in still-open snapshots stay
        pending."""
        ready = [p for p in self._dirty if p[1] <= up_to_snapshot]
        self._dirty.difference_update(ready)
        return sorted(ready)

    def take_refreshable_by_community(self, up_to_snapshot: int) -> list:
        """Like :meth:`take_refreshable`, but grouped by the dirty pairs'
        current communities: ``[(community_id, sorted_pairs)]`` ascending by
        community id.  Community ids are resolved at drain time (they are
        canonical-not-stable under merges, see ``IncrementalPartitioner``)."""
        groups: dict[int, list] = {}
        for pair in self.take_refreshable(up_to_snapshot):
            groups.setdefault(self.partitioner.community_of(pair[0]), []).append(pair)
        return [(c, groups[c]) for c in sorted(groups)]

    @property
    def dirty_count(self) -> int:
        return len(self._dirty)

    @property
    def dirty_communities(self) -> list:
        """Communities containing at least one dirty pair (resolved now)."""
        return sorted({self.partitioner.community_of(p[0]) for p in self._dirty})

    def community_members(self, community: int) -> list:
        return self.partitioner.members(community)

    def community_node_count(self, community: int) -> int:
        """Exact DDS node count of one community's subgraph: two nodes per
        absorbed order (effective + shadow) plus its (entity, t) pairs —
        the budget-packing estimate for community-local refresh."""
        pairs = sum(len(self.builder._active.get(e, ()))
                    for e in self.partitioner.members(community))
        return 2 * self.partitioner.order_count(community) + pairs

    def materialize(self) -> DDSGraph:
        """The accumulated DDS graph (batch-layer input)."""
        return self.builder.build()

    def materialize_communities(self, communities) -> DDSGraph:
        """The DDS subgraph of a union of communities — the community-local
        batch-layer input (`O(touched)`, never `O(total stream)`)."""
        ents: set = set()
        for c in communities:
            ents.update(self.partitioner.members(c))
        return self.builder.build_subgraph(ents)
