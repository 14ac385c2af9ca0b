"""Named-attack fraud workload over the heterogeneous entity schema.

``synth.py`` generates the paper's homogeneous fraud world (7 untyped
entity columns per order).  This module generates the *heterogeneous*
counterpart: every order links exactly four **type-tagged** entities —
``buyer``, ``merchant``, ``device``, ``payment`` (``core.hetero``) — and
fraud arrives as three named attack patterns, labeled per order so a
benchmark can report recall per attack (the reference's
``benchmarks/streaming_bench.py`` does):

* ``ring`` — fraud rings: a pool of fake buyer accounts sharing a small
  set of devices and stolen payment tokens, bursting for a few snapshots
  (the classic linkage pattern; graph models should dominate here);
* ``burst`` — merchant compromise: many one-off buyers with stolen
  payment tokens hammer ONE merchant inside a 1–2 snapshot window (hub
  concentration on the merchant node);
* ``bin_test`` — BIN/card testing: one buyer+device cycles many fresh
  payment tokens at a single low-friction merchant with tiny amounts and
  high retry counts (feature-visible, graph-confirmable).

Legit traffic mirrors ``synth.py``'s: stable per-buyer entity sets,
popularity-skewed merchant choice, Poisson purchase times, and the same
weakly-predictive raw feature recipes (``RAW_FEATURES``, 12 dims).

Generator knobs and the attack catalog are documented in
``docs/graphs.md``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.hetero import ENTITY_TYPE_NAMES, tag_entity
from repro_torch.data.synth import NUM_RAW_FEATURES, _fraud_features, _legit_features
from repro_torch.stream.events import CheckoutEvent

#: per-order pattern labels the generator emits ("legit" + these)
ATTACK_NAMES = ("ring", "burst", "bin_test")

_BUYER = ENTITY_TYPE_NAMES.index("buyer")
_MERCHANT = ENTITY_TYPE_NAMES.index("merchant")
_DEVICE = ENTITY_TYPE_NAMES.index("device")
_PAYMENT = ENTITY_TYPE_NAMES.index("payment")


@dataclass
class AttackConfig:
    """Knobs for :func:`generate_attack_stream` (see docs/graphs.md)."""

    num_buyers: int = 300           # legit buyer accounts
    num_merchants: int = 40         # merchant catalog (zipf-ish popularity)
    orders_per_buyer: float = 3.0   # Poisson mean over the whole window
    num_snapshots: int = 30         # one snapshot = one day
    # ring attack
    num_rings: int = 6
    ring_size: int = 8              # fake buyer accounts per ring
    ring_pool: int = 4              # shared devices / payment tokens per ring
    ring_burst_len: int = 4         # snapshots a ring stays active
    orders_per_ring_account: float = 2.5
    # merchant-compromise burst
    num_bursts: int = 3
    burst_orders: int = 30          # stolen-token orders per burst
    burst_window: int = 2           # snapshots the burst spans
    # BIN testing
    num_bin_runs: int = 3
    bin_cards: int = 25             # payment tokens cycled per run
    feature_noise: float = 1.0      # raw-feature class overlap (higher=harder)
    seed: int = 0


def generate_attack_stream(cfg: AttackConfig, rate_per_s: float = 200.0):
    """Generate the heterogeneous named-attack checkout stream.

    Returns ``(events, patterns)``: ``events`` is a list of
    :class:`~repro_torch.stream.events.CheckoutEvent` in event-time order whose
    ``entities`` are type-tagged ``(buyer, merchant, device, payment)``
    ids; ``patterns`` is a same-length array of per-order pattern names
    (``"legit"`` or one of :data:`ATTACK_NAMES`) — evaluation-side truth
    only, never an input.
    """
    rng = np.random.default_rng(cfg.seed)
    counters = [0, 0, 0, 0]

    def new(code: int) -> int:
        counters[code] += 1
        return tag_entity(counters[code] - 1, code)

    merchants = [new(_MERCHANT) for _ in range(cfg.num_merchants)]
    # zipf-ish merchant popularity for legit traffic
    pop = 1.0 / np.arange(1, cfg.num_merchants + 1)
    pop /= pop.sum()

    # (snapshot, entities-tuple, fraud, pattern)
    orders: list[tuple[int, tuple, int, str]] = []

    def emit(t: int, buyer, merchant, device, payment, fraud, pattern):
        orders.append((int(t), (buyer, merchant, device, payment),
                       int(fraud), pattern))

    # --- legit buyers ------------------------------------------------------
    for _ in range(cfg.num_buyers):
        buyer, device, payment = new(_BUYER), new(_DEVICE), new(_PAYMENT)
        n = rng.poisson(cfg.orders_per_buyer)
        for t in np.sort(rng.integers(0, cfg.num_snapshots, n)):
            m = merchants[rng.choice(cfg.num_merchants, p=pop)]
            emit(t, buyer, m, device, payment, 0, "legit")

    # --- fraud rings -------------------------------------------------------
    span = max(cfg.num_snapshots - cfg.ring_burst_len, 1)
    for r in range(cfg.num_rings):
        devices = [new(_DEVICE) for _ in range(cfg.ring_pool)]
        payments = [new(_PAYMENT) for _ in range(cfg.ring_pool)]
        start = int(np.clip(
            round(r * span / max(cfg.num_rings - 1, 1)) + rng.integers(-2, 3),
            0, span))
        for _ in range(cfg.ring_size):
            buyer = new(_BUYER)     # fresh fake account per member
            n = rng.poisson(cfg.orders_per_ring_account)
            ts = start + rng.integers(0, cfg.ring_burst_len, n)
            for t in np.sort(ts):
                t = min(int(t), cfg.num_snapshots - 1)
                m = merchants[rng.integers(cfg.num_merchants)]
                emit(t, buyer, m,
                     devices[rng.integers(cfg.ring_pool)],
                     payments[rng.integers(cfg.ring_pool)], 1, "ring")

    # --- merchant-compromise bursts ---------------------------------------
    for _ in range(cfg.num_bursts):
        m = merchants[rng.integers(cfg.num_merchants)]
        start = int(rng.integers(0, max(cfg.num_snapshots - cfg.burst_window, 1)))
        for _ in range(cfg.burst_orders):
            t = start + int(rng.integers(0, cfg.burst_window))
            # one-off stolen identity per order, merchant is the shared hub
            emit(t, new(_BUYER), m, new(_DEVICE), new(_PAYMENT), 1, "burst")

    # --- BIN testing runs --------------------------------------------------
    for _ in range(cfg.num_bin_runs):
        buyer, device = new(_BUYER), new(_DEVICE)
        m = merchants[rng.integers(cfg.num_merchants)]
        start = int(rng.integers(0, cfg.num_snapshots))
        for _ in range(cfg.bin_cards):
            # card testers move fast: the whole run fits in <= 2 snapshots
            t = min(start + int(rng.integers(0, 2)), cfg.num_snapshots - 1)
            emit(t, buyer, m, device, new(_PAYMENT), 1, "bin_test")

    # --- features ----------------------------------------------------------
    labels = np.asarray([o[2] for o in orders], np.float32)
    patterns = np.asarray([o[3] for o in orders])
    n_ord = len(orders)
    feats = np.zeros((n_ord, NUM_RAW_FEATURES), np.float64)
    past_cb = np.zeros(n_ord)
    legit = labels == 0
    if legit.any():
        feats[legit] = _legit_features(rng, int(legit.sum()), None,
                                       past_cb[legit])
    if (~legit).any():
        feats[~legit] = _fraud_features(rng, int((~legit).sum()), None,
                                        past_cb[~legit], cfg.feature_noise)
    # pattern-specific marginals: BIN tests are tiny-amount / high-retry,
    # bursts skew to large amounts (cash-out before the token dies)
    bin_rows = patterns == "bin_test"
    feats[bin_rows, 0] = rng.normal(0.6, 0.3, int(bin_rows.sum()))
    feats[bin_rows, 8] += rng.poisson(2.0, int(bin_rows.sum()))
    burst_rows = patterns == "burst"
    feats[burst_rows, 0] += rng.normal(0.5, 0.2, int(burst_rows.sum()))

    # z-score with legit-population statistics (a production feature service
    # normalizes against the background distribution)
    mu = feats[legit].mean(0) if legit.any() else feats.mean(0)
    sd = feats[legit].std(0) if legit.any() else feats.std(0)
    feats = ((feats - mu) / np.maximum(sd, 1e-6)).astype(np.float32)

    # --- event-time order + Poisson arrivals -------------------------------
    idx = np.argsort([o[0] for o in orders], kind="stable")
    gaps = rng.exponential(1.0 / rate_per_s, n_ord)
    arrivals = np.cumsum(gaps)
    events = []
    for pos, o in enumerate(idx):
        t, ents, label, _ = orders[o]
        events.append(CheckoutEvent(
            order_id=int(o), snapshot=t, entities=ents,
            features=feats[o], label=float(label),
            arrival=float(arrivals[pos]),
        ))
    return events, patterns[idx]


__all__ = ["ATTACK_NAMES", "AttackConfig", "generate_attack_stream"]
