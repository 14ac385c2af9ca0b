"""Synthetic e-commerce transaction generator with fraud rings.

The production dataset in the paper is proprietary (months of e-commerce
checkouts with chargeback labels).  This generator reproduces the structure
the paper exploits, so that its qualitative claims are testable:

* bipartite order↔entity graph over 7 entity types (shipping address, email,
  IP, device id, contact phone, payment token, account) — paper §3.2;
* **legitimate users**: stable personal entity sets, occasional shared IPs,
  Poisson purchase times spread over all snapshots;
* **fraud rings**: a small pool of shared entities (stolen payment tokens,
  common devices/IPs) reused by many fake accounts, bursty activity within a
  short snapshot window — the "gang of ~1000" business intuition;
* **raw tabular features** that are *weakly* predictive on their own (heavy
  class overlap) plus a delayed past-chargeback-count velocity feature —
  the graph linkage is where most of the signal lives, which is exactly the
  regime where LNN should beat LGB/MLP (paper Table 3).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.dds import StaticGraph

ENTITY_TYPES = ("ship_addr", "email", "ip", "device", "phone", "pay_token", "account")
NUM_ENTITY_TYPES = len(ENTITY_TYPES)
RAW_FEATURES = (
    "amount_log", "item_count", "hour_sin", "hour_cos", "account_age",
    "addr_match", "past_chargebacks", "session_len", "num_payment_retries",
    "basket_entropy", "is_guest", "shipping_speed",
)
NUM_RAW_FEATURES = len(RAW_FEATURES)


@dataclass
class SynthConfig:
    num_users: int = 400
    num_rings: int = 8
    ring_size: int = 8              # fraudster accounts per ring
    orders_per_user: float = 3.0    # Poisson mean over the whole window
    orders_per_fraudster: float = 2.5
    num_snapshots: int = 30         # paper: one snapshot = one day
    ring_burst_len: int = 4         # snapshots a ring stays active
    ring_entity_pool: int = 6       # shared entities per type inside a ring
    lone_fraudster_frac: float = 0.012  # background stolen-card fraud, per-order rate
    shared_ip_frac: float = 0.08    # legit users occasionally share IPs
    chargeback_delay: int = 3       # snapshots before a fraud label is visible
    feature_noise: float = 1.0      # raw-feature class overlap (higher=harder)
    seed: int = 0


def _legit_features(rng, n, t, past_cb):
    hour = rng.uniform(0, 24, n)
    return np.stack(
        [
            rng.normal(3.2, 0.9, n),                       # amount_log
            rng.poisson(2.0, n).astype(np.float64),        # item_count
            np.sin(2 * np.pi * hour / 24),
            np.cos(2 * np.pi * hour / 24),
            rng.gamma(4.0, 90.0, n),                       # account_age (days)
            (rng.uniform(size=n) < 0.9).astype(np.float64),  # addr_match
            past_cb,
            rng.gamma(2.0, 120.0, n),                      # session_len
            rng.poisson(0.1, n).astype(np.float64),
            rng.uniform(0.2, 1.0, n),                      # basket_entropy
            (rng.uniform(size=n) < 0.15).astype(np.float64),
            rng.integers(1, 4, n).astype(np.float64),
        ],
        axis=1,
    )


def _fraud_features(rng, n, t, past_cb, noise):
    """Deliberately heavy class overlap: each marginal shift is small (scaled
    down by ``noise``), so tabular models reach paper-level but not perfect
    scores; most of the remaining signal lives in the *graph linkage*."""
    s = 1.0 / max(noise, 1e-6)
    hour = (rng.uniform(0, 24, n) + rng.normal(2.0 * s, 5.0, n)) % 24
    return np.stack(
        [
            rng.normal(3.2 + 0.18 * s, 0.9, n),
            rng.poisson(2.0 + 0.25 * s, n).astype(np.float64),
            np.sin(2 * np.pi * hour / 24),
            np.cos(2 * np.pi * hour / 24),
            rng.gamma(4.0 - 1.2 * s, 90.0 - 20.0 * s, n),  # slightly younger
            (rng.uniform(size=n) < 0.9 - 0.12 * s).astype(np.float64),
            past_cb,
            rng.gamma(2.0 - 0.3 * s, 120.0 - 15.0 * s, n),
            rng.poisson(0.1 + 0.15 * s, n).astype(np.float64),
            rng.uniform(0.2 - 0.1 * s, 1.0 - 0.05 * s, n),
            (rng.uniform(size=n) < 0.15 + 0.1 * s).astype(np.float64),
            rng.integers(1, 4, n).astype(np.float64) + (rng.uniform(size=n) < 0.3 * s),
        ],
        axis=1,
    )


def generate_transactions(cfg: SynthConfig) -> tuple[StaticGraph, np.ndarray]:
    """Returns (static_graph, entity_type[num_entities])."""
    rng = np.random.default_rng(cfg.seed)
    next_entity = 0
    entity_type: list[int] = []

    def new_entity(et: int) -> int:
        nonlocal next_entity
        entity_type.append(et)
        nid = next_entity
        next_entity += 1
        return nid

    # shared legit IP pool (cafes, offices, NAT)
    shared_ips = [new_entity(ENTITY_TYPES.index("ip")) for _ in range(max(2, cfg.num_users // 25))]

    # --- legit users -------------------------------------------------------
    user_entities = []
    for _ in range(cfg.num_users):
        ents = {et: new_entity(i) for i, et in enumerate(ENTITY_TYPES)}
        if rng.uniform() < cfg.shared_ip_frac:
            ents["ip"] = shared_ips[rng.integers(len(shared_ips))]
        user_entities.append(ents)

    # --- fraud rings --------------------------------------------------------
    rings = []
    for _ in range(cfg.num_rings):
        pool = {
            et: [new_entity(i) for _ in range(cfg.ring_entity_pool)]
            for i, et in enumerate(ENTITY_TYPES)
            if et in ("ip", "device", "pay_token", "ship_addr")
        }
        accounts = []
        for _ in range(cfg.ring_size):
            # each fake account has its own email/phone/account id but draws
            # ip/device/pay_token/ship_addr from the shared ring pool
            ents = {}
            for i, et in enumerate(ENTITY_TYPES):
                if et in pool:
                    ents[et] = pool[et][rng.integers(len(pool[et]))]
                else:
                    ents[et] = new_entity(i)
            accounts.append(ents)
        rings.append(accounts)

    # stratify ring activity windows over the whole timeline (with jitter) so
    # every evaluation split sees some ring activity — fraud never "stops" in
    # production either
    ring_starts = []
    span = max(cfg.num_snapshots - cfg.ring_burst_len, 1)
    for r in range(cfg.num_rings):
        base = int(round(r * span / max(cfg.num_rings - 1, 1)))
        jitter = int(rng.integers(-2, 3))
        ring_starts.append(int(np.clip(base + jitter, 0, span)))
    rings = list(zip(rings, ring_starts))

    # --- emit orders --------------------------------------------------------
    rows_edges: list[tuple[int, int]] = []
    order_snapshot: list[int] = []
    order_is_fraud: list[int] = []
    order_owner: list[tuple[str, int]] = []  # ('legit', user) | ('ring', ring)

    def emit(ents: dict, t: int, fraud: int, owner):
        o = len(order_snapshot)
        order_snapshot.append(t)
        order_is_fraud.append(fraud)
        order_owner.append(owner)
        for et_name, eid in ents.items():
            # entities occasionally rotate (new IPs when travelling etc.)
            rows_edges.append((o, eid))
        return o

    for u, ents in enumerate(user_entities):
        n = rng.poisson(cfg.orders_per_user)
        for t in np.sort(rng.integers(0, cfg.num_snapshots, n)):
            e = dict(ents)
            if rng.uniform() < 0.1:  # mobile IP churn
                e["ip"] = shared_ips[rng.integers(len(shared_ips))]
            emit(e, int(t), 0, ("legit", u))

    for r, (accounts, start) in enumerate(rings):
        for a, ents in enumerate(accounts):
            n = rng.poisson(cfg.orders_per_fraudster)
            ts = start + rng.integers(0, cfg.ring_burst_len, n)
            for t in np.sort(ts):
                t = int(min(t, cfg.num_snapshots - 1))
                emit(dict(ents), t, 1, ("ring", r))

    # background lone fraudsters: fresh entities every time, spread uniformly
    # over *all* snapshots — opportunistic stolen-card fraud with no ring
    # structure (keeps every time split populated with positives and bounds
    # how much the graph alone can achieve)
    n_lone = rng.poisson(cfg.lone_fraudster_frac * cfg.num_users * cfg.orders_per_user)
    for t in rng.integers(0, cfg.num_snapshots, max(n_lone, cfg.num_snapshots // 10)):
        ents = {et: new_entity(i) for i, et in enumerate(ENTITY_TYPES)}
        emit(ents, int(t), 1, ("lone", -1))

    n_ord = len(order_snapshot)
    order_snapshot = np.asarray(order_snapshot, np.int64)
    labels = np.asarray(order_is_fraud, np.float32)

    # --- features (past_chargebacks needs account history with delay) -------
    # account id per order = the 'account' entity
    edges = np.asarray(rows_edges, np.int64)
    account_of = np.full(n_ord, -1, np.int64)
    acct_idx = ENTITY_TYPES.index("account")
    for o, eid in rows_edges:
        if entity_type[eid] == acct_idx:
            account_of[o] = eid
    features = np.zeros((n_ord, NUM_RAW_FEATURES), np.float64)
    # delayed chargeback counts per account
    order_by_time = np.argsort(order_snapshot, kind="stable")
    cb_count: dict[int, list[tuple[int, int]]] = {}
    past_cb = np.zeros(n_ord)
    for o in order_by_time:
        acct = account_of[o]
        t = order_snapshot[o]
        hist = cb_count.get(acct, [])
        past_cb[o] = sum(1 for (tt, y) in hist if y and tt + cfg.chargeback_delay <= t)
        hist.append((t, order_is_fraud[o]))
        cb_count[acct] = hist

    legit_mask = labels == 0
    n_legit = int(legit_mask.sum())
    n_fraud = n_ord - n_legit
    if n_legit:
        features[legit_mask] = _legit_features(rng, n_legit, None, past_cb[legit_mask])
    if n_fraud:
        features[~legit_mask] = _fraud_features(
            rng, n_fraud, None, past_cb[~legit_mask], cfg.feature_noise
        )

    g = StaticGraph(
        num_orders=n_ord,
        num_entities=next_entity,
        edges=edges,
        order_snapshot=order_snapshot,
        order_features=features.astype(np.float32),
        labels=labels,
        entity_type=np.asarray(entity_type, np.int32),
        num_snapshots=cfg.num_snapshots,
    )
    return g, np.asarray(entity_type, np.int32)

