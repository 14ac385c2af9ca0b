"""Drifting named-attack workload — the continuous-learning stressor
(the reference's ``repro.learn.drift``, copied over the port's attack
generator: the same events, patterns and split from the same seeds).

``benchmarks/learning_bench.py`` needs a stream whose fraud *changes
shape mid-stream*: a model trained on the first phase must measurably
lose ring recall on the second, and a fine-tune on tapped second-phase
data must recover it.  :func:`drifting_attack_stream` builds that from
two :func:`~repro_torch.data.attacks.generate_attack_stream` phases:

* **Phase A** is the base workload unchanged.
* **Phase B** re-generates with a different seed and a *shifted ring
  signature*: ring orders drop the generic fraud-feature recipe phase A's
  model keyed on and instead carry a fresh, localized signature (an
  offset on two previously-uninformative feature dims), while the ring
  *linkage* gets weaker (wider device/payment pool).  Every phase-B
  entity id is re-tagged into a disjoint id range, so phase-B rings share
  no devices or payment tokens with phase A — the old model's graph
  evidence does not transfer.

Phase B's snapshots and arrivals continue phase A's clock, so the
combined list replays as ONE event-time-ordered stream through the
serving path.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.hetero import strip_type, tag_entity, type_code_of
from repro_torch.data.attacks import AttackConfig, generate_attack_stream
from repro_torch.stream.events import CheckoutEvent

__all__ = ["drifting_attack_stream"]

#: phase-B ring signature: z-score offset added on these raw-feature dims
_DRIFT_DIMS = (4, 5)
_DRIFT_SHIFT = 2.5
#: phase-B order ids live above this floor — disjoint from any phase A id
_ORDER_OFFSET = 1_000_000


def drifting_attack_stream(cfg: AttackConfig, *, drift_seed: int | None = None,
                           rate_per_s: float = 200.0):
    """Two-phase drifting stream.

    Returns ``(events, patterns, split)``: one event-time-ordered list
    covering both phases, the per-event pattern names, and ``split`` — the
    index of the first phase-B event.  Deterministic in ``cfg.seed`` /
    ``drift_seed`` (default ``cfg.seed + 1``).
    """
    ev_a, pat_a = generate_attack_stream(cfg, rate_per_s=rate_per_s)

    b_cfg = dataclasses.replace(
        cfg,
        seed=cfg.seed + 1 if drift_seed is None else int(drift_seed),
        ring_pool=max(2 * cfg.ring_pool, cfg.ring_pool + 2),
    )
    ev_b, pat_b = generate_attack_stream(b_cfg, rate_per_s=rate_per_s)

    # disjoint id space: strip the type tag, offset past phase A's raw ids,
    # re-tag — phase-B entities share nothing with phase A
    offset = 1 + max(
        (strip_type(e) for ev in ev_a for e in ev.entities), default=0)
    rng = np.random.default_rng(b_cfg.seed + 7)
    t_shift = cfg.num_snapshots
    t_last = ev_a[-1].arrival if ev_a else 0.0
    shifted = []
    for ev, pat in zip(ev_b, pat_b):
        ents = tuple(
            tag_entity(strip_type(e) + offset, type_code_of(e))
            for e in ev.entities)
        feats = np.array(ev.features, np.float32)
        if pat == "ring":
            # the drift: legit-like body + a NEW signature on dims the
            # phase-A model never learned to read
            feats[:] = rng.normal(0.0, 1.0, len(feats))
            for d in _DRIFT_DIMS:
                feats[d] += _DRIFT_SHIFT
        shifted.append(CheckoutEvent(
            order_id=int(ev.order_id) + _ORDER_OFFSET,
            snapshot=int(ev.snapshot) + t_shift,
            entities=ents, features=feats, label=ev.label,
            arrival=float(ev.arrival) + t_last))
    events = list(ev_a) + shifted
    patterns = np.concatenate([pat_a, pat_b])
    return events, patterns, len(ev_a)
