"""Key-space sharding (host-side): the hash the KV store and the speed-layer
worker router share, so "the worker that owns an entity's KV shard" is a
well-defined statement.  Only this half of the reference's
``dist/sharding.py`` is ported; its device-mesh half belongs to the model zoo.
"""
from __future__ import annotations

_MASK64 = (1 << 64) - 1


def splitmix64(x: int) -> int:
    """Full splitmix64 avalanche — uniform over arbitrary integer keys."""
    x = (int(x) + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stable_shard(key: int, num_shards: int) -> int:
    """Deterministic shard of ``key`` over ``num_shards`` buckets."""
    return (splitmix64(key) >> 32) % num_shards


def rendezvous_shard(key: int, num_shards: int) -> int:
    """Highest-random-weight (rendezvous) shard of ``key``.

    Unlike modulo placement, growing ``num_shards`` by one moves only
    ~1/(n+1) of the keys — and every moved key lands on the *new* shard,
    never migrating between surviving shards.  O(num_shards) per lookup;
    shard counts here are small.
    """
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    k = int(key)
    best, best_w = 0, -1
    for s in range(num_shards):
        w = splitmix64(k ^ splitmix64(s))
        if w > best_w:
            best, best_w = s, w
    return best
