"""Typed entity keys — the heterogeneous-graph id scheme.

The DDS graph (``core/dds.py``) and every layer above it identify an
entity by a single int64.  Heterogeneous graphs (buyer / merchant /
device / payment nodes, BRIGHT-style) need the *type* to travel with the
id — through the KV store, the WAL, checkpoints, and the shard router —
without changing any wire format.  The scheme is a high-bit tag:

::

    tagged = (type_code + 1) << 40  |  raw_id        (raw_id < 2**40)

* the ``+1`` keeps the all-zero high bits meaning "untagged", so a legacy
  (homogeneous) id is *detectably* untyped — ``KVStore`` configured
  heterogeneous rejects it loudly instead of silently sharding buyer and
  device ids into one keyspace;
* the tagged id still fits ``pack_key``'s 43-bit entity field
  (``MAX_ENTITY = 2**43 - 1``), so packed KV keys, WAL event records
  (plain JSON ints), and checkpoint arrays (int64) all round-trip tagged
  ids bit-exactly with no format change;
* a tagged id is an ordinary int everywhere else — union-find
  communities, rendezvous sharding, and the incremental DDS builder are
  id-agnostic.

``ENTITY_TYPE_NAMES`` is the canonical vocabulary used by
:class:`~repro_torch.core.lnn.LNNConfig` per-type towers and the attack
workload (``repro/data/attacks.py``); the scheme itself supports up to 7
type codes.  See ``docs/graphs.md`` for the schema.
"""
from __future__ import annotations

import numpy as np

#: canonical heterogeneous vocabulary (index = type code)
ENTITY_TYPE_NAMES = ("buyer", "merchant", "device", "payment")

#: bit position of the type tag inside an entity id
TYPE_SHIFT = 40

#: mask of the raw (untyped) id bits
RAW_ID_MASK = (1 << TYPE_SHIFT) - 1

#: largest type code the tag field can carry (tag 0 means "untagged")
MAX_TYPE_CODE = 6


def tag_entity(raw_id: int, type_code: int) -> int:
    """Tag ``raw_id`` with ``type_code`` (index into the type vocabulary).

    Raises ``ValueError`` when the raw id or code is out of range — a
    tagged id must still fit the KV store's 43-bit entity field.
    """
    raw_id, type_code = int(raw_id), int(type_code)
    if not 0 <= raw_id <= RAW_ID_MASK:
        raise ValueError(f"raw entity id {raw_id} out of [0, 2**{TYPE_SHIFT})")
    if not 0 <= type_code <= MAX_TYPE_CODE:
        raise ValueError(f"entity type code {type_code} out of "
                         f"[0, {MAX_TYPE_CODE}]")
    return ((type_code + 1) << TYPE_SHIFT) | raw_id


def is_typed(entity_id: int) -> bool:
    """True when ``entity_id`` carries a type tag (high bits nonzero)."""
    return (int(entity_id) >> TYPE_SHIFT) != 0


def type_code_of(entity_id: int) -> int:
    """Type code of a tagged id; ``-1`` for an untagged (legacy) id."""
    return (int(entity_id) >> TYPE_SHIFT) - 1


def entity_type_of(entity_id: int) -> str | None:
    """Type *name* of a tagged id (``None`` untagged; raises on a code
    outside :data:`ENTITY_TYPE_NAMES` — an id from a different vocabulary)."""
    code = type_code_of(entity_id)
    if code < 0:
        return None
    if code >= len(ENTITY_TYPE_NAMES):
        raise ValueError(
            f"entity id {entity_id} carries type code {code}, outside the "
            f"canonical vocabulary {ENTITY_TYPE_NAMES}")
    return ENTITY_TYPE_NAMES[code]


def strip_type(entity_id: int) -> int:
    """The raw id with the type tag removed."""
    return int(entity_id) & RAW_ID_MASK


def type_codes_array(entity_ids: np.ndarray) -> np.ndarray:
    """Vectorized :func:`type_code_of`: int32 codes, ``-1`` per untagged id."""
    e = np.asarray(entity_ids, np.int64)
    return ((e >> TYPE_SHIFT) - 1).astype(np.int32)


__all__ = [
    "ENTITY_TYPE_NAMES", "TYPE_SHIFT", "RAW_ID_MASK", "MAX_TYPE_CODE",
    "tag_entity", "is_typed", "type_code_of", "entity_type_of",
    "strip_type", "type_codes_array",
]
