"""Document -> shard routing.

Counterpart of `elasticsearch_tpu/cluster/routing.py`, trimmed to the
reference's default hash (ref: cluster/routing/OperationRouting.java:
259-282): shard = DjbHash(routing ?: id) % number_of_shards, so a
document lands on the same shard in both packages.
"""

from __future__ import annotations


def djb_hash(value: str) -> int:
    """DJB2 string hash (public Bernstein algorithm) over UTF-16 code
    units, like Java's char iteration."""
    h = 5381
    for ch in value:
        # Java hashes char-by-char; surrogate pairs hash as two units
        for unit in ([ord(ch)] if ord(ch) < 0x10000 else [
                0xD800 + ((ord(ch) - 0x10000) >> 10),
                0xDC00 + ((ord(ch) - 0x10000) & 0x3FF)]):
            h = ((h << 5) + h + unit) & 0xFFFFFFFF
    return h


def shard_id(doc_id: str, num_shards: int, routing: str | None = None) -> int:
    """hash(routing ?: id) % shards, DjbHash as in the reference's 2.0
    default."""
    key = routing if routing is not None else doc_id
    h = djb_hash(key)
    if h >= 1 << 31:            # Java int is signed; MathUtils.mod
        h -= 1 << 32            # folds negatives back to [0, n)
    return ((h % num_shards) + num_shards) % num_shards
