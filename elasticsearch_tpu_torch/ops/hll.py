"""HyperLogLog++ cardinality: reducible sketch registers.

Counterpart of `elasticsearch_tpu/ops/hll.py` (ref: search/aggregations/
metrics/cardinality/HyperLogLogPlusPlus.java): the cardinality agg
switches from exact counting to an HLL++ sketch past
`precision_threshold`.

Register updates are a scatter-MAX of per-value ranks into a [B, 2^p]
register file, the bucket-scatter shape of every other agg, so the sketch
reduces across segments and shards with an elementwise max. On the
device the scatter is the bucket stats' max fold (`search/executor`,
`ops/aggs.bucket_stats`). With p=12 (4096 registers) the standard error
is 1.04/sqrt(4096) ~ 1.6%.

Hashes are computed host-side per dictionary TERM (not per doc): the
columnar layout stores ordinals, so each distinct value hashes once and
docs gather their ordinal's (register, rank) pair. The hash (blake2b)
and the estimate are the reference's, so registers and estimates agree
bit for bit.
"""

from __future__ import annotations

import hashlib

import numpy as np

P = 12                     # register address bits
M = 1 << P                 # 4096 registers
_ALPHA = 0.7213 / (1.0 + 1.079 / M)  # alpha_m for m >= 128


def _hash64(term: str) -> int:
    """Stable 64-bit term hash (blake2b — stable across processes,
    unlike Python's salted hash())."""
    return int.from_bytes(
        hashlib.blake2b(term.encode("utf-8", "surrogatepass"),
                        digest_size=8).digest(), "little")


_REGISTER_MEMO: dict[int, tuple] = {}   # id(terms) -> (terms, reg, rank)
_MEMO_CAP = 32


def term_registers(terms: list[str],
                   memo: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Per-term (register index, rank) pairs; empty-safe.

    rank = 1 + number of leading zeros of the remaining 64-p hash bits
    (capped so int8-sized values suffice). Results memoize on the term
    LIST object (global-ordinal term lists are cached per reader and
    reused across queries — hashing a million terms per request would
    dominate the agg); the memo holds a strong reference to the list so
    id() cannot be reused while an entry lives. Callers hashing a
    TRANSIENT list (e.g. shard-merge bucket keys) must pass memo=False
    so one-shot entries don't evict the long-lived per-reader ones.
    """
    hit = _REGISTER_MEMO.get(id(terms)) if memo else None
    if hit is not None and hit[0] is terms:
        return hit[1], hit[2]
    n = len(terms)
    reg = np.zeros(max(n, 1), dtype=np.int32)
    rank = np.zeros(max(n, 1), dtype=np.int32)
    for i, t in enumerate(terms):
        h = _hash64(t)
        reg[i] = h & (M - 1)
        rest = h >> P
        # leading zeros within the (64 - P)-bit remainder
        width = 64 - P
        rank[i] = (width - rest.bit_length()) + 1 if rest else width + 1
    if memo:
        if len(_REGISTER_MEMO) >= _MEMO_CAP:
            _REGISTER_MEMO.pop(next(iter(_REGISTER_MEMO)))
        _REGISTER_MEMO[id(terms)] = (terms, reg, rank)
    return reg, rank


def estimate(registers: np.ndarray) -> float:
    """HLL estimate with the small-range linear-counting correction
    (ref: HyperLogLogPlusPlus.cardinality). registers: [M] max ranks
    (0 = empty register)."""
    regs = np.asarray(registers, dtype=np.float64)
    raw = _ALPHA * M * M / np.sum(np.power(2.0, -regs))
    zeros = int(np.count_nonzero(regs == 0))
    if raw <= 2.5 * M and zeros > 0:
        return M * np.log(M / zeros)          # linear counting
    return raw
