"""Process-wide durability counters: the audit surface of the crash and
corruption containment path.

Counterpart of `elasticsearch_tpu/index/durability.py`. One counter block
rides ``nodes_stats()["indices"]["durability"]``, so a chaos run can
assert which salvage / containment events fired, and a clean recovery
that none did:

  * ``corruptions_detected``  — CorruptIndexError / TranslogCorrupted
    raised by a store / translog read
  * ``commits_fell_back``     — commit generations skipped by the
    newest-to-oldest salvage walk
  * ``translog_truncated_bytes`` — torn-tail bytes truncated on open
  * ``segments_salvaged``     — segment files no commit referenced,
    dropped (their docs re-enter through translog replay)
  * ``shards_failed_corrupt`` — shards contained
  * ``peer_recoveries_after_corruption`` — kept for the reference's
    layout; peer recovery is cluster code, not ported, so it stays 0

Each Node installs a fresh stats object at init and resets on close only
while the installed object is still its own.
"""

from __future__ import annotations

import contextlib
import threading

_FIELDS = ("corruptions_detected", "commits_fell_back",
           "translog_truncated_bytes", "segments_salvaged",
           "shards_failed_corrupt", "peer_recoveries_after_corruption")


class DurabilityStats:
    """Thread-safe counter block for the durability path."""

    def __init__(self):
        self._mx = threading.Lock()
        self._counts = {f: 0 for f in _FIELDS}

    def inc(self, field: str, n: int = 1) -> None:
        with self._mx:
            self._counts[field] += n

    def snapshot(self) -> dict:
        with self._mx:
            return dict(self._counts)


_process_stats_mx = threading.Lock()
stats = DurabilityStats()


def install_process_stats() -> DurabilityStats:
    """Node-init hook: install a fresh counter object and return it."""
    global stats
    with _process_stats_mx:
        stats = DurabilityStats()
        return stats


def reset_process_stats(if_owner: DurabilityStats | None = None) -> None:
    """Node-close hook: reset only while the installed object is still
    the closing node's."""
    global stats
    with _process_stats_mx:
        if if_owner is None or if_owner is stats:
            stats = DurabilityStats()


def on_corruption_detected(n: int = 1) -> None:
    stats.inc("corruptions_detected", n)


def on_commit_fell_back(n: int = 1) -> None:
    stats.inc("commits_fell_back", n)


def on_translog_truncated(nbytes: int) -> None:
    if nbytes > 0:
        stats.inc("translog_truncated_bytes", nbytes)


def on_segments_salvaged(n: int) -> None:
    if n > 0:
        stats.inc("segments_salvaged", n)


def on_shard_failed_corrupt() -> None:
    stats.inc("shards_failed_corrupt")


def snapshot() -> dict:
    return stats.snapshot()


# -- the writes of one bulk request, acked together ------------------------
_scope = threading.local()


@contextlib.contextmanager
def acked_together():
    """The scope of one bulk request, whose ops are acked together when
    it returns (`Node.bulk` enters it): `async` translogs and the
    per-doc metadata log hand their page-cache write to
    `write_before_ack`, run once at the scope's end, instead of writing
    per op. `request` mode still fsyncs every op."""
    if getattr(_scope, "pending", None) is not None:
        yield
        return
    _scope.pending = pending = ({}, {})
    try:
        yield
    finally:
        _scope.pending = None
        for group in pending:
            for flush in group.values():
                flush()


def write_before_ack(owner, flush, first: bool = False) -> None:
    """Run `flush` now, or at the end of the enclosing `acked_together`
    scope, once per owner: the `first` ones (the docs' metadata) before
    the rest (the translogs), so that a crash between the two never
    leaves a replayable op without its metadata."""
    pending = getattr(_scope, "pending", None)
    if pending is None:
        flush()
    else:
        pending[0 if first else 1].setdefault(id(owner), flush)
