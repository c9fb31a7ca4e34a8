"""Build-aside / keep-serving / atomic-swap.

Counterpart of `elasticsearch_tpu/parallel/repack.py`, trimmed to
`run_build_aside` (host code), the discipline the streaming write path's
compaction (`index/engine.Engine._compact_now`) runs under. The
degraded-mesh repack is not ported.
"""

from __future__ import annotations

from ..utils.errors import CircuitBreakingError


def run_build_aside(name: str, build, swap) -> bool:
    """`build()` runs with no serving lock held: the current generation
    keeps serving every in-flight and new search for the whole build.
    `swap(result)` publishes atomically (it takes its own lock,
    re-validates that the world it snapshotted still stands, and returns
    False to abort when it moved on: the caller's next trigger retries).
    A CircuitBreakingError from `build` means there is no headroom for
    the copy: keep serving the old generation rather than raise (`name`
    says which build in the log). Returns True only when the swap
    published."""
    try:
        result = build()
    except CircuitBreakingError:
        import logging
        logging.getLogger(__name__).warning(
            "%s: no memory for the build-aside copy; the old generation "
            "keeps serving", name)
        return False
    return bool(swap(result))
