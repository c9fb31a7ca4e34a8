"""Search dispatch scheduler: cross-request coalescing + pipelining.

Counterpart of `elasticsearch_tpu/search/dispatch.py` (host code), one
layer above the per-reader signature batching the executor does:

* **coalescing**: concurrent searches on the same reader (and with the
  same partials flag and deadline bucket) go to the reader as ONE
  msearch, whose signature grouping batches identical plans into one
  device evaluation (leading dim B), and the batched results scatter
  back into per-request responses;
* **pipelining**: requests that cannot coalesce (other readers / shards)
  are enqueued back-to-back through the reader's non-syncing
  `msearch_submit`, then collected in submission order, so the card
  works on one while the host prepares the next.

Callers build a `DispatchBatch`, submit (reader, body) jobs, and call
`dispatch()`. Batches arriving while another batch executes queue up
and are drained by the next leader. Every batch carries a priority lane
(`interactive` / `msearch` / `scroll` / `bulk`); each drain round takes
all pending interactive batches plus at most a per-lane quota of the
others (search/traffic.py). `ES_TPU_COALESCE_WINDOW_MS` (or the
`search.dispatch.coalesce_window_ms` setting) > 0 holds the leader that
long before draining; otherwise the traffic controller's adaptive window
decides.

Stats surface under `nodes_stats()["dispatch"]`. The reference's mesh
failover / eviction / membership counters are not ported (the port has
no mesh).
"""

from __future__ import annotations

import os
import threading
import time

from ..utils.errors import SearchTimeoutError
from ..utils.metrics import CounterMetric, HighWaterMetric

# thread-local mirror of the last msearch's (group_sizes, dispatch_count)
# on the current thread: how the scheduler's sync path (the plain
# reader.msearch) reads coalescing stats without a shared mutable
# attribute on the reader. Writer: ShardReader.msearch, at the end of
# each call.
submit_stats = threading.local()


def note_submit_stats(group_sizes, dispatches: int) -> None:
    submit_stats.value = (list(group_sizes), dispatches)


class DispatchStats:
    """Scheduler counters (thread-safe; plumbed into nodes_stats).

    Granularity: `queries` and `coalesced_queries` count PER-SHARD query
    executions (one search against an S-shard index is S entries) —
    the unit the scheduler actually batches and dispatches."""

    def __init__(self):
        self.queries = CounterMetric()
        self.coalesced_queries = CounterMetric()
        self.batches_dispatched = CounterMetric()
        self.pipeline_depth = HighWaterMetric()
        self._window_batches = CounterMetric()
        self._window_coalesced = CounterMetric()
        self._adopted_batches = CounterMetric()
        # traffic control plane (search/traffic.py) — set by the
        # scheduler when a node wires one in; snapshot() then reports
        # per-tenant admission counters, lane depths, the adaptive
        # window, and the query-cache hit rate under "traffic"
        self.traffic = None

    def record_round(self, n_batches: int, windowed: bool) -> None:
        """A drain round merged n_batches callers. `windowed` rounds
        credit the timed window (ES_TPU_COALESCE_WINDOW_MS held the
        leader open); merges in un-windowed rounds are in-flight
        ADOPTION (a batch arrived while a dispatch executed) and are
        counted separately so the window knob's hit rate reflects only
        what the window bought."""
        if windowed:
            self._window_batches.inc(n_batches)
            if n_batches > 1:
                self._window_coalesced.inc(n_batches - 1)
        elif n_batches > 1:
            self._adopted_batches.inc(n_batches - 1)

    def record_groups(self, group_sizes, dispatches: int) -> None:
        self.batches_dispatched.inc(dispatches)
        for sz in group_sizes:
            if sz > 1:
                self.coalesced_queries.inc(sz)

    def snapshot(self) -> dict:
        from .resident import resident_stats
        wb = self._window_batches.count
        wc = self._window_coalesced.count
        snap = {
            "queries": self.queries.count,
            "coalesced_queries": self.coalesced_queries.count,
            "batches_dispatched": self.batches_dispatched.count,
            "pipeline_depth": self.pipeline_depth.max,
            "adopted_batches": self._adopted_batches.count,
            "window": {"batches": wb, "coalesced": wc,
                       "hit_rate": (wc / wb if wb else 0.0)},
            # resident query loop (search/resident.py): pinned-entry
            # hits, evictions, preemptions, residency bytes; all zero
            # with ES_TPU_RESIDENT_LOOP unset
            "resident": resident_stats(),
        }
        if self.traffic is not None:
            snap["traffic"] = self.traffic.snapshot()
        return snap


class _Job:
    """One shard-level search riding a DispatchBatch. `deadline` is an
    absolute time.monotonic() cutoff (None = no deadline): the reader's
    collect phase raises SearchTimeoutError past it, and the caller
    (node._finish_on_readers) converts that into a failed-by-timeout
    shard on a `timed_out: true` response."""

    __slots__ = ("reader", "body", "with_partials", "deadline", "_result",
                 "_error", "_done")

    def __init__(self, reader, body: dict, with_partials: bool,
                 deadline: float | None = None):
        self.reader = reader
        self.body = body
        self.with_partials = with_partials
        self.deadline = deadline
        self._result = None
        self._error = None
        self._done = False

    def result(self) -> dict:
        if not self._done:
            raise RuntimeError(
                "dispatch job collected before batch.dispatch()")
        if self._error is not None:
            raise self._error
        return self._result


class DispatchBatch:
    """One caller's set of shard-level jobs, dispatched as a unit (and
    possibly merged with concurrently-arriving batches). `lane` is the
    priority lane the scheduler drains it from (traffic control plane;
    defaults to interactive — the protected class)."""

    def __init__(self, scheduler: "DispatchScheduler",
                 lane: str = "interactive"):
        self._scheduler = scheduler
        self.lane = lane
        self.jobs: list[_Job] = []
        self._done = threading.Event()

    def submit(self, reader, body: dict, with_partials: bool = False,
               deadline: float | None = None) -> _Job:
        job = _Job(reader, body, with_partials, deadline)
        self.jobs.append(job)
        return job

    def dispatch(self) -> None:
        """Execute every submitted job; per-job errors are re-raised by
        job.result(), never by dispatch() itself."""
        if not self.jobs:
            self._done.set()
            return
        self._scheduler.run(self)


class DispatchScheduler:
    """Leader-drain scheduler over DispatchBatches (see module doc)."""

    def __init__(self, window_ms: float = 0.0, traffic=None):
        self._mx = threading.Lock()
        # serialization latch, not a data lock: the leader holds it across
        # the coalescing window and the drain's dispatch / collect
        self._leader = threading.Lock()
        self._pending: list[DispatchBatch] = []
        self._window_default = float(window_ms)
        # traffic control plane (search/traffic.py): lane quotas for the
        # weighted drain, the adaptive coalescing window, and the stats
        # surface. None = legacy single-FIFO behavior (static window
        # only), so scheduler unit tests need no controller.
        self._traffic = traffic
        self.stats = DispatchStats()
        self.stats.traffic = traffic

    def batch(self, lane: str = "interactive") -> DispatchBatch:
        return DispatchBatch(self, lane=lane)

    def window_ms(self) -> float:
        """Effective coalescing window for THIS drain. Precedence: the
        env override (explicit operator knob), then a non-zero static
        setting, then the traffic controller's adaptive window (0 when
        traffic is sequential or the controller is absent)."""
        raw = os.environ.get("ES_TPU_COALESCE_WINDOW_MS")
        if raw not in (None, ""):
            try:
                return float(raw)
            except ValueError:
                pass
        if self._window_default > 0:
            return self._window_default
        if self._traffic is not None:
            return self._traffic.window.window_ms()
        return self._window_default

    # -- core --------------------------------------------------------------
    def run(self, batch: DispatchBatch) -> None:
        with self._mx:
            self._pending.append(batch)
            lane_depth = sum(1 for b in self._pending
                             if b.lane == batch.lane)
        if self._traffic is not None:
            self._traffic.note_lane_depth(batch.lane, lane_depth)
            self._traffic.window.observe_arrival()
        if self._leader.acquire(blocking=False):
            try:
                w = self.window_ms()
                if w > 0:
                    # hold the door for concurrent REST traffic that
                    # would otherwise just miss this drain (static: the
                    # operator asked; adaptive: the controller predicts
                    # another arrival inside the window)
                    time.sleep(w / 1000.0)
                self._drain(windowed=w > 0, until=batch)
            finally:
                self._leader.release()
        # a leader was mid-flight: it adopts this batch in a coming
        # round. Wait on COMPLETION, not on the leader lock — with
        # priority lanes the leader may keep draining a deep bulk
        # backlog long after this batch's round finished, and an
        # interactive caller must return the moment its own round
        # completes. The timed re-check only closes the rare
        # enqueue/last-take race (a leader exited without seeing this
        # batch): the first retry comes fast, then the poll backs off
        # so a deep backlog of waiting callers is not a wakeup storm.
        poll_s = 0.001
        while not batch._done.wait(timeout=poll_s):
            if self._leader.acquire(blocking=False):
                try:
                    self._drain(windowed=False, until=batch)
                finally:
                    self._leader.release()
            poll_s = 0.05

    def _lane_quota(self, lane: str) -> int | None:
        if lane == "interactive":
            return None  # the protected class is never capped
        if self._traffic is not None:
            return self._traffic.lane_quota(lane)
        return None  # no controller: legacy single-FIFO drain

    def _take_round_locked(self) -> list[DispatchBatch]:
        """One drain round: ALL interactive batches plus up to the
        per-lane quota from each other lane, in lane priority order
        (FIFO within a lane — Python's sort is stable). Leftovers stay
        pending for the next round, where freshly-arrived interactive
        batches again outrank them."""
        if not self._pending:
            return []
        from .traffic import lane_priority
        ordered = sorted(self._pending, key=lambda b: lane_priority(b.lane))
        take: list[DispatchBatch] = []
        leftover: list[DispatchBatch] = []
        counts: dict[str, int] = {}
        for b in ordered:
            q = self._lane_quota(b.lane)
            c = counts.get(b.lane, 0)
            if q is not None and c >= q:
                leftover.append(b)
            else:
                counts[b.lane] = c + 1
                take.append(b)
        # leftovers keep within-lane FIFO order (the sort above is
        # stable); new arrivals append after them under the same lock
        self._pending[:] = leftover
        return take

    def _drain(self, windowed: bool = False,
               until: "DispatchBatch | None" = None) -> None:
        """Drain rounds until nothing is pending — or, when `until` is
        given, until that batch's round has completed. The early exit
        keeps a drain leader's OWN latency bounded under a sustained
        over-quota flood (leftover rounds would otherwise pin an
        interactive caller's thread for the flood's duration); every
        leftover batch has its own caller parked in run(), whose timed
        leader re-check picks the backlog up within one poll."""
        first = True
        while True:
            if until is not None and until._done.is_set():
                return
            with self._mx:
                round_ = self._take_round_locked()
            if not round_:
                return
            # only the FIRST round's merges were bought by the timed
            # window; later rounds of the same drain are in-flight
            # adoption like any un-windowed leader's
            self.stats.record_round(len(round_), windowed and first)
            if self._traffic is not None:
                self._traffic.window.observe_round(len(round_))
            first = False
            try:
                self._execute([j for b in round_ for j in b.jobs])
            finally:
                for b in round_:
                    b._done.set()

    # -- execution ---------------------------------------------------------
    @staticmethod
    def _deadline_kw(g: list[_Job]) -> dict:
        """Deadline kwargs for a coalesced group's reader call — empty
        when no deadline, so plain mock readers without the kwarg keep
        working. Grouping buckets deadlines to 10 ms (see _execute), so
        members differ by less than a bucket; the LATEST wins — a
        cooperative timeout may fire a few ms late but must never fail
        a request before its own deadline."""
        if g[0].deadline is None:
            return {}
        return {"deadline": max(j.deadline for j in g)}

    def _fail_or_isolate(self, g: list[_Job], e: Exception) -> None:
        """A group's shared execution failed: retry singly so
        batch-mates survive one bad body — EXCEPT on deadline exits,
        where re-dispatching cannot succeed (the deadline won't
        un-pass) and only burns device time the laggard already
        wasted."""
        if isinstance(e, SearchTimeoutError):
            for j in g:
                j._error = e
                j._done = True
        else:
            self._run_isolated(g)

    def _execute(self, jobs: list[_Job]) -> None:
        self.stats.queries.inc(len(jobs))
        groups: dict[tuple, list[_Job]] = {}
        order: list[tuple] = []
        for j in jobs:
            # deadlines bucket at 10 ms rather than keying raw floats:
            # msearch items sharing one `timeout` compute deadlines
            # microseconds apart, and exact-float keys would put every
            # job in its own group — silently disabling coalescing for
            # any deadline-carrying traffic. Different timeout ORDERS
            # (100ms vs 10s) still split, as they must.
            dkey = (None if j.deadline is None
                    else int(j.deadline * 100))
            key = (id(j.reader), j.with_partials, dkey)
            g = groups.get(key)
            if g is None:
                groups[key] = g = []
                order.append(key)
            g.append(j)
        if len(order) == 1:
            # single target: the plain synchronous reader path (same
            # signature-grouped batching inside, nothing to pipeline)
            self._run_sync(groups[order[0]])
            return
        # pipelined: enqueue EVERY group's device programs back-to-back
        # through the reader's non-syncing submit, then collect in
        # submission order — round trips overlap instead of serializing
        pendings = []
        for key in order:
            g = groups[key]
            if not hasattr(g[0].reader, "msearch_submit"):
                # reader without a split entry (plain mock / legacy):
                # sync per-group, still batched within the reader — and
                # never let a missing interface masquerade as a parse
                # error in the isolated fallback
                self._run_sync(g)
                continue
            try:
                pend = g[0].reader.msearch_submit(
                    [j.body for j in g], g[0].with_partials,
                    **self._deadline_kw(g))
            except Exception:  # noqa: BLE001 — submit-time (parse) error
                self._run_isolated(g)
                continue
            pendings.append((g, pend))
        # depth = device programs enqueued before the first collection —
        # the number of device dispatches enqueued ahead
        self.stats.pipeline_depth.record(
            sum(p.dispatch_count for _g, p in pendings))
        for g, pend in pendings:
            try:
                rs = pend.finish()
            except Exception as e:  # noqa: BLE001 — one bad body fails
                # the shared program (see _fail_or_isolate)
                self._fail_or_isolate(g, e)
                continue
            for j, r in zip(g, rs):
                j._result = r
                j._done = True
            self.stats.record_groups(pend.group_sizes,
                                     pend.dispatch_count)
        for j in jobs:  # backstop: no job may leave undecided
            if not j._done:
                j._error = RuntimeError("dispatch job was not executed")
                j._done = True

    def _run_sync(self, g: list[_Job]) -> None:
        reader = g[0].reader
        submit_stats.value = None
        try:
            rs = reader.msearch([j.body for j in g], g[0].with_partials,
                                **self._deadline_kw(g))
        except Exception as e:  # noqa: BLE001
            self._fail_or_isolate(g, e)
            return
        for j, r in zip(g, rs):
            j._result = r
            j._done = True
        sub = getattr(submit_stats, "value", None)
        if sub is not None:
            # msearch_submit enqueued every group x segment program
            # before its finish collected any — that WAS the in-flight
            # depth, even through the sync wrapper
            self.stats.pipeline_depth.record(sub[1])
            self.stats.record_groups(*sub)
        else:
            self.stats.pipeline_depth.record(1)

    def _run_isolated(self, g: list[_Job]) -> None:
        """Per-job fallback: each body runs alone so only the bad one
        errors (batch-mates must not inherit a stranger's 400)."""
        for j in g:
            if j._done:
                continue
            try:
                kw = {} if j.deadline is None else {"deadline": j.deadline}
                j._result = j.reader.msearch([j.body], j.with_partials,
                                             **kw)[0]
            except Exception as e:  # noqa: BLE001
                j._error = e
            j._done = True
