"""Traffic control plane: tenant quotas, priority lanes, adaptive
coalescing, and admission control over the search read path.

Counterpart of `elasticsearch_tpu/search/traffic.py` (host code).

Reference analog: the reference's layers 0-1 — 15 named thread pools
with bounded queues answering 429 `EsRejectedExecutionException` when
saturated, under parent circuit-breaker budgets. Those layers shed load
*after* a request holds queue slots and breaker bytes. On this stack
per-query device cost variance is far higher (a lone fused query is
sub-millisecond batched but a cold compile or a 20M-row agg is not), so
admission must act at the REST/node entry BEFORE a query takes a
breaker hold or a device program slot — a shed request costs one token
bucket subtraction and a structured 429 with Retry-After, nothing else.

Four cooperating pieces, all host-side and lock-cheap (no blocking call
ever runs under a traffic lock):

* **TenantState / token buckets** — every request resolves to a tenant
  id at the REST boundary (`X-Tenant-Id` header / `tenant_id` param,
  the `default` tenant otherwise). Dynamic settings
  `search.traffic.tenant.<id>.rate|burst|max_concurrent|lane` attach a
  refill-rate token bucket and an in-flight concurrency cap;
  unconfigured tenants are unlimited (accounting only).
* **Priority lanes** — the dispatch scheduler drains per-lane queues
  (`interactive` > `msearch` > `scroll` > `bulk`) with per-round batch
  quotas on the non-interactive lanes: a bulk flood is split into
  bounded rounds, and every interactive batch pending at round start
  rides the very next round — interactive can never queue behind an
  arbitrarily deep bulk backlog (starvation is structurally
  impossible, not statistically unlikely).
* **AdaptiveWindow** — replaces the static `ES_TPU_COALESCE_WINDOW_MS`
  with a controller driven by the two signals the scheduler already
  observes: EWMA batch inter-arrival gap (arrival rate) and EWMA
  batches-merged-per-round (real concurrency). Sequential traffic
  (rounds of 1) keeps the window at 0 so lone queries never sleep;
  concurrent traffic opens it toward `target x gap`, clamped to
  `max_ms`. The env/setting static window still wins when set — it is
  the explicit operator override, not the default.
* **Admission** — `admit()` (one search/scroll) raises
  TrafficRejectedError(429, retry_after) when the bucket or the
  concurrency cap says no; `admit_items()` (msearch) grants a prefix
  of the batch and prices the rejected tail, so one over-quota tenant
  degrades to partial progress + structured per-item 429s instead of
  all-or-nothing.

Stats surface under `nodes_stats()["dispatch"]["traffic"]`: per-tenant
admitted/rejected/queued (in-flight), lane depth high-waters, the
current window (mode + ms), and the generation-keyed query-cache hit
rate (fed by node._submit_on_readers).
"""

from __future__ import annotations

import math
import threading
import time

from ..utils.errors import TrafficRejectedError
from ..utils.metrics import EWMA, HighWaterMetric

# lane priority order: lower index drains first. Unknown lanes sort
# after bulk (a plugin-invented lane must not outrank interactive).
LANES = ("interactive", "msearch", "scroll", "bulk")
_LANE_PRIORITY = {name: i for i, name in enumerate(LANES)}

# per-drain-round batch quotas (None = unlimited). Interactive is
# never capped — capping it could delay exactly the traffic the lanes
# exist to protect. Non-interactive defaults keep bulk rounds small
# enough that a mid-flood interactive arrival waits at most one
# bounded round, while still coalescing within the round.
_DEFAULT_LANE_QUOTAS = {"interactive": None, "msearch": 4, "scroll": 2,
                        "bulk": 2}


def lane_priority(lane: str) -> int:
    return _LANE_PRIORITY.get(lane, len(LANES))


class TokenBucket:
    """Classic refill-rate token bucket. `clock` is injectable so quota
    tests are deterministic (seeded virtual time, no sleeps). NOT
    internally locked — the owning TenantState serializes access under
    the controller lock."""

    __slots__ = ("rate", "burst", "tokens", "_t", "_clock")

    def __init__(self, rate: float, burst: float, clock=time.monotonic):
        self.rate = float(rate)
        self.burst = max(float(burst), 1.0)
        self.tokens = self.burst
        self._clock = clock
        self._t = clock()

    def _refill(self) -> None:
        now = self._clock()
        if now > self._t:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._t) * self.rate)
        self._t = now

    def take(self, n: float = 1.0) -> float:
        """0.0 when n tokens were consumed; otherwise the seconds until
        n tokens will be available (nothing consumed)."""
        self._refill()
        if self.tokens + 1e-9 >= n:
            self.tokens -= n
            return 0.0
        if self.rate <= 0:
            return float("inf")
        return (n - self.tokens) / self.rate

    def take_upto(self, n: int) -> int:
        """Consume as many whole tokens as available, up to n."""
        self._refill()
        granted = min(n, int(self.tokens + 1e-9))
        if granted > 0:
            self.tokens -= granted
        return granted

    def time_until(self, n: float = 1.0) -> float:
        self._refill()
        if self.tokens + 1e-9 >= n:
            return 0.0
        if self.rate <= 0:
            return float("inf")
        return (n - self.tokens) / self.rate


class TenantState:
    """One tenant's quota objects + lifetime counters. Mutated only
    under the controller lock."""

    __slots__ = ("tenant", "bucket", "max_concurrent", "lane",
                 "in_flight", "in_flight_hw", "admitted", "rejected")

    def __init__(self, tenant: str):
        self.tenant = tenant
        self.bucket: TokenBucket | None = None
        self.max_concurrent: int | None = None
        self.lane: str | None = None
        self.in_flight = 0
        self.in_flight_hw = 0
        self.admitted = 0
        self.rejected = 0

    def snapshot(self) -> dict:
        return {"admitted": self.admitted, "rejected": self.rejected,
                "queued": self.in_flight,
                "queued_high_water": self.in_flight_hw,
                "lane": self.lane or "",
                "rate": self.bucket.rate if self.bucket else None,
                "max_concurrent": self.max_concurrent}


class Ticket:
    """One admitted request's in-flight reservation (n slots against
    the tenant's concurrency cap). Release is idempotent — the node's
    finally block and an error path may both call it."""

    __slots__ = ("_controller", "tenant", "_n", "_released", "lane",
                 "granted")

    def __init__(self, controller: "TrafficController", tenant: str,
                 n: int, lane: str, granted: int | None = None):
        self._controller = controller
        self.tenant = tenant
        self._n = n
        self._released = False
        self.lane = lane
        self.granted = n if granted is None else granted

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._controller._release(self.tenant, self._n)


class ItemsTicket(Ticket):
    """admit_items() result: `granted` items proceed (first-come order
    preserved — the admitted prefix), the rest answer 429 priced at
    `retry_after_s`."""

    __slots__ = ("retry_after_s",)

    def __init__(self, controller, tenant, granted: int, requested: int,
                 lane: str, retry_after_s: float):
        super().__init__(controller, tenant, granted, lane,
                         granted=granted)
        self.retry_after_s = retry_after_s
        self._n = granted  # only admitted items hold concurrency slots


class AdaptiveWindow:
    """Coalescing-window controller (see module doc).

    Signals:
      * `observe_arrival()` per batch enqueue -> EWMA inter-arrival gap
      * `observe_round(n)` per drain round -> EWMA merged-batch count
        (the scheduler's real concurrency, incl. in-flight adoption)

    Policy: window stays 0 unless rounds actually merge (>1.05 EWMA —
    sequential callers can never benefit from waiting, their next batch
    arrives only after this one completes) AND another arrival is
    expected within `max_ms`. When open: `target` expected arrivals'
    worth of gap, clamped to [0, max_ms]. Goes back to 0 after
    `idle_reset_s` without arrivals."""

    def __init__(self, enabled: bool = True, max_ms: float = 4.0,
                 target: float = 2.0, decay: float = 0.2,
                 idle_reset_s: float = 1.0, clock=time.monotonic):
        self.enabled = bool(enabled)
        self.max_ms = float(max_ms)
        self.target = float(target)
        self._idle_reset_s = float(idle_reset_s)
        self._clock = clock
        self._mx = threading.Lock()
        self._last_arrival: float | None = None
        # the two signals are utils.metrics.EWMA objects (internally
        # locked): the gap series is unseeded (first sample seeds it; an idle
        # reset() forgets it), the merged-round series starts AT 1.0
        # (sequential traffic) and decays toward observed rounds
        self._gap = EWMA(alpha=float(decay))
        self._round = EWMA(alpha=float(decay), initial=1.0, seeded=True)
        self._last_window_ms = 0.0

    def observe_arrival(self) -> None:
        now = self._clock()
        with self._mx:
            if self._last_arrival is not None:
                gap = max(now - self._last_arrival, 1e-6)
                if gap <= self._idle_reset_s:
                    self._gap.update(gap)
                else:
                    # a fresh burst after idle: forget the stale gap
                    self._gap.reset()
            self._last_arrival = now

    def observe_round(self, n_batches: int) -> None:
        self._round.update(float(max(n_batches, 1)))

    def window_ms(self) -> float:
        if not self.enabled:
            return 0.0
        now = self._clock()
        with self._mx:
            w = 0.0
            if (self._last_arrival is not None
                    and now - self._last_arrival <= self._idle_reset_s
                    and self._round.value > 1.05
                    and self._gap.initialized):
                gap_ms = self._gap.value * 1000.0
                if gap_ms <= self.max_ms:  # another arrival is likely
                    w = min(self.max_ms, self.target * gap_ms)
            self._last_window_ms = w
            return w

    def snapshot(self) -> dict:
        with self._mx:
            gap_s = self._gap.value if self._gap.initialized else None
            return {"enabled": self.enabled, "max_ms": self.max_ms,
                    "target": self.target,
                    "ewma_gap_ms": (round(gap_s * 1000.0, 4)
                                    if gap_s is not None else None),
                    "ewma_round_batches": round(self._round.value, 3),
                    "last_window_ms": round(self._last_window_ms, 4)}


DEFAULT_TENANT = "default"


class TrafficController:
    """Per-tenant admission + lane policy + the adaptive window, built
    from the flat `search.traffic.*` settings group (node settings
    layered under dynamic cluster settings — reconfigure() republishes
    quotas without dropping counters or in-flight accounting).

    Ops and default lanes: search/count -> interactive, msearch ->
    msearch, scroll -> scroll; a tenant's `lane` setting overrides
    (that is how a known-bulk tenant's msearch traffic rides the bulk
    lane)."""

    _OP_LANES = {"search": "interactive", "msearch": "msearch",
                 "scroll": "scroll"}

    def __init__(self, cfg: dict | None = None,
                 adaptive: AdaptiveWindow | None = None,
                 clock=time.monotonic):
        self._mx = threading.Lock()
        self._clock = clock
        self._tenants: dict[str, TenantState] = {}
        self._limits: dict[str, dict] = {}
        self._lane_quotas = dict(_DEFAULT_LANE_QUOTAS)
        self._lane_depth: dict[str, HighWaterMetric] = {
            lane: HighWaterMetric() for lane in LANES}
        self.window = adaptive if adaptive is not None else AdaptiveWindow(
            clock=clock)
        self._cache_hits = 0
        self._cache_misses = 0
        self.reconfigure(cfg or {})

    # -- configuration -----------------------------------------------------
    def reconfigure(self, cfg: dict) -> None:
        """cfg: flat keys with the `search.traffic.` prefix stripped
        (`tenant.<id>.rate`, `lane.<name>.quota`, ...). Existing tenant
        counters and in-flight slots survive; buckets are rebuilt when
        their limits changed (a refreshed bucket starts full — a quota
        edit must not retroactively debt a tenant)."""
        limits: dict[str, dict] = {}
        lane_quotas = dict(_DEFAULT_LANE_QUOTAS)
        for key, val in cfg.items():
            if key.startswith("tenant."):
                # tenant ids are arbitrary header strings and may
                # contain dots: the ATTRIBUTE is the last segment, the
                # id is everything between (rsplit, not a fixed split —
                # a dotted-id tenant's quota must not silently no-op)
                tid, _, attr = key[len("tenant."):].rpartition(".")
                if tid and attr in ("rate", "burst", "max_concurrent",
                                    "lane"):
                    limits.setdefault(tid, {})[attr] = val
            elif key.startswith("lane.") and key.endswith(".quota"):
                if val in (None, ""):
                    continue          # null = unset: default quota stays
                q = int(val)
                name = key[len("lane."):-len(".quota")]
                lane_quotas[name] = None if q <= 0 else q
        with self._mx:
            self._limits = limits
            self._lane_quotas = lane_quotas
            for tenant, st in self._tenants.items():
                self._apply_limits_locked(st, limits.get(tenant))

    def _apply_limits_locked(self, st: TenantState,
                             lim: dict | None) -> None:
        if not lim:
            st.bucket = None
            st.max_concurrent = None
            st.lane = None
            return
        # settings arrive as raw JSON values OR strings: normalize
        # numerically so -1 / "-1" / unset all mean unlimited (rate 0
        # stays meaningful: fully blocked past the burst)
        rate = lim.get("rate")
        rate = None if rate in (None, "") else float(rate)
        if rate is None or rate < 0:
            st.bucket = None
        else:
            burst = float(lim.get("burst") or max(2.0 * rate, 1.0))
            if (st.bucket is None or st.bucket.rate != rate
                    or st.bucket.burst != max(burst, 1.0)):
                st.bucket = TokenBucket(rate, burst, clock=self._clock)
        mc = lim.get("max_concurrent")
        mc = None if mc in (None, "") else int(mc)
        st.max_concurrent = None if (mc is None or mc < 0) else mc
        st.lane = lim.get("lane") or None

    # tenant ids are attacker-controlled (the X-Tenant-Id header is
    # unauthenticated): per-tenant state must be bounded or random ids
    # grow _tenants — and every nodes_stats() snapshot — without limit
    _TENANT_CAP = 1024

    def _tenant_locked(self, tenant: str | None) -> TenantState:
        tid = tenant or DEFAULT_TENANT
        st = self._tenants.get(tid)
        if st is None:
            if len(self._tenants) >= self._TENANT_CAP:
                self._evict_tenants_locked()
            st = TenantState(tid)
            self._apply_limits_locked(st, self._limits.get(tid))
            self._tenants[tid] = st
        return st

    def _evict_tenants_locked(self) -> None:
        """Drop oldest UNCONFIGURED idle tenants (accounting-only
        entries — their counters are the only loss). Operator-
        configured tenants and anything in flight are never evicted;
        if nothing qualifies the map grows past the cap rather than
        corrupting live accounting."""
        spare = [tid for tid, st in self._tenants.items()
                 if tid not in self._limits and st.in_flight == 0
                 and tid != DEFAULT_TENANT]
        for tid in spare[: max(len(self._tenants) - self._TENANT_CAP + 1,
                               self._TENANT_CAP // 8)]:
            del self._tenants[tid]

    # -- admission ---------------------------------------------------------
    def admit(self, tenant: str | None, op: str) -> Ticket:
        """Admit one search/scroll; raises TrafficRejectedError (429 +
        retry_after) on a quota/concurrency reject. Runs BEFORE the
        request takes a thread-pool slot or any breaker hold — a shed
        request costs only this bookkeeping."""
        with self._mx:
            st = self._tenant_locked(tenant)
            lane = st.lane or self._OP_LANES.get(op, "interactive")
            if st.max_concurrent is not None \
                    and st.in_flight + 1 > st.max_concurrent:
                st.rejected += 1
                raise TrafficRejectedError(
                    st.tenant, f"concurrency limit "
                    f"[{st.max_concurrent}] reached",
                    retry_after_s=0.1)
            if st.bucket is not None:
                wait = st.bucket.take(1.0)
                if wait > 0.0:
                    st.rejected += 1
                    raise TrafficRejectedError(
                        st.tenant, f"rate limit "
                        f"[{st.bucket.rate:g}/s] exceeded",
                        retry_after_s=wait)
            st.admitted += 1
            st.in_flight += 1
            st.in_flight_hw = max(st.in_flight_hw, st.in_flight)
        return Ticket(self, st.tenant, 1, lane)

    def admit_items(self, tenant: str | None, op: str,
                    n: int) -> ItemsTicket:
        """msearch admission: grant the longest admissible prefix of n
        items (tokens AND concurrency headroom), price the rejected
        tail. Never raises — zero granted is a valid answer and the
        caller renders per-item 429s for the remainder."""
        with self._mx:
            st = self._tenant_locked(tenant)
            lane = st.lane or self._OP_LANES.get(op, "msearch")
            # concurrency clamp FIRST, tokens second — take_upto
            # consumes what it grants, so clamping afterwards would
            # permanently burn tokens for items the concurrency cap
            # then rejects (charging the tenant for work never run)
            granted = n
            if st.max_concurrent is not None:
                granted = max(0, min(
                    granted, st.max_concurrent - st.in_flight))
            if st.bucket is not None:
                granted = st.bucket.take_upto(granted)
            retry_after = 0.0
            if granted < n:
                st.rejected += n - granted
                retry_after = 0.1
                if st.bucket is not None:
                    retry_after = max(retry_after,
                                      st.bucket.time_until(1.0))
            st.admitted += granted
            st.in_flight += granted
            st.in_flight_hw = max(st.in_flight_hw, st.in_flight)
        return ItemsTicket(self, st.tenant, granted, n, lane,
                           retry_after)

    def _release(self, tenant: str, n: int) -> None:
        with self._mx:
            st = self._tenants.get(tenant)
            if st is not None:
                st.in_flight = max(0, st.in_flight - n)

    # -- scheduler hooks ---------------------------------------------------
    def lane_quota(self, lane: str) -> int | None:
        with self._mx:
            return self._lane_quotas.get(
                lane, _DEFAULT_LANE_QUOTAS.get("bulk"))

    def note_lane_depth(self, lane: str, depth: int) -> None:
        with self._mx:
            hw = self._lane_depth.get(lane)
            if hw is None:
                hw = self._lane_depth.setdefault(lane,
                                                 HighWaterMetric())
        hw.record(depth)

    # -- cache accounting (fed by node._submit_on_readers) -----------------
    def note_cache(self, hit: bool) -> None:
        with self._mx:
            if hit:
                self._cache_hits += 1
            else:
                self._cache_misses += 1

    # -- stats -------------------------------------------------------------
    def snapshot(self) -> dict:
        with self._mx:
            tenants = {tid: st.snapshot()
                       for tid, st in sorted(self._tenants.items())}
            lanes = {lane: {"depth_high_water": hw.max,
                            "quota": self._lane_quotas.get(lane)}
                     for lane, hw in sorted(self._lane_depth.items())}
            hits, misses = self._cache_hits, self._cache_misses
        consulted = hits + misses
        return {
            "tenants": tenants,
            "lanes": lanes,
            "window": self.window.snapshot(),
            "query_cache": {
                "hits": hits, "misses": misses,
                "hit_rate": (hits / consulted) if consulted else 0.0},
        }


def retry_after_header(seconds: float) -> str:
    """Retry-After is integer seconds on the wire; sub-second throttle
    horizons still answer at least 1 so naive clients do not hot-loop."""
    if not math.isfinite(seconds):
        return "60"
    return str(max(1, int(math.ceil(seconds))))


def controller_from_settings(settings, clock=time.monotonic
                             ) -> TrafficController:
    """Build from a Settings object: `search.traffic.*` is the quota /
    lane group; the adaptive window reads its knobs from
    `search.dispatch.adaptive_window*` (enabled by default — it
    converges to 0 for sequential traffic, so enabling it costs lone
    queries nothing)."""
    adaptive = AdaptiveWindow(
        enabled=settings.get_bool("search.dispatch.adaptive_window",
                                  True),
        max_ms=settings.get_float(
            "search.dispatch.adaptive_window_max_ms", 4.0),
        target=settings.get_float(
            "search.dispatch.adaptive_window_target", 2.0),
        clock=clock)
    return TrafficController(
        settings.by_prefix("search.traffic.").as_dict(),
        adaptive=adaptive, clock=clock)
