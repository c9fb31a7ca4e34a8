"""Deterministic fault injection for the durability path.

Counterpart of `elasticsearch_tpu/utils/faults.py`, trimmed to its
STORAGE family, the failure classes hooked at every `index/store.py` and
`index/translog.py` write / read boundary:

  * ``crash_point`` — the process "dies" at a named write site:
    ``site=store`` phases ``seg_npz|seg_meta|commit|cleanup``,
    ``site=translog`` phases ``append|fsync|rotate``. Fires at most once
    per installed registry (a process crashes once), first leaving the
    torn on-disk state the real crash would leave (half a translog record
    at ``append``; with ``unsynced=drop``, the bytes written since the
    last fsync are dropped too: the power-loss simulation). Then raises
    ``PowerLossError`` or, with ``kill=1``, SIGKILLs the process.
  * ``disk_corrupt`` — corrupts the file a READ is about to open
    (``mode=flip`` one seeded byte, ``mode=truncate`` the tail quarter),
    at read phases ``load_npz|load_meta|read_commit`` (store) / ``read``
    (translog); the read proceeds and the checksum / crc path detects it.
  * ``io_error`` — the read raises ``OSError(EIO)``, same read phases.

Spec grammar (env ``ES_TPU_FAULT_INJECT`` or node setting
``search.fault_injection``; comma-separated rules)::

    crash_point:site=store:phase=commit
    crash_point:site=translog:phase=append:rate=0.02:seed=9:kill=1
    crash_point:site=translog:phase=fsync:unsynced=drop
    disk_corrupt:site=store:phase=load_npz:mode=flip
    io_error:site=store:phase=load_meta:index=logs:shard=0

Selectors ``site``, ``phase``, ``index`` and ``shard`` restrict where a
rule fires; omitted selectors match everything. ``rate`` draws from one
seeded RNG (``seed=`` on any rule reseeds the registry), so a spec and
seed give the same firing sequence every run.

The dispatch kinds (``shard_error``, ``shard_delay``, ``breaker_trip``,
``device_dead``), the control-plane kinds (``host_dead``, ``ctrl_drop``,
``ctrl_delay``, ``net_partition``) and ``StepBudget`` are not ported: a
rule of one of those kinds raises NotImplementedError naming it.
"""

from __future__ import annotations

import errno
import os
import random
import signal
import threading

from .errors import PowerLossError

DISPATCH_KINDS = ("shard_error", "shard_delay", "breaker_trip",
                  "device_dead")
CTRL_KINDS = ("host_dead", "ctrl_drop", "ctrl_delay", "net_partition")
STORAGE_KINDS = ("crash_point", "disk_corrupt", "io_error")
KINDS = DISPATCH_KINDS + CTRL_KINDS + STORAGE_KINDS

# the write sites a crash_point may name and the read sites a
# disk_corrupt / io_error may name, per storage subsystem, validated at
# parse time so a mistyped phase fails the spec instead of never firing
STORAGE_WRITE_PHASES = {
    "store": ("seg_npz", "seg_meta", "commit", "cleanup"),
    "translog": ("append", "fsync", "rotate"),
}
STORAGE_READ_PHASES = {
    "store": ("load_npz", "load_meta", "read_commit"),
    "translog": ("read",),
}


class FaultRule:
    """One parsed storage rule: a fault kind plus match selectors."""

    __slots__ = ("kind", "site", "index", "shard", "phase", "rate", "mode",
                 "kill", "unsynced", "fired")

    def __init__(self, kind: str, site: str | None = None,
                 index: str | None = None, shard: int | None = None,
                 replica: int | None = None, phase: str | None = None,
                 rate: float = 1.0, ms: float = 0.0,
                 breaker: str | None = None, host: str | None = None,
                 action: str | None = None, mode: str = "flip",
                 kill: int = 0, unsynced: str | None = None,
                 hosts: frozenset | None = None,
                 heal: frozenset | None = None):
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind [{kind}] "
                             f"(expected one of {KINDS})")
        if kind not in STORAGE_KINDS:
            raise NotImplementedError(
                f"fault kind [{kind}] is not ported (storage kinds only: "
                f"{STORAGE_KINDS})")
        if hosts is not None or heal is not None:
            raise ValueError(
                f"[hosts=]/[heal=] apply only to net_partition, "
                f"not [{kind}] (use host= for single-host selectors)")
        # storage rules select on (site, phase, index, shard); a file has
        # no replica / host identity and no dispatch phase
        for sel, val in (("replica", replica), ("host", host),
                         ("action", action)):
            if val is not None:
                raise ValueError(
                    f"{kind} is a storage fault; [{sel}=] does not "
                    "apply (use site=/phase=/index=/shard=)")
        if site is not None and site not in STORAGE_WRITE_PHASES:
            raise ValueError(
                f"{kind} site must be one of "
                f"{tuple(STORAGE_WRITE_PHASES)}, got [{site}]")
        valid = (STORAGE_WRITE_PHASES if kind == "crash_point"
                 else STORAGE_READ_PHASES)
        if phase is not None:
            sites = (site,) if site is not None else tuple(valid)
            if not any(phase in valid[s] for s in sites):
                raise ValueError(
                    f"{kind} phase [{phase}] is not a valid "
                    f"{'write' if kind == 'crash_point' else 'read'}"
                    f" site for {sites} (expected "
                    f"{ {s: valid[s] for s in sites} })")
        if kind != "crash_point" and (kill or unsynced is not None):
            raise ValueError("[kill=]/[unsynced=] apply only to crash_point")
        if kind != "disk_corrupt" and mode != "flip":
            raise ValueError("[mode=] applies only to disk_corrupt")
        if mode not in ("flip", "truncate"):
            raise ValueError(
                f"disk_corrupt mode must be flip|truncate, got [{mode}]")
        if unsynced not in (None, "drop"):
            raise ValueError(
                f"crash_point unsynced must be [drop] when given, "
                f"got [{unsynced}]")
        self.kind = kind
        self.site = site
        self.index = index
        self.shard = shard
        self.phase = phase
        self.rate = rate
        self.mode = mode
        self.kill = bool(kill)
        self.unsynced = unsynced
        self.fired = 0

    def matches_storage(self, site: str, phase: str,
                        index: str | None, shard: int | None) -> bool:
        """(site, phase) name the write / read site; index / shard scope
        the rule to one shard's files when the caller knows them."""
        if self.site is not None and site != self.site:
            return False
        if self.phase is not None and phase != self.phase:
            return False
        if self.index is not None and index != self.index:
            return False
        if self.shard is not None and shard != self.shard:
            return False
        return True

    def describe(self) -> dict:
        sel = {k: getattr(self, k) for k in ("site", "index", "shard")
               if getattr(self, k) is not None}
        out = {"kind": self.kind, "phase": self.phase or "any",
               "rate": self.rate, "fired": self.fired, **sel}
        if self.kind == "disk_corrupt":
            out["mode"] = self.mode
        if self.kind == "crash_point":
            if self.kill:
                out["kill"] = True
            if self.unsynced is not None:
                out["unsynced"] = self.unsynced
        return out


class FaultRegistry:
    """A parsed fault spec + one seeded RNG shared by every rate draw."""

    def __init__(self, rules: list[FaultRule], seed: int = 0):
        self.rules = rules
        self.seed = seed
        self._rng = random.Random(seed)
        self._mx = threading.Lock()

    @classmethod
    def parse(cls, spec: str | None) -> "FaultRegistry":
        rules: list[FaultRule] = []
        seed = 0
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            fields = part.split(":")
            kw: dict = {}
            for f in fields[1:]:
                key, _, val = f.partition("=")
                key = key.strip()
                val = val.strip()
                if key in ("shard", "replica", "kill"):
                    kw[key] = int(val)
                elif key in ("rate", "ms"):
                    kw[key] = float(val)
                elif key == "seed":
                    seed = int(val)
                elif key in ("site", "index", "breaker", "phase",
                             "host", "action", "mode", "unsynced"):
                    kw[key] = val
                elif key in ("hosts", "heal"):
                    kw[key] = frozenset(h for h in val.split("+") if h)
                else:
                    raise ValueError(
                        f"unknown fault selector [{key}] in [{part}]")
            rules.append(FaultRule(fields[0].strip(), **kw))
        return cls(rules, seed)

    def on_storage_write(self, site: str, phase: str,
                         index: str | None = None,
                         shard: int | None = None,
                         partial=None, unsynced_drop=None) -> None:
        """Evaluate crash_point rules at a storage WRITE boundary. A
        firing rule first runs `partial` (the caller's torn-state writer)
        and, under ``unsynced=drop``, `unsynced_drop` (truncate back to
        the last fsynced offset), then dies: SIGKILL with ``kill=1``,
        else PowerLossError. One-shot per registry."""
        for rule in self.rules:
            if rule.kind != "crash_point" or rule.fired:
                continue
            if not rule.matches_storage(site, phase, index, shard):
                continue
            with self._mx:
                if rule.fired:
                    continue
                if rule.rate < 1.0 and self._rng.random() >= rule.rate:
                    continue
                rule.fired += 1
            if partial is not None:
                partial()
            if rule.unsynced == "drop" and unsynced_drop is not None:
                unsynced_drop()
            if rule.kill:
                os.kill(os.getpid(), signal.SIGKILL)
            raise PowerLossError(
                f"injected crash_point at {site}:{phase}"
                + (f" [{index}][{shard}]" if index is not None else ""))

    def on_storage_read(self, site: str, phase: str, path: str,
                        index: str | None = None,
                        shard: int | None = None) -> None:
        """Evaluate disk_corrupt / io_error rules at a storage READ
        boundary, before the caller opens `path`: disk_corrupt mutates
        the file and lets the read proceed; io_error raises EIO."""
        for rule in self.rules:
            if rule.kind not in ("disk_corrupt", "io_error"):
                continue
            if not rule.matches_storage(site, phase, index, shard):
                continue
            with self._mx:
                if rule.rate < 1.0 and self._rng.random() >= rule.rate:
                    continue
                rule.fired += 1
                if rule.kind == "disk_corrupt":
                    _corrupt_file(path, rule.mode, self._rng)
                    continue
            raise OSError(errno.EIO,
                          f"injected io_error at {site}:{phase}", path)

    def snapshot(self) -> dict:
        return {"enabled": bool(self.rules), "seed": self.seed,
                "rules": [r.describe() for r in self.rules]}


_mx = threading.Lock()
_registry: FaultRegistry | None = None


def active() -> FaultRegistry:
    """The process-wide registry; first use parses ES_TPU_FAULT_INJECT."""
    global _registry
    if _registry is None:
        with _mx:
            if _registry is None:
                _registry = FaultRegistry.parse(
                    os.environ.get("ES_TPU_FAULT_INJECT", ""))
    return _registry


def configure(spec: str | None, seed: int | None = None) -> FaultRegistry:
    """Install a new registry from a spec string (None/"" disables)."""
    global _registry
    with _mx:
        reg = FaultRegistry.parse(spec)
        if seed is not None:
            reg.seed = seed
            reg._rng = random.Random(seed)
        _registry = reg
        return reg


def clear() -> None:
    configure("")


def on_storage_write(site: str, phase: str, index: str | None = None,
                     shard: int | None = None,
                     partial=None, unsynced_drop=None) -> None:
    """Storage write-boundary hook (crash_point); one attribute check
    when no rules are installed."""
    reg = active()
    if reg.rules:
        reg.on_storage_write(site, phase, index=index, shard=shard,
                             partial=partial, unsynced_drop=unsynced_drop)


def on_storage_read(site: str, phase: str, path: str,
                    index: str | None = None,
                    shard: int | None = None) -> None:
    """Storage read-boundary hook (disk_corrupt / io_error); one
    attribute check when no rules are installed."""
    reg = active()
    if reg.rules:
        reg.on_storage_read(site, phase, path, index=index, shard=shard)


def _corrupt_file(path: str, mode: str, rng: random.Random) -> None:
    """One seeded byte flip, or a tail-quarter truncation. Missing or
    empty files are left alone."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return
    if size <= 0:
        return
    if mode == "truncate":
        keep = size - max(size // 4, 1)
        with open(path, "r+b") as f:
            f.truncate(max(keep, 0))
        return
    pos = rng.randrange(size)
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))


def snapshot() -> dict:
    return active().snapshot()
