"""ResourceWatcherService: polling file watcher with listeners.

Counterpart of `elasticsearch_tpu/utils/watcher.py`. Reference analog:
watcher/ResourceWatcherService.java + FileWatcher /
FileChangesListener — a scheduled poll at three frequencies (HIGH 5s,
MEDIUM 25s, LOW 60s, overridable via
`resource.reload.interval.{high,medium,low}`; `resource.reload.enabled`
gates the whole service) notifying listeners of created / changed /
deleted files. The reference uses it to hot-reload file scripts, role
mappings and hunspell dictionaries; here it backs file-script reload
(script/service.py) and is a public extension point for plugins.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field

from .settings import Settings

HIGH, MEDIUM, LOW = "high", "medium", "low"
_DEFAULT_INTERVALS = {HIGH: 5.0, MEDIUM: 25.0, LOW: 60.0}


class FileChangesListener:
    """Ref: watcher/FileChangesListener.java — override any subset."""

    def on_file_created(self, path: str) -> None:  # pragma: no cover
        pass

    def on_file_changed(self, path: str) -> None:  # pragma: no cover
        pass

    def on_file_deleted(self, path: str) -> None:  # pragma: no cover
        pass


@dataclass
class FileWatcher:
    """Watches one file or directory tree by mtime+size snapshots
    (ref: watcher/FileWatcher.java)."""

    path: str
    listeners: list[FileChangesListener] = field(default_factory=list)
    _state: dict[str, tuple[float, int]] = field(default_factory=dict)
    _initialized: bool = False

    def add_listener(self, listener: FileChangesListener) -> None:
        self.listeners.append(listener)

    def _scan(self) -> dict[str, tuple[float, int]]:
        out: dict[str, tuple[float, int]] = {}
        if os.path.isfile(self.path):
            try:
                st = os.stat(self.path)
                out[self.path] = (st.st_mtime, st.st_size)
            except OSError:
                pass
            return out
        for root, _dirs, files in os.walk(self.path):
            for f in files:
                p = os.path.join(root, f)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                out[p] = (st.st_mtime, st.st_size)
        return out

    def init(self) -> None:
        """First scan: existing files surface as created (the reference
        calls onFileInit, which most listeners alias to created)."""
        self._state = self._scan()
        self._initialized = True
        for p in sorted(self._state):
            for l in self.listeners:
                l.on_file_created(p)

    def check(self) -> None:
        if not self._initialized:
            self.init()
            return
        now = self._scan()
        for p in sorted(now):
            if p not in self._state:
                for l in self.listeners:
                    l.on_file_created(p)
            elif now[p] != self._state[p]:
                for l in self.listeners:
                    l.on_file_changed(p)
        for p in sorted(self._state):
            if p not in now:
                for l in self.listeners:
                    l.on_file_deleted(p)
        self._state = now


class ResourceWatcherService:
    """Schedules FileWatcher polls on a daemon thread.

    `notify_now(freq)` runs a poll synchronously — what the reference's
    tests do through its exposed Scheduler — so tests and callers never
    need to sleep.
    """

    def __init__(self, settings: Settings = Settings.EMPTY):
        self.enabled = settings.get_bool("resource.reload.enabled", True)
        self.intervals = {
            f: settings.get_time(f"resource.reload.interval.{f}", dflt)
            for f, dflt in _DEFAULT_INTERVALS.items()}
        self._watchers: dict[str, list[FileWatcher]] = {
            HIGH: [], MEDIUM: [], LOW: []}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_run = {f: 0.0 for f in _DEFAULT_INTERVALS}

    def add(self, watcher: FileWatcher, frequency: str = MEDIUM
            ) -> FileWatcher:
        if frequency not in self._watchers:
            raise ValueError(f"unknown watch frequency [{frequency}]")
        watcher.init()
        with self._lock:
            self._watchers[frequency].append(watcher)
        if self.enabled:
            self._ensure_thread()
        return watcher

    def remove(self, watcher: FileWatcher) -> None:
        with self._lock:
            for lst in self._watchers.values():
                if watcher in lst:
                    lst.remove(watcher)

    def notify_now(self, frequency: str = MEDIUM) -> None:
        with self._lock:
            watchers = list(self._watchers[frequency])
        for w in watchers:
            w.check()

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="resource-watcher")
        self._thread.start()

    def _run(self) -> None:
        import time
        tick = min(1.0, min(self.intervals.values()))
        while not self._stop.wait(tick):
            now = time.monotonic()
            for freq, interval in self.intervals.items():
                if now - self._last_run[freq] >= interval:
                    self._last_run[freq] = now
                    try:
                        self.notify_now(freq)
                    except Exception:  # listener bugs must not kill polls
                        import logging
                        logging.getLogger(__name__).exception(
                            "resource watcher poll failed")

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
