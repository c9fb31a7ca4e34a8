"""Translog: per-shard write-ahead log for durability and recovery.

Counterpart of `elasticsearch_tpu/index/translog.py` (ref:
index/translog/Translog.java and the fs implementation), the Python
writer only; the reference's native WAL (a host C++ library) is not
ported. The on-disk format is the reference's byte for byte, so each
package recovers the other's files.

Record format (binary, little-endian):
    [u32 length][u32 crc32-of-payload][payload: JSON, separators (",", ":")]
A torn tail (the file ends inside a record, the residue of a crash
mid-append) is truncated on open and counted under
`translog_truncated_bytes`. A complete record that fails its crc or
parse is mid-log corruption of a durable record: that raises
TranslogCorruptedError and the engine contains the shard.

Durability modes (`index.translog.durability`):
  * ``request`` (default) — fsync after every op: an op is on disk
    before its caller sees the ack;
  * ``async`` — written to the page cache before the op is acked, fsync
    only at sync() / flush / rotate: an op survives kill -9 but power
    loss may drop the window since the last sync. `_synced_size` tracks
    the known-durable prefix; the crash_point `unsynced=drop` simulation
    truncates back to it. An op outside a bulk is written as it is
    added; a bulk request's ops, acked together when it returns, are
    written once at its end (`durability.acked_together`, which the
    node's bulk enters), which saves a write per op where the
    filesystem makes each one dear.

Generations: translog-<gen>.log; flush rotates to a new generation and
deletes the old ones once the segments they cover are committed. Every
append / fsync / rotate write boundary and every recovery read is hooked
into `utils/faults.py`.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from dataclasses import dataclass

from ..utils import faults
from ..utils.errors import ElasticsearchTpuError, IllegalArgumentError
from . import durability as durability_stats

_HEADER = struct.Struct("<II")
# json.dumps' string encoder (ensure_ascii, the default)
_enc = json.encoder.encode_basestring_ascii

OP_INDEX = "index"
OP_DELETE = "delete"

DURABILITY_REQUEST = "request"
DURABILITY_ASYNC = "async"


class TranslogCorruptedError(ElasticsearchTpuError):
    """A durable (complete) translog record failed its crc or parse."""

    status = 500


@dataclass
class TranslogOp:
    op: str                       # index | delete
    doc_id: str
    version: int
    source: bytes | None = None   # for index ops

    def to_payload(self) -> bytes:
        """The reference's `json.dumps({"op", "id", "v"[, "src"]},
        separators=(",", ":"))`, byte for byte, without the encoder's
        generic walk (one record per acked op)."""
        out = (f'{{"op":{_enc(self.op)},"id":{_enc(self.doc_id)},'
               f'"v":{int(self.version)}')
        if self.source is not None:
            out += f',"src":{_enc(self.source.decode("utf-8"))}'
        return (out + "}").encode("utf-8")

    @classmethod
    def from_payload(cls, payload: bytes) -> "TranslogOp":
        d = json.loads(payload)
        src = d.get("src")
        return cls(op=d["op"], doc_id=d["id"], version=d["v"],
                   source=src.encode("utf-8") if src is not None else None)


class Translog:
    """Append-only op log with crc-checked records and generations."""

    def __init__(self, path: str, durability: str = DURABILITY_ASYNC,
                 index: str | None = None, shard: int | None = None):
        self.dir = path
        if durability not in (DURABILITY_REQUEST, DURABILITY_ASYNC):
            raise IllegalArgumentError(
                f"index.translog.durability must be "
                f"[{DURABILITY_REQUEST}] or [{DURABILITY_ASYNC}], "
                f"got [{durability}]")
        self.durability = durability
        self.sync_each_op = durability == DURABILITY_REQUEST
        self.index = index
        self.shard = shard
        self.truncated_bytes = 0
        os.makedirs(path, exist_ok=True)
        gens = self._generations()
        self.generation = gens[-1] if gens else 1
        # recover the tail before appending
        existing = self._recover_file(self._file_for(self.generation))
        self._ops_in_gen = len(existing)
        self._fh = open(self._file_for(self.generation), "ab")
        self._size_in_gen = self._fh.tell()
        # the known-durable prefix: what existed at open is on disk
        self._synced_size = self._size_in_gen
        # `async` records not yet written (a bulk's, until it ends): held
        # here, not in the file's buffer, so that none reaches the file
        # in part or ahead of its doc's metadata
        self._pending: list[bytes] = []
        self._mx = threading.Lock()

    # -- paths -------------------------------------------------------------
    def _file_for(self, gen: int) -> str:
        return os.path.join(self.dir, f"translog-{gen}.log")

    def _generations(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("translog-") and name.endswith(".log"):
                try:
                    out.append(int(name[len("translog-"):-len(".log")]))
                except ValueError:
                    pass
        return sorted(out)

    def min_generation(self) -> int | None:
        """Oldest generation on disk: recovery may fall back to a commit
        C only when min_generation() <= C's translog generation + 1."""
        gens = self._generations()
        return gens[0] if gens else None

    # -- write path --------------------------------------------------------
    def add(self, op: TranslogOp) -> None:
        payload = op.to_payload()
        rec = _HEADER.pack(len(payload), zlib.crc32(payload)) + payload

        def torn_append():
            # a real mid-append death: the record's prefix on disk (a
            # bulk's earlier records, still pending, die with the process)
            self._fh.write(rec[: max(len(rec) // 2, 1)])
            self._fh.flush()
        faults.on_storage_write("translog", "append", index=self.index,
                                shard=self.shard, partial=torn_append,
                                unsynced_drop=self._drop_unsynced)
        self._ops_in_gen += 1
        self._size_in_gen += len(rec)
        if self.sync_each_op:
            self._fh.write(rec)
            self.sync()
        else:
            with self._mx:
                self._pending.append(rec)
            durability_stats.write_before_ack(self, self._write_pending)

    def _write_pending(self) -> None:
        """Hand the pending records to the page cache."""
        with self._mx:
            if self._fh.closed:
                return
            if self._pending:
                self._fh.write(b"".join(self._pending))
                self._pending.clear()
            self._fh.flush()

    def _drop_unsynced(self) -> None:
        """Power-loss simulation: truncate back to the known-durable
        prefix (a no-op in `request` mode, where the prefix is the
        file); the pending records die with the process."""
        with self._mx:
            self._pending.clear()
        self._fh.flush()
        path = self._file_for(self.generation)
        if os.path.exists(path) \
                and os.path.getsize(path) > self._synced_size:
            os.truncate(path, self._synced_size)

    def sync(self) -> None:
        faults.on_storage_write("translog", "fsync", index=self.index,
                                shard=self.shard,
                                unsynced_drop=self._drop_unsynced)
        self._write_pending()
        os.fsync(self._fh.fileno())
        self._synced_size = self._size_in_gen

    # -- snapshot / recovery ----------------------------------------------
    def snapshot(self) -> list[TranslogOp]:
        """All ops across live generations, in order (the replay
        stream)."""
        if self._fh is not None:
            self._write_pending()
        ops: list[TranslogOp] = []
        for gen in self._generations():
            ops.extend(self._recover_file(self._file_for(gen)))
        return ops

    def _recover_file(self, path: str) -> list[TranslogOp]:
        """Replay one generation file: a torn tail is truncated and
        counted; a complete record failing crc or parse raises."""
        ops: list[TranslogOp] = []
        if not os.path.exists(path):
            return ops
        faults.on_storage_read("translog", "read", path,
                               index=self.index, shard=self.shard)
        good_end = 0
        with open(path, "rb") as f:
            data = f.read()
        off = 0
        while off + _HEADER.size <= len(data):
            length, crc = _HEADER.unpack_from(data, off)
            start = off + _HEADER.size
            end = start + length
            if end > len(data):
                break  # torn tail: the record never finished hitting disk
            payload = data[start:end]
            if zlib.crc32(payload) != crc:
                durability_stats.on_corruption_detected()
                raise TranslogCorruptedError(
                    f"translog [{os.path.basename(path)}] record at "
                    f"offset {off} failed crc (durable record "
                    f"corrupted; {len(data) - off} bytes at risk)")
            try:
                ops.append(TranslogOp.from_payload(payload))
            except Exception as e:
                durability_stats.on_corruption_detected()
                raise TranslogCorruptedError(
                    f"translog [{os.path.basename(path)}] record at "
                    f"offset {off} unparseable: {e}") from e
            off = end
            good_end = end
        if good_end < len(data):
            torn = len(data) - good_end
            with open(path, "r+b") as f:
                f.truncate(good_end)
            self.truncated_bytes += torn
            durability_stats.on_translog_truncated(torn)
        return ops

    # -- rotation (flush) --------------------------------------------------
    def rotate(self) -> None:
        """Start a new generation and drop the old ones (after a commit
        made the ops they hold durable in segments). A crash before the
        rotation keeps every old generation: replay re-applies ops the
        commit covers, with the same ids and versions."""
        faults.on_storage_write("translog", "rotate", index=self.index,
                                shard=self.shard,
                                unsynced_drop=self._drop_unsynced)
        old_gens = self._generations()
        self._write_pending()
        self._fh.close()
        self.generation = (old_gens[-1] if old_gens else 0) + 1
        self._fh = open(self._file_for(self.generation), "ab")
        self._ops_in_gen = 0
        self._size_in_gen = 0
        self._synced_size = 0
        for gen in old_gens:
            try:
                os.remove(self._file_for(gen))
            except OSError:
                pass

    def close(self) -> None:
        try:
            if self._fh is not None:
                self._write_pending()
                self._fh.close()
        except Exception:
            pass

    def stats(self) -> dict:
        return {"operations": self._ops_in_gen,
                "size_in_bytes": self._size_in_gen,
                "generation": self.generation,
                "durability": self.durability,
                "truncated_bytes": self.truncated_bytes}
