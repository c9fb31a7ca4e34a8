"""Segment persistence: checksummed on-disk columnar format + commits.

Counterpart of `elasticsearch_tpu/index/store.py` (ref:
index/store/Store.java, the Lucene commit point and
gateway/MetaDataStateFormat's checksummed, atomically renamed state
files), with the reference's file format, so each package opens the
other's stores.

Layout under <shard_path>/store/:
    seg_<id>@<gen>.npz       numeric arrays (postings CSR, columns,
                             versions, live mask, sources)
    seg_<id>@<gen>.meta.json string data (terms, ids) + sha256 of the npz.
                             Write-once: a flush that must re-save a
                             segment (its live mask changed) writes a new
                             @<commit-gen> pair; unsuffixed seg_<id>.*
                             names are the direct-Store-API form
    commit_<gen>.json        atomic commit point: the live segments, their
                             file stems, the translog generation active at
                             commit time and a payload self-checksum. The
                             previous generation is kept until the next
                             commit, the salvage walk's fallback
    corrupted_<uuid>         corruption marker: a shard that detected
                             corruption writes one and fails; recovery
                             refuses the copy until it is cleared

A segment keeps its `raw` numeric columns; the device-dtype `values` are
rebuilt from them on load (`segment._device_vals`), and the flushed
columns the search path reads are derived at upload
(`search/executor.device_arrays`), never saved. A compacted base
(`impacts_preserved`) persists its per-posting impacts and reloads
through `_pack_layout_host(pf, cap, imps)`; a delta reloads as the delta
(`delta_parent`, `delta_epoch`, `pad_delta_shapes`). Vector columns
are saved as their f32 values and exists mask (`vec__<field>__*`, norms
recomputed on load) and IVF indexes as their arrays (`ann__<field>__*`),
in the reference's format. The port's Segment has no geo, completion or
parent columns: a file holding one raises NotImplementedError on load.

Every write / read boundary is hooked into `utils/faults.py`.
"""

from __future__ import annotations

import errno
import hashlib
import json
import os
import time
import uuid

import numpy as np

from ..utils import faults
from ..utils.errors import ElasticsearchTpuError
from . import durability
from .ann import AnnIndex
from .segment import (KeywordColumn, NumericColumn, PostingsField, Segment,
                      _device_vals, _flat_impacts, _pack_layout_host,
                      extract_flat_impacts, pad_delta_shapes, vector_column)


class CorruptIndexError(ElasticsearchTpuError):
    status = 500


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _commit_checksum(commit: dict) -> str:
    """Self-checksum over the canonical commit payload (everything but
    the checksum field): a corrupted commit point is detected, never
    half-parsed."""
    body = {k: v for k, v in commit.items() if k != "checksum"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True,
                   separators=(",", ":")).encode()).hexdigest()


def _not_ported_columns(meta: dict, files) -> list[str]:
    out = [f"{k} {sorted(meta[k]) if isinstance(meta[k], dict) else meta[k]}"
           for k in ("geos", "completions") if meta.get(k)]
    if "parent_of" in files:
        out.append("parent_of")
    return out


class Store:
    """One shard's on-disk segment store. `index` / `shard` scope the
    fault-injection selectors to this shard."""

    CORRUPTED_PREFIX = "corrupted_"

    def __init__(self, path: str, index: str | None = None,
                 shard: int | None = None):
        self.dir = os.path.join(path, "store")
        self.index = index
        self.shard = shard
        # seconds spent rebuilding posting layouts on load
        self.layout_seconds = 0.0
        os.makedirs(self.dir, exist_ok=True)

    def _write_hook(self, phase: str, partial=None) -> None:
        faults.on_storage_write("store", phase, index=self.index,
                                shard=self.shard, partial=partial)

    def _read_hook(self, phase: str, path: str) -> None:
        faults.on_storage_read("store", phase, path, index=self.index,
                               shard=self.shard)

    # -- segment IO --------------------------------------------------------
    def _stem_paths(self, stem: str) -> tuple[str, str]:
        return (os.path.join(self.dir, f"{stem}.npz"),
                os.path.join(self.dir, f"{stem}.meta.json"))

    def seg_stems_on_disk(self) -> set[str]:
        """Every segment-file stem present, from either half of the pair
        (crash residue may have only one)."""
        out = set()
        for name in os.listdir(self.dir):
            if not name.startswith("seg_"):
                continue
            if name.endswith(".meta.json"):
                out.add(name[: -len(".meta.json")])
            elif name.endswith(".npz") and not name.endswith(".tmp.npz"):
                out.add(name[: -len(".npz")])
        return out

    def save_segment(self, seg: Segment, live: np.ndarray | None = None,
                     suffix: int | None = None) -> str:
        """Write one segment's file pair and return its stem. The npz and
        meta keys are the reference's."""
        arrays: dict[str, np.ndarray] = {
            "versions": seg.versions,
            "live": (live if live is not None
                     else np.ones(seg.capacity, bool)),
        }
        meta: dict = {"seg_id": seg.seg_id, "num_docs": seg.num_docs,
                      "capacity": seg.capacity, "ids": seg.ids,
                      "text": {}, "keywords": {}, "numerics": {},
                      "vectors": []}
        if seg.delta_parent is not None:
            # a flushed delta reloads as the delta (same cache keys)
            meta["delta_parent"] = seg.delta_parent
            meta["delta_epoch"] = int(seg.delta_epoch)
        blob = b"".join(seg.sources)
        offsets = np.zeros(len(seg.sources) + 1, dtype=np.int64)
        np.cumsum([len(s) for s in seg.sources], out=offsets[1:])
        arrays["src_blob"] = np.frombuffer(blob, dtype=np.uint8)
        arrays["src_offsets"] = offsets
        for name, pf in seg.text.items():
            key = f"text__{name}"
            arrays[f"{key}__df"] = pf.df
            arrays[f"{key}__indptr"] = pf.indptr
            arrays[f"{key}__doc_ids"] = pf.doc_ids
            arrays[f"{key}__tfs"] = pf.tfs
            arrays[f"{key}__doc_len"] = pf.doc_len
            # a compacted base's impacts came from its source segments'
            # field stats and cannot be recomputed from its own: persist
            if seg.impacts_preserved:
                arrays[f"{key}__imps"] = extract_flat_impacts(pf)
            if pf.pos_data is not None:
                arrays[f"{key}__pos_data"] = pf.pos_data
                arrays[f"{key}__pos_indptr"] = pf.pos_indptr
            meta["text"][name] = {"terms": pf.terms,
                                  "doc_count": pf.doc_count,
                                  "avg_len": pf.avg_len}
        for name, kc in seg.keywords.items():
            if name in seg.text:
                continue
            key = f"kw__{name}"
            arrays[f"{key}__ords"] = kc.ords
            arrays[f"{key}__df"] = kc.df
            if kc.mv_ords is not None:
                arrays[f"{key}__mv_ords"] = kc.mv_ords
            meta["keywords"][name] = {"terms": kc.terms}
        for name, nc in seg.numerics.items():
            key = f"num__{name}"
            arrays[f"{key}__raw"] = nc.raw
            arrays[f"{key}__exists"] = nc.exists
            if nc.mv_raw is not None:
                arrays[f"{key}__mv_raw"] = nc.mv_raw
                arrays[f"{key}__mv_exists"] = nc.mv_exists
            meta["numerics"][name] = {"kind": nc.kind, "bias": nc.bias}
        for name, vc in seg.vectors.items():
            key = f"vec__{name}"
            arrays[f"{key}__values"] = vc.values
            arrays[f"{key}__exists"] = vc.exists
            meta["vectors"].append(name)
        # the IVF indexes are pack artifacts: a restart serves the same
        # clusters without re-clustering
        meta["ann"] = {}
        for name, ai in seg.ann.items():
            key = f"ann__{name}"
            for aname, arr in ai.arrays().items():
                arrays[f"{key}__{aname}"] = arr
            meta["ann"][name] = {"similarity": ai.similarity}
        meta["geos"] = []
        meta["completions"] = {}

        stem = (f"seg_{seg.seg_id}" if suffix is None
                else f"seg_{seg.seg_id}@{suffix}")
        npz_path, meta_path = self._stem_paths(stem)
        tmp = npz_path + ".tmp.npz"
        with open(tmp, "wb") as f:
            # uncompressed: a flush holds the engine's lock, and deflating
            # the columns of two 2^20-doc bases took a minute on the card's
            # host (PERF.md §6); np.load reads either form
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        # a crash before the replace leaves only the tmp file
        self._write_hook("seg_npz")
        os.replace(tmp, npz_path)
        # a crash here leaves a half pair under a stem no commit names
        self._write_hook("seg_meta")
        meta["sha256"] = _sha256(npz_path)
        _atomic_write(meta_path, json.dumps(meta).encode())
        return stem

    def load_segment(self, seg_id: str, verify: bool = True,
                     stem: str | None = None
                     ) -> tuple[Segment, np.ndarray]:
        """Load one segment, mapping every read failure (missing file,
        torn json, zip / zlib damage, checksum mismatch) to
        CorruptIndexError, except EIO, which stays an OSError. `stem`
        names the write-once file pair a commit references."""
        try:
            return self._load_segment_inner(seg_id, verify, stem)
        except NotImplementedError:
            raise
        except CorruptIndexError:
            durability.on_corruption_detected()
            raise
        except OSError as e:
            if e.errno == errno.EIO:
                raise   # an injected / real device error, not corruption
            durability.on_corruption_detected()
            raise CorruptIndexError(
                f"segment [{seg_id}] unreadable: {e}") from e
        except Exception as e:  # noqa: BLE001 — any decode damage
            durability.on_corruption_detected()
            raise CorruptIndexError(
                f"segment [{seg_id}] corrupt: {type(e).__name__}: {e}"
            ) from e

    def _load_segment_inner(self, seg_id: str, verify: bool = True,
                            stem: str | None = None
                            ) -> tuple[Segment, np.ndarray]:
        npz_path, meta_path = self._stem_paths(stem or f"seg_{seg_id}")
        self._read_hook("load_meta", meta_path)
        with open(meta_path) as f:
            meta = json.load(f)
        self._read_hook("load_npz", npz_path)
        if verify and _sha256(npz_path) != meta["sha256"]:
            raise CorruptIndexError(
                f"checksum mismatch for segment [{seg_id}]")
        z = np.load(npz_path)
        missing = _not_ported_columns(meta, z.files)
        if missing:
            raise NotImplementedError(
                f"segment [{seg_id}] holds columns the port does not "
                f"have: {', '.join(missing)}")
        blob = z["src_blob"].tobytes()
        offsets = z["src_offsets"]
        sources = [blob[offsets[i]: offsets[i + 1]]
                   for i in range(len(offsets) - 1)]
        cap = int(meta["capacity"])
        impacts_preserved = False
        text = {}
        for name, m in meta["text"].items():
            key = f"text__{name}"
            pf = PostingsField(
                name=name, terms=m["terms"],
                term_index={t: i for i, t in enumerate(m["terms"])},
                df=z[f"{key}__df"], indptr=z[f"{key}__indptr"],
                doc_ids=z[f"{key}__doc_ids"], tfs=z[f"{key}__tfs"],
                doc_len=z[f"{key}__doc_len"],
                doc_count=int(m["doc_count"]),
                avg_len=float(m["avg_len"]),
                pos_data=(z[f"{key}__pos_data"]
                          if f"{key}__pos_data" in z.files else None),
                pos_indptr=(z[f"{key}__pos_indptr"]
                            if f"{key}__pos_indptr" in z.files else None),
            )
            t0 = time.monotonic()
            if f"{key}__imps" in z.files:
                _pack_layout_host(pf, cap, z[f"{key}__imps"])
                impacts_preserved = True
            else:
                # builder-built: recompute under the field's own stats
                # (BM25 defaults, as the reference's load does)
                _pack_layout_host(pf, cap, _flat_impacts(pf))
            self.layout_seconds += time.monotonic() - t0
            text[name] = pf
        keywords = {}
        for name, m in meta["keywords"].items():
            key = f"kw__{name}"
            keywords[name] = KeywordColumn(
                name=name, terms=m["terms"],
                term_index={t: i for i, t in enumerate(m["terms"])},
                ords=z[f"{key}__ords"], df=z[f"{key}__df"],
                mv_ords=(z[f"{key}__mv_ords"]
                         if f"{key}__mv_ords" in z.files else None))
        numerics = {}
        for name, m in meta["numerics"].items():
            key = f"num__{name}"
            raw = z[f"{key}__raw"]
            bias = int(m.get("bias", 0))
            is_int = raw.dtype == np.int64
            nc = NumericColumn(
                name=name, kind=m["kind"],
                values=_device_vals(raw, m["kind"], bias, is_int),
                exists=z[f"{key}__exists"], raw=raw, bias=bias)
            if f"{key}__mv_raw" in z.files:
                nc.mv_raw = z[f"{key}__mv_raw"]
                nc.mv_exists = z[f"{key}__mv_exists"]
                nc.mv_values = _device_vals(nc.mv_raw, nc.kind, bias,
                                            nc.mv_raw.dtype == np.int64)
            numerics[name] = nc
        vectors = {}
        for name in meta.get("vectors", []):
            key = f"vec__{name}"
            vectors[name] = vector_column(name, z[f"{key}__values"],
                                          z[f"{key}__exists"])
        ann = {}
        for name, m in meta.get("ann", {}).items():
            key = f"ann__{name}"
            if name not in vectors or f"{key}__centroids" not in z.files:
                continue
            ann[name] = AnnIndex.from_arrays(
                m["similarity"],
                {a: z[f"{key}__{a}"]
                 for a in ("centroids", "radii", "members", "counts")})
        seg = Segment(
            seg_id=meta["seg_id"], num_docs=int(meta["num_docs"]),
            capacity=cap, ids=meta["ids"],
            id_map={t: i for i, t in enumerate(meta["ids"])},
            sources=sources, versions=z["versions"],
            text=text, keywords=keywords, numerics=numerics,
            vectors=vectors, ann=ann,
            delta_parent=meta.get("delta_parent"),
            delta_epoch=int(meta.get("delta_epoch", 0)),
            impacts_preserved=impacts_preserved,
        )
        if seg.delta_parent is not None:
            pad_delta_shapes(seg)   # restore the epoch-stable shapes
        return seg, z["live"]

    def delete_segment(self, seg_id: str) -> None:
        """Remove every file pair of this segment id."""
        stems = {s for s in self.seg_stems_on_disk()
                 if s == f"seg_{seg_id}" or s.startswith(f"seg_{seg_id}@")}
        for stem in stems:
            for path in self._stem_paths(stem):
                try:
                    os.remove(path)
                except OSError:
                    pass

    # -- commit points -----------------------------------------------------
    def write_commit(self, generation: int, seg_ids: list[str],
                     extra: dict | None = None) -> None:
        commit = {"generation": generation, "segments": seg_ids,
                  **(extra or {})}
        commit["checksum"] = _commit_checksum(commit)
        # a crash before the replace leaves no new commit: recovery
        # serves the previous generation + translog replay
        self._write_hook("commit")
        _atomic_write(os.path.join(self.dir, f"commit_{generation}.json"),
                      json.dumps(commit).encode())
        # drop older commits, keeping the immediately previous one: the
        # salvage walk's fallback when the newest turns out torn
        gens = [g for g in self.commit_generations() if g != generation]
        self._write_hook("cleanup")
        for g in gens[1:]:   # newest first; keep gens[0]
            try:
                os.remove(os.path.join(self.dir, f"commit_{g}.json"))
            except OSError:
                pass

    def commit_generations(self) -> list[int]:
        """On-disk commit generations, newest first."""
        commits = []
        for name in os.listdir(self.dir):
            if name.startswith("commit_") and name.endswith(".json"):
                try:
                    commits.append(int(name[len("commit_"):-len(".json")]))
                except ValueError:
                    pass
        return sorted(commits, reverse=True)

    def read_commit(self, generation: int) -> dict:
        """Read one commit point; torn or bit-flipped files raise
        CorruptIndexError."""
        path = os.path.join(self.dir, f"commit_{generation}.json")
        self._read_hook("read_commit", path)
        try:
            with open(path) as f:
                commit = json.load(f)
        except OSError as e:
            if e.errno == errno.EIO:
                raise
            durability.on_corruption_detected()
            raise CorruptIndexError(
                f"commit [{generation}] unreadable: {e}") from e
        except ValueError as e:   # torn / garbage json
            durability.on_corruption_detected()
            raise CorruptIndexError(
                f"commit [{generation}] torn: {e}") from e
        if "checksum" in commit \
                and commit["checksum"] != _commit_checksum(commit):
            durability.on_corruption_detected()
            raise CorruptIndexError(
                f"commit [{generation}] checksum mismatch")
        return commit

    def _commit_stems_raw(self, generation: int) -> set[str] | None:
        """Stems one on-disk commit references, read without fault hooks
        or counting (retention bookkeeping). None when unreadable."""
        path = os.path.join(self.dir, f"commit_{generation}.json")
        try:
            with open(path) as f:
                commit = json.load(f)
        except Exception:  # noqa: BLE001 — unreadable holds nothing
            return None
        files = commit.get("files") or {}
        return {files.get(sid, f"seg_{sid}")
                for sid in commit.get("segments", ())}

    def referenced_stems(self) -> set[str]:
        """Stems referenced by every readable commit on disk: the
        retained previous commit's segment files survive cleanup too."""
        out: set[str] = set()
        for gen in self.commit_generations():
            stems = self._commit_stems_raw(gen)
            if stems is not None:
                out |= stems
        return out

    def cleanup_uncommitted(self, live_stems: set[str]) -> None:
        """Reclaim every segment file pair no commit on disk references
        (retired generations, crash residue) and stale .tmp files."""
        self._write_hook("cleanup")
        keep = set(live_stems) | self.referenced_stems()
        for stem in self.seg_stems_on_disk() - keep:
            for path in self._stem_paths(stem):
                try:
                    os.remove(path)
                except OSError:
                    pass
        for name in os.listdir(self.dir):
            if name.endswith((".tmp", ".tmp.npz")):
                try:
                    os.remove(os.path.join(self.dir, name))
                except OSError:
                    pass

    # -- corruption markers (ref: Store.markStoreCorrupted) ----------------
    def corruption_markers(self) -> list[str]:
        return sorted(n for n in os.listdir(self.dir)
                      if n.startswith(self.CORRUPTED_PREFIX))

    def corruption_marker(self) -> str | None:
        """Reason recorded by the first marker, or None when clean."""
        for name in self.corruption_markers():
            try:
                with open(os.path.join(self.dir, name)) as f:
                    return json.load(f).get("reason", "corrupted")
            except Exception:  # noqa: BLE001 — a torn marker still marks
                return "corrupted (unreadable marker)"
        return None

    def write_corruption_marker(self, reason: str) -> str:
        """Persist the containment decision; an existing marker stands."""
        existing = self.corruption_markers()
        if existing:
            return existing[0]
        name = f"{self.CORRUPTED_PREFIX}{uuid.uuid4().hex}"
        _atomic_write(os.path.join(self.dir, name),
                      json.dumps({"reason": reason}).encode())
        return name

    def clear_corruption_markers(self) -> None:
        for name in self.corruption_markers():
            try:
                os.remove(os.path.join(self.dir, name))
            except OSError:
                pass

    # -- integrity audit (index.shard.check_on_startup) --------------------
    def verify_integrity(self) -> dict:
        """Store audit without loading segments: corruption markers, the
        newest readable commit, and each committed segment's meta parse +
        sha256. Pure reads, no fault hooks. Returns {"clean",
        "segments_checked", "failures": [{"file", "reason"}]}."""
        failures: list[dict] = []
        marker = self.corruption_marker()
        if marker is not None:
            failures.append({"file": self.corruption_markers()[0],
                             "reason": f"corruption marker: {marker}"})
        gens = self.commit_generations()
        commit = None
        for gen in gens:
            path = os.path.join(self.dir, f"commit_{gen}.json")
            try:
                with open(path) as f:
                    c = json.load(f)
                if "checksum" in c and c["checksum"] != _commit_checksum(c):
                    raise ValueError("checksum mismatch")
                commit = c
                break
            except Exception as e:  # noqa: BLE001 — audit, not serve
                failures.append({"file": f"commit_{gen}.json",
                                 "reason": str(e)})
        if commit is None and gens:
            failures.append({"file": "commit",
                             "reason": "no readable commit point"})
        checked = 0
        files = (commit or {}).get("files") or {}
        for sid in (commit or {}).get("segments", ()):
            checked += 1
            stem = files.get(sid, f"seg_{sid}")
            npz_path, meta_path = self._stem_paths(stem)
            try:
                with open(meta_path) as f:
                    meta = json.load(f)
                if _sha256(npz_path) != meta["sha256"]:
                    raise ValueError("sha256 mismatch")
            except Exception as e:  # noqa: BLE001 — audit, not serve
                failures.append({"file": stem, "reason": str(e)})
        return {"clean": not failures, "segments_checked": checked,
                "failures": failures}
