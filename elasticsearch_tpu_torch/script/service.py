"""ScriptService: spec parsing, stored scripts, column-bound accessors.

Counterpart of `elasticsearch_tpu/script/service.py` (ref:
script/ScriptService.java: inline, stored and file script sources with a
compile cache, which lives in expression.py, and the fielddata-backed
doc bindings of search/lookup/DocLookup.java). The device accessor binds
torch columns of `search/executor.device_arrays`; the registry and its
`scripts.json` form are the reference's, so either package reads the
other's stored scripts.
"""

from __future__ import annotations

import torch

from ..utils.errors import ScriptException, ScriptMissingError
from .expression import (CompiledScript, compile_script, DocAccessor,
                         FieldHandle)


def parse_script_spec(spec) -> tuple[str, dict]:
    """Normalize every accepted script shape -> (source, params).

    Accepted: "expr", {"script": ...} unwrapping, {"inline"/"source":
    "expr", "params": {...}, "lang": "expression"}, {"id": "stored"}.
    Ref: script request parsing in ScriptParameterParser.java.
    """
    if isinstance(spec, str):
        return spec, {}
    if not isinstance(spec, dict):
        raise ScriptException(f"invalid script spec {spec!r}")
    if "script" in spec and not any(k in spec for k in ("inline", "source", "id", "file")):
        inner = spec["script"]
        params = dict(spec.get("params") or {})
        if isinstance(inner, str):
            return inner, params
        src, p2 = parse_script_spec(inner)
        params.update(p2)
        return src, params
    src = spec.get("inline") or spec.get("source")
    if src is None and "id" in spec:
        src = ScriptService.instance().get_stored(spec["id"])
    if src is None and "file" in spec:
        src = ScriptService.instance().file_scripts.get(str(spec["file"]))
        if src is None:
            raise ScriptMissingError(str(spec["file"]))
    if src is None:
        raise ScriptException(f"no script source in {spec!r}")
    lang = spec.get("lang", "expression")
    if lang not in SUPPORTED_LANGS:
        # ref: ScriptService.java "script_lang not supported [x]"
        raise ScriptException(f"script_lang not supported [{lang}]")
    return src, dict(spec.get("params") or {})


# the groovy sources the reference's suites use are a subset the
# expression engine compiles directly (assignments, ctx._source,
# arithmetic, doc['f'].value) — see script/expression.py; "painless"
# rides the same subset. mustache = search templates.
SUPPORTED_LANGS = ("expression", "expressions", "painless", "groovy",
                   "mustache")


def numeric_param(name: str, val) -> float:
    """Device-executed scripts (script query/score/sort) carry params as
    f32 operands of the device program; non-numeric params are a 400."""
    try:
        return float(val)
    except (TypeError, ValueError):
        raise ScriptException(
            f"script params must be numeric for device execution; "
            f"[{name}] is {type(val).__name__}")


class ScriptService:
    """Stored-script registry (ES 2.0 kept these in the `.scripts`
    index — ScriptService.java indexed scripts). Process-global,
    shared by all nodes in this process; a node with a data path
    persists the registry to scripts.json and reloads it at startup
    (Node._load_stored_scripts)."""

    _instance: "ScriptService | None" = None

    def __init__(self):
        self.stored: dict[str, str] = {}
        # per-script lang + version (the .scripts doc metadata)
        self.meta: dict[str, dict] = {}
        # file scripts (ref: config/scripts dir, hot-reloaded via the
        # resource watcher — Node._watch_file_scripts)
        self.file_scripts: dict[str, str] = {}

    @classmethod
    def instance(cls) -> "ScriptService":
        if cls._instance is None:
            cls._instance = ScriptService()
        return cls._instance

    def put_stored(self, script_id: str, source: str) -> None:
        # stored entries are either expressions or mustache search
        # templates (ref: .scripts index holds both; template lang is
        # detected by shape — JSON/placeholder sources skip expression
        # validation)
        src = source.strip()
        if not (src.startswith("{") or "{{" in src):
            compile_script(source)  # validate at store time
        self.stored[script_id] = source
        cur = self.meta.get(script_id)
        self.meta[script_id] = (
            {"lang": cur["lang"], "version": cur["version"] + 1}
            if cur else {"lang": "expression", "version": 1})

    def get_stored(self, script_id: str) -> str:
        src = self.stored.get(script_id)
        if src is None:
            raise ScriptMissingError(script_id)
        return src

    def delete_stored(self, script_id: str) -> bool:
        self.meta.pop(script_id, None)
        return self.stored.pop(script_id, None) is not None

    # -- versioned indexed scripts (the .scripts-index analog) ---------
    # Ref: ScriptService.java indexed scripts ride normal index/get/
    # delete semantics — versions, version_type external/external_gte/
    # force — against the `.scripts` index.

    def put_versioned(self, script_id: str, source: str, lang: str,
                      version: int | None = None,
                      version_type: str = "internal") -> tuple[int, bool]:
        """-> (new version, created)."""
        if lang not in SUPPORTED_LANGS:
            raise ScriptException(f"script_lang not supported [{lang}]")
        src = source.strip()
        if lang != "mustache" and not (src.startswith("{")
                                       or "{{" in src):
            try:
                compile_script(source)
            except ScriptException as e:
                raise ScriptException(
                    f"Unable to parse [{source}] lang [{lang}]: {e}")
        # one id = one document; lang is its type attribute. A put under
        # a DIFFERENT lang replaces the doc with a fresh version stream
        # (so the write side agrees with get/delete, which treat a lang
        # mismatch as "document absent")
        meta = self.meta.get(script_id)
        cur = meta["version"] if meta and meta["lang"] == lang else None
        new_v = self._write_version(script_id, cur, version, version_type)
        self.stored[script_id] = source
        self.meta[script_id] = {"lang": lang, "version": new_v}
        return new_v, cur is None

    @staticmethod
    def _write_version(script_id: str, cur: int | None,
                       version: int | None, version_type: str) -> int:
        from ..utils.errors import VersionConflictError
        if version_type == "external":
            if version is None:
                raise ScriptException(
                    "version_type [external] requires an explicit version")
            if cur is not None and version <= cur:
                raise VersionConflictError(".scripts", script_id, cur,
                                           version)
            return version
        if version_type == "external_gte":
            if version is None:
                raise ScriptException(
                    "version_type [external_gte] requires an explicit "
                    "version")
            if cur is not None and version < cur:
                raise VersionConflictError(".scripts", script_id, cur,
                                           version)
            return version
        if version_type == "force":
            return version if version is not None else (cur or 0) + 1
        # internal: optimistic equality on the current version
        if version is not None and cur is not None and version != cur:
            raise VersionConflictError(".scripts", script_id, cur, version)
        return (cur or 0) + 1

    def check_read_version(self, script_id: str,
                           version: int | None,
                           version_type: str = "internal") -> None:
        from ..utils.errors import VersionConflictError
        if version is None or version_type == "force":
            return
        cur = self.meta.get(script_id, {}).get("version")
        if cur is None:
            return
        if version_type == "external_gte":
            # reads require current >= expected (VersionType.EXTERNAL_GTE
            # isVersionConflictForReads)
            if cur < version:
                raise VersionConflictError(".scripts", script_id, cur,
                                           version)
        elif version != cur:  # internal + external read = equality
            raise VersionConflictError(".scripts", script_id, cur, version)

    def get_meta(self, script_id: str) -> dict | None:
        """{"source", "lang", "version"} or None."""
        src = self.stored.get(script_id)
        if src is None:
            return None
        m = self.meta.get(script_id, {"lang": "expression", "version": 1})
        return {"source": src, **m}

    def delete_versioned(self, script_id: str,
                         version: int | None = None,
                         version_type: str = "internal") -> int | None:
        """Returns the tombstone version, or None when absent."""
        cur = self.meta.get(script_id, {}).get("version")
        if script_id not in self.stored:
            return None
        new_v = self._write_version(script_id, cur, version, version_type)
        self.stored.pop(script_id, None)
        self.meta.pop(script_id, None)
        return new_v


class SegmentDocAccessor(DocAccessor):
    """Host backend: doc['f'] for ONE doc of a host Segment.

    Numeric fields give float/int values; keyword fields the term
    string; missing fields an empty handle with value 0 (ES fielddata
    missing-as-0 expression semantics).
    """

    def __init__(self, segment, local_doc: int):
        self.seg = segment
        self.d = local_doc

    def get(self, field: str) -> FieldHandle:
        seg, d = self.seg, self.d
        nc = seg.numerics.get(field)
        if nc is not None:
            if not nc.exists[d]:
                return FieldHandle(0.0, True, 0)
            raw = nc.raw[d]
            v = int(raw) if nc.raw.dtype.kind == "i" else float(raw)
            if nc.kind == "date":
                v = int(raw)  # epoch millis, like doc['date'].value in ES
            return FieldHandle(v, False, 1)
        kc = seg.keywords.get(field) or seg.keywords.get(f"{field}.keyword")
        if kc is not None:
            o = int(kc.ords[d])
            if o < 0:
                return FieldHandle("", True, 0)
            return FieldHandle(kc.terms[o], False, 1)
        gc = getattr(seg, "geos", {}).get(field) if hasattr(seg, "geos") else None
        if gc is not None and gc.exists[d]:
            return FieldHandle(None, False, 1, lat=float(gc.lat[d]),
                               lon=float(gc.lon[d]))
        return FieldHandle(0.0, True, 0)


class ColumnDocAccessor(DocAccessor):
    """Device backend: doc['f'] -> the WHOLE column as a [cap] f32
    tensor (broadcasts against [B, 1] params). Missing docs read 0.0 like
    Lucene-expressions bindings."""

    def __init__(self, seg_dev: dict, xp):
        self.seg = seg_dev
        self.xp = xp

    def get(self, field: str) -> FieldHandle:
        num = self.seg.get("num", {}).get(field)
        if num is not None:
            # script_vals = natural units (dates epoch-millis);
            # see executor.ensure_script_vals
            vals = num.get("script_vals", num["values"]).to(torch.float32)
            exists = num["exists"]
            return FieldHandle(torch.where(exists, vals, 0.0), ~exists,
                               rich=(exists, vals, 0.0))
        geo = self.seg.get("geo", {}).get(field)
        if geo is not None:
            return FieldHandle(None, ~geo["exists"],
                               lat=geo["lat"], lon=geo["lon"])
        # absent column: constant 0 / empty=True
        return FieldHandle(0.0, True)


def run_field_script(script: CompiledScript, segment, local_doc: int,
                     params: dict, score: float | None = None):
    """Evaluate a script host-side for one hit (script_fields, sort
    fallback). Returns a python value."""
    bindings = {}
    if score is not None:
        bindings["_score"] = score
    return script.run(doc=SegmentDocAccessor(segment, local_doc),
                      params=params, bindings=bindings)
