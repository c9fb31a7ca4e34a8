"""Aggregations: parse JSON -> agg specs, build device descs, reduce partials.

Counterpart of `elasticsearch_tpu/search/aggregations.py`: `terms` on
keyword fields, `date_histogram` / `histogram`, the metric kinds (`sum`,
`avg`, `min`, `max`, `value_count`, `stats`, `extended_stats`; over a
field or a `script`), `scripted_metric` (a map script summed per doc),
`cardinality` (exact below `precision_threshold`, the HLL++ sketch of
`ops/hll` above) and `percentiles` / `percentile_ranks` (a 2048-bin
device histogram, centroid interpolation), top-level or as
sub-aggregations where the reference takes them. The device part is the
desc tree that `search/executor.eval_aggs` interprets; per-segment
partial arrays are reduced host-side by numpy addition/min/max keyed on
shard-global ordinals or histogram bucket keys, and shards merge by
bucket KEY (HLL registers by elementwise max).

Derived bucket aggs (`filter`, `filters`, `range`, `date_range`,
`missing`, `global`, `top_hits`, `significant_terms`, and the scope
shifts `nested`, `reverse_nested`, `children`; DERIVED_KINDS) have no
device desc: the shard searcher runs each bucket as an auxiliary
filtered size-0 (top_hits: size-n) request through the same batched
executor (`ShardReader._apply_derived`; a scope shift's request runs
over the nested rows, their parents or a relation's children), whose
sub-aggregations of any kind recurse; their partials merge by bucket key
(`merge_derived`) and finalize by kind (`finalize_derived`).
`significant_terms` scores foreground against background term counts
with JLH, top-level or as a sub of `terms` (`apply_sig_subs`). The geo
aggs raise NotImplementedError.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass, field as dc_field

import numpy as np

from ..index.mapping import format_date_millis
from ..index.segment import Segment, next_pow2
from ..utils.errors import SearchParseError

METRIC_KINDS = ("avg", "sum", "min", "max", "stats", "extended_stats",
                "value_count")
# derived bucket aggs run as auxiliary filtered sub-requests over the
# same readers: each bucket IS a filtered query
DERIVED_KINDS = ("filter", "filters", "range", "date_range", "missing",
                 "global", "top_hits", "nested", "reverse_nested",
                 "children", "significant_terms")
# the scope-shifting derived aggs: one auxiliary request each, over the
# nested rows, back over their parents, or over a relation's children
SCOPE_KINDS = ("nested", "reverse_nested", "children")
_NOT_PORTED = ("geo_bounds", "geo_centroid", "geohash_grid")
_PCTL_BINS = 2048  # device histogram resolution for percentiles: bins
                   # with centroid interpolation (percentile_values)
DEFAULT_PERCENTS = (1.0, 5.0, 25.0, 50.0, 75.0, 95.0, 99.0)
_FIXED_UNITS_S = {
    "second": 1, "1s": 1, "minute": 60, "1m": 60, "hour": 3600, "1h": 3600,
    "day": 86400, "1d": 86400, "week": 604800, "1w": 604800,
}
_CALENDAR_UNITS = ("month", "1M", "quarter", "1q", "year", "1y")
_SUFFIX_S = {"s": 1, "m": 60, "h": 3600, "d": 86400, "w": 604800}


@dataclass
class AggSpec:
    name: str
    kind: str                       # terms | date_histogram | histogram | metric kinds
    field: str
    size: int = 10                  # terms bucket count returned
    interval: str | float | None = None
    min_doc_count: int = 1
    order: tuple[str, str] = ("_count", "desc")
    sub_metrics: list["AggSpec"] = dc_field(default_factory=list)
    fmt: str | None = None          # histogram key format pattern
    # derived kinds: [(bucket_key, filter_query_dict|None, extra_json)]
    buckets: list = dc_field(default_factory=list)
    mode: str = "and"               # and (filter query) | ignore_query
    percents: tuple = DEFAULT_PERCENTS
    precision_threshold: int = 3000  # cardinality: exact below, HLL above
    sub_raw: dict = dc_field(default_factory=dict)   # nested aggs, re-parsed
    top_hits_size: int = 3
    top_hits_source: object = True
    # significant_terms subs of a terms agg: {name: raw conf}, computed
    # host-side per bucket after the main program
    sig_subs: dict = dc_field(default_factory=dict)


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"aggregation [{kind}] is not yet ported to elasticsearch_tpu_torch")


def parse_aggs(body: dict | None) -> list[AggSpec]:
    """Parse the `aggs`/`aggregations` section of a search request."""
    if not body:
        return []
    specs = []
    for name, spec in body.items():
        if not isinstance(spec, dict):
            raise SearchParseError(f"aggregation [{name}] must be an object")
        sub = spec.get("aggs") or spec.get("aggregations") or {}
        kinds = [k for k in spec if k not in ("aggs", "aggregations", "meta")]
        if len(kinds) != 1:
            raise SearchParseError(f"aggregation [{name}] must define one type")
        kind = kinds[0]
        conf = spec[kind]
        if kind in _NOT_PORTED:
            raise _not_ported(kind)
        if kind in DERIVED_KINDS or kind in ("percentiles",
                                             "percentile_ranks"):
            specs.append(_parse_special(name, kind, conf, sub))
            continue
        if kind not in ("terms", "date_histogram", "histogram", "cardinality",
                        "scripted_metric", *METRIC_KINDS):
            raise SearchParseError(f"unknown aggregation type [{kind}]")
        order = ("_count", "desc")
        if kind == "terms" and isinstance(conf.get("order"), dict):
            ok, ov = next(iter(conf["order"].items()))
            order = (ok, str(ov).lower())
        raw_size = int(conf.get("size", 10) or 0)
        agg = AggSpec(
            name=name, kind=kind, field=conf.get("field"),
            # size 0 = "all buckets" (ES 2.x semantics)
            size=raw_size if raw_size > 0 else (1 << 31),
            interval=conf.get("interval"),
            min_doc_count=int(conf.get("min_doc_count", 1)),
            order=order,
        )
        if kind == "scripted_metric":
            # restricted scripted_metric (ref: metrics/scripted/
            # ScriptedMetricAggregator.java): map_script is a device
            # expression giving one number per doc; combine / reduce sum
            ms = conf.get("map_script")
            if ms is None:
                raise SearchParseError(
                    f"[scripted_metric] agg [{name}] requires [map_script]")
            agg.field = _script_field_tag(ms, conf.get("params"))
        elif agg.field is None and conf.get("script") is not None \
                and kind in METRIC_KINDS:
            # metric aggs over a script instead of a field (ref:
            # ValuesSourceParser script mode)
            agg.field = _script_field_tag(conf["script"],
                                          conf.get("params"))
        if agg.field is None:
            raise SearchParseError(f"aggregation [{name}] requires [field]")
        if kind == "terms" and sub:
            # significant_terms under terms runs as per-bucket aux
            # requests after the main program; strip it before the
            # metric-only sub parse
            sub = dict(sub)
            for sname in list(sub):
                sk = [k for k in sub[sname]
                      if k not in ("aggs", "aggregations", "meta")]
                if sk == ["significant_terms"]:
                    agg.sig_subs[sname] = sub.pop(sname)[
                        "significant_terms"]
        if kind == "histogram" and conf.get("format"):
            agg.fmt = str(conf["format"])
        if kind == "cardinality" and conf.get("precision_threshold") \
                is not None:
            agg.precision_threshold = int(conf["precision_threshold"])
        agg.sub_metrics.extend(parse_sub_metrics(name, sub).values())
        specs.append(agg)
    return specs


def _script_field_tag(script, params: dict | None) -> str:
    """A script and its (numeric) params as a pseudo field name, which
    keys the plan like a real column."""
    from ..script import parse_script_spec, compile_script
    from ..script.service import numeric_param
    src, sparams = parse_script_spec(script if isinstance(script, dict)
                                     else {"script": script})
    if params:
        sparams = {**sparams, **params}
    compile_script(src)  # surface parse errors at request time
    ptag = ",".join(f"{k}={numeric_param(k, v)}"
                    for k, v in sorted(sparams.items()))
    return f"_script\x00{src}\x00{ptag}"


def _range_key(frm, to) -> str:
    """ES range bucket keys: "a-b" with * for open ends."""
    return f"{frm if frm is not None else '*'}-{to if to is not None else '*'}"


def _parse_special(name: str, kind: str, conf, sub: dict) -> AggSpec:
    """Derived bucket aggs (see DERIVED_KINDS) and percentiles."""
    spec = AggSpec(name=name, kind=kind, field=None, sub_raw=dict(sub))
    if kind == "filter":
        spec.buckets = [(name, conf if conf else {"match_all": {}}, {})]
    elif kind == "filters":
        raw = conf.get("filters")
        if isinstance(raw, dict):
            spec.buckets = [(k, q, {}) for k, q in raw.items()]
        elif isinstance(raw, list):
            spec.buckets = [(f"_{i}", q, {}) for i, q in enumerate(raw)]
        else:
            raise SearchParseError(
                f"[filters] agg [{name}] requires [filters]")
    elif kind in ("range", "date_range"):
        field = conf.get("field")
        if field is None:
            raise SearchParseError(f"[{kind}] agg [{name}] requires [field]")
        spec.field = field
        for r in conf.get("ranges") or []:
            frm, to = r.get("from"), r.get("to")
            rq: dict = {}
            if frm is not None:
                rq["gte"] = frm
            if to is not None:
                rq["lt"] = to
            key = r.get("key") or _range_key(frm, to)
            spec.buckets.append((key, {"range": {field: rq}} if rq
                                 else {"exists": {"field": field}},
                                 {"from": frm, "to": to}))
        if not spec.buckets:
            raise SearchParseError(f"[{kind}] agg [{name}] requires [ranges]")
    elif kind == "missing":
        field = conf.get("field")
        if field is None:
            raise SearchParseError(f"[missing] agg [{name}] requires [field]")
        spec.field = field
        spec.buckets = [(name, {"bool": {"must_not": [
            {"exists": {"field": field}}]}}, {})]
    elif kind == "global":
        spec.buckets = [(name, None, {})]
        spec.mode = "ignore_query"
    elif kind == "nested":
        # ref: bucket/nested/NestedAggregator.java: the scope shifts to
        # the hidden block-join rows of `path`
        path = (conf or {}).get("path")
        if not path:
            raise SearchParseError(f"[nested] agg [{name}] requires [path]")
        spec.mode = f"nested:{path}"
        spec.buckets = [(name, None, {})]
    elif kind == "reverse_nested":
        # ref: bucket/nested/ReverseNestedAggregator.java: the scope
        # shifts back to the parents of the enclosing nested scope
        spec.mode = "reverse_nested"
        spec.buckets = [(name, None, {})]
    elif kind == "children":
        # ref: bucket/children/ParentToChildrenAggregator.java
        ctype = (conf or {}).get("type")
        if not ctype:
            raise SearchParseError(f"[children] agg [{name}] requires [type]")
        spec.mode = f"children:{ctype}"
        spec.buckets = [(name, None, {})]
    elif kind == "top_hits":
        spec.buckets = [(name, {"match_all": {}}, {})]
        spec.top_hits_size = int(conf.get("size", 3))
        spec.top_hits_source = conf.get("_source", True)
    elif kind == "percentiles":
        field = conf.get("field")
        if field is None:
            raise SearchParseError(
                f"[percentiles] agg [{name}] requires [field]")
        spec.field = field
        if conf.get("percents"):
            spec.percents = tuple(float(p) for p in conf["percents"])
    elif kind == "percentile_ranks":
        # same device histogram as percentiles, inverse interpolation
        field = conf.get("field")
        if field is None:
            raise SearchParseError(
                f"[percentile_ranks] agg [{name}] requires [field]")
        spec.field = field
        values = conf.get("values")
        if not values:
            raise SearchParseError(
                f"[percentile_ranks] agg [{name}] requires [values]")
        spec.percents = tuple(float(v) for v in values)
    elif kind == "significant_terms":
        # foreground (query) vs background (index) term frequencies via
        # two terms aux requests, scored with JLH
        field = conf.get("field")
        if field is None:
            raise SearchParseError(
                f"[significant_terms] agg [{name}] requires [field]")
        if sub:
            raise SearchParseError(
                f"[significant_terms] agg [{name}]: sub-aggregations are "
                f"not supported yet")
        spec.field = field
        spec.size = int(conf.get("size", 10) or 10)
        spec.min_doc_count = int(conf.get("min_doc_count", 3))
        spec.buckets = [("fg", None, {}), ("bg", None, {})]
        spec.sub_raw = {"__sig_terms": {
            "terms": {"field": field, "size": 10_000}}}
    return spec


def parse_sub_metrics(parent: str, sub: dict) -> dict[str, AggSpec]:
    out = {}
    for sname, sspec in sub.items():
        kinds = [k for k in sspec if k not in ("aggs", "aggregations", "meta")]
        if len(kinds) != 1:
            raise SearchParseError(
                f"sub-aggregation [{sname}] must define one type")
        kind = kinds[0]
        if kind in _NOT_PORTED:
            raise _not_ported(kind)
        if kind not in METRIC_KINDS:
            raise SearchParseError(
                f"sub-aggregation [{sname}] of [{parent}]: only metric "
                f"sub-aggregations are supported at this level, got [{kind}]")
        out[sname] = AggSpec(name=sname, kind=kind,
                             field=sspec[kind].get("field"))
    return out


def parse_interval_seconds(interval) -> int | None:
    """Fixed interval in seconds, or None if it's a calendar interval."""
    if interval is None:
        raise SearchParseError("date_histogram requires [interval]")
    if isinstance(interval, (int, float)):
        return max(int(interval) // 1000, 1)  # bare numbers are millis
    s = str(interval)
    if s in _CALENDAR_UNITS:
        return None
    if s in _FIXED_UNITS_S:
        return _FIXED_UNITS_S[s]
    unit = s[-1]
    if unit in _SUFFIX_S:
        try:
            return max(int(float(s[:-1]) * _SUFFIX_S[unit]), 1)
        except ValueError:
            pass
    if s.endswith("ms"):
        try:
            return max(int(float(s[:-2]) / 1000.0), 1)
        except ValueError:
            pass
    raise SearchParseError(
        f"failed to parse date_histogram interval [{interval}]")


def calendar_edges(min_s: int, max_s: int, unit: str) -> np.ndarray:
    """Bucket edges (epoch seconds) for calendar intervals month/quarter/year."""
    months = {"month": 1, "1M": 1, "quarter": 3, "1q": 3, "year": 12,
              "1y": 12}[unit]
    start = _dt.datetime.fromtimestamp(min_s, _dt.timezone.utc)
    start = start.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
    if months == 3:
        start = start.replace(month=((start.month - 1) // 3) * 3 + 1)
    elif months == 12:
        start = start.replace(month=1)
    edges = []
    cur = start
    while True:
        edges.append(int(cur.timestamp()))
        if cur.timestamp() > max_s:
            break
        month0 = cur.month - 1 + months
        cur = cur.replace(year=cur.year + month0 // 12, month=month0 % 12 + 1)
    return np.asarray(edges, dtype=np.int64)


# ---------------------------------------------------------------------------
# Device desc construction (shard-level statics shared by all its segments)
# ---------------------------------------------------------------------------


class ShardAggContext:
    """Builds the static agg desc + per-segment params for one shard view:
    shard-global keyword ordinals and histogram extents keep every
    segment's partial arrays aligned. `device` is where the executor
    keeps the sorted agg layouts it uploads."""

    def __init__(self, segments: list[Segment],
                 global_ords: dict[str, tuple[list[str], list[np.ndarray]]],
                 device):
        self.segments = segments
        self.global_ords = global_ords  # field -> (terms, seg2global per segment)
        self.device = device
        self.edges: dict[str, np.ndarray] = {}       # agg name -> bucket edges
        self.origins: dict[str, tuple[int | float, int | float, int]] = {}
        # date_histogram column unit: DATE columns hold epoch seconds;
        # other numeric columns are epoch millis. Partial keys are always
        # normalized to millis so shards with different mappings merge.
        self.date_unit: dict[str, int] = {}          # agg name -> 1000 (s) | 1 (ms)
        # cardinality aggs that switched to the HLL++ sketch (the
        # precision_threshold switchover)
        self.hll_names: set[str] = set()

    def _is_date_column(self, field: str) -> bool:
        for seg in self.segments:
            nc = seg.numerics.get(field)
            if nc is not None:
                return nc.kind == "date"
        return True  # no data: assume proper date mapping (seconds unit)

    def _ensure_num_sorted_all(self, field: str) -> None:
        from .executor import ensure_num_sorted
        for seg in self.segments:
            ensure_num_sorted(seg, field, self.device)

    def _extent(self, field: str) -> tuple[float, float, bool]:
        lo, hi, any_vals = np.inf, -np.inf, False
        is_int = True
        for seg in self.segments:
            nc = seg.numerics.get(field)
            if nc is None:
                continue
            is_int = nc.values.dtype == np.int32
            cache = getattr(seg, "_extent_cache", None)
            if cache is None:
                cache = {}
                seg._extent_cache = cache  # type: ignore[attr-defined]
            ext = cache.get(field, "miss")
            if ext == "miss":
                n = seg.num_docs
                if nc.mv_values is not None:
                    vals = nc.mv_values[nc.mv_exists]
                elif nc.exists[:n].all():
                    vals = nc.values[:n]
                else:
                    vals = nc.values[: seg.capacity][nc.exists]
                ext = ((float(vals.min()), float(vals.max()))
                       if vals.size else None)
                cache[field] = ext
            if ext is None:
                continue
            any_vals = True
            lo = min(lo, ext[0])
            hi = max(hi, ext[1])
        if not any_vals:
            lo = hi = 0.0
        return lo, hi, is_int

    def build(self, specs: list[AggSpec]) -> tuple[tuple, list[tuple]]:
        """Returns (agg_desc, per-segment agg_params list)."""
        descs: list[tuple] = []
        per_seg: list[list] = [[] for _ in self.segments]
        for spec in specs:
            subs = tuple((s.name, s.field, s.kind) for s in spec.sub_metrics)
            if spec.kind == "terms":
                terms, seg_maps = self.global_ords[spec.field]
                n_global = next_pow2(len(terms), floor=1)
                # device-side shard_size cut for high-cardinality
                # count-ordered requests
                top_s = 0
                if spec.size < (1 << 30) \
                        and spec.order[0] in ("_count", "doc_count") \
                        and spec.order[1] == "desc":
                    shard_size = int(spec.size * 1.5) + 10
                    if n_global > 2048 and shard_size * 4 < n_global:
                        top_s = shard_size
                descs.append((spec.name, ("terms_kw", spec.field,
                                          n_global, subs, top_s)))
                from .executor import ensure_kw_sorted
                for seg in self.segments:
                    if spec.field in seg.keywords \
                            and seg.keywords[spec.field].mv_ords is None:
                        ensure_kw_sorted(seg, spec.field, self.device)
                for i in range(len(self.segments)):
                    sm = seg_maps[i]
                    inv = np.full(n_global, -1, dtype=np.int32)
                    inv[sm] = np.arange(len(sm), dtype=np.int32)
                    per_seg[i].append((sm, inv))
            elif spec.kind in ("date_histogram", "histogram"):
                lo, hi, is_int = self._extent(spec.field)
                if spec.kind == "date_histogram":
                    fixed = parse_interval_seconds(spec.interval)
                    unit = 1000 if self._is_date_column(spec.field) else 1
                    self.date_unit[spec.name] = unit
                    if fixed is not None and unit == 1:
                        fixed = fixed * 1000  # column is millis: scale interval
                else:
                    fixed = float(spec.interval)
                    if fixed <= 0:
                        raise SearchParseError(
                            "histogram interval must be > 0")
                if fixed is not None:
                    origin = np.floor(lo / fixed) * fixed
                    n_raw = (int((hi - origin) // fixed) + 1
                             if hi >= origin else 1)
                    n_buckets = next_pow2(n_raw, floor=1)
                    origin = int(origin) if is_int else origin
                    self.origins[spec.name] = (origin, fixed, n_raw)
                    descs.append((spec.name, ("hist_fixed", spec.field,
                                              n_buckets, subs)))
                    self._ensure_num_sorted_all(spec.field)
                    for i in range(len(self.segments)):
                        per_seg[i].append((np.asarray(origin),
                                           np.asarray(fixed)))
                else:  # calendar interval
                    unit = self.date_unit.get(spec.name, 1000)
                    lo_s = int(lo) if unit == 1000 else int(lo) // 1000
                    hi_s = int(hi) if unit == 1000 else int(hi) // 1000
                    edges = calendar_edges(lo_s, hi_s, str(spec.interval))
                    if unit == 1:
                        edges = edges * 1000  # back to column unit (millis)
                    self.edges[spec.name] = edges
                    n_raw = len(edges) - 1
                    n_buckets = next_pow2(max(n_raw, 1), floor=1)
                    padded = np.full(n_buckets + 1, np.iinfo(np.int32).max,
                                     np.int64)
                    padded[: len(edges)] = edges
                    descs.append((spec.name, ("hist_edges", spec.field,
                                              n_buckets, subs)))
                    for i in range(len(self.segments)):
                        per_seg[i].append((padded.astype(np.int32),))
            elif spec.kind == "value_count":
                kind = "value_count_kw" if any(
                    spec.field in s.keywords for s in self.segments) \
                    else "value_count_num"
                descs.append((spec.name, (kind, spec.field)))
                for i in range(len(self.segments)):
                    per_seg[i].append(())
            elif spec.kind == "cardinality":
                terms, seg_maps = self.global_ords[spec.field]
                if len(terms) > spec.precision_threshold:
                    # high cardinality: HLL++ sketch registers instead of
                    # an O(cardinality) exact count array
                    from ..ops.hll import M, term_registers
                    g_reg, g_rank = term_registers(terms)
                    self.hll_names.add(spec.name)
                    descs.append((spec.name,
                                  ("cardinality_hll", spec.field, M)))
                    for i in range(len(self.segments)):
                        safe = np.clip(seg_maps[i], 0,
                                       max(len(terms) - 1, 0))
                        per_seg[i].append((g_reg[safe], g_rank[safe]))
                else:
                    n_global = next_pow2(len(terms), floor=1)
                    descs.append((spec.name, ("cardinality_kw", spec.field,
                                              n_global)))
                    for i in range(len(self.segments)):
                        per_seg[i].append((seg_maps[i],))
            elif spec.kind in ("percentiles", "percentile_ranks"):
                lo, hi, _ = self._extent(spec.field)
                width = max((hi - lo) / _PCTL_BINS, 1e-9)
                self.origins[spec.name] = (lo, width, _PCTL_BINS)
                descs.append((spec.name, ("pctl", spec.field, _PCTL_BINS)))
                self._ensure_num_sorted_all(spec.field)
                for i in range(len(self.segments)):
                    per_seg[i].append((np.float32(lo), np.float32(width)))
            elif spec.kind in METRIC_KINDS or spec.kind == "scripted_metric":
                if spec.field.startswith("_script\x00"):
                    tag = spec.field.split("\x00", 1)[1]
                    from ..script import compile_script
                    from .executor import ensure_script_vals
                    cs = compile_script(tag.split("\x00", 1)[0])
                    for seg in self.segments:
                        ensure_script_vals(seg, cs.fields, self.device)
                    descs.append((spec.name, ("stats_script", tag)))
                else:
                    descs.append((spec.name, ("stats", spec.field)))
                for i in range(len(self.segments)):
                    per_seg[i].append(())
            elif spec.kind in DERIVED_KINDS:
                raise SearchParseError(
                    f"derived aggregation [{spec.kind}] cannot build a "
                    f"device desc (route through the reader)")
            else:
                raise _not_ported(spec.kind)
        return tuple(descs), [tuple(p) for p in per_seg]


# ---------------------------------------------------------------------------
# Reduce: per-segment partial arrays -> response JSON (per batched query b)
# ---------------------------------------------------------------------------


def _acc(partials: list[dict], name: str, key: str, how: str = "sum"):
    arrays = [p[name][key] for p in partials if name in p]
    out = np.asarray(arrays[0], dtype=np.float64).copy()
    for a in arrays[1:]:
        a = np.asarray(a, dtype=np.float64)
        if how == "sum":
            out += a
        elif how == "min":
            out = np.minimum(out, a)
        elif how == "max":
            out = np.maximum(out, a)
    return out


def shard_partials(specs: list[AggSpec], ctx: ShardAggContext,
                   partials: list[dict], batch: int) -> list[dict]:
    """Reduce per-SEGMENT arrays into per-query SHARD partials keyed by
    bucket key (term string / epoch millis / numeric key):
      terms:             {"buckets": {key: {"count", "subs"}}, "total"}
      (date_)histogram:  {"buckets": {key: {"count", "subs"}}}
      metrics:           {"stats": {count,sum,min,max[,sum_sq]}}"""
    out: list[dict] = [dict() for _ in range(batch)]
    for spec in specs:
        name = spec.name
        if spec.kind == "cardinality" and name in ctx.hll_names:
            regs = _acc(partials, name, "max", how="max")     # [B, M]
            for b in range(batch):
                out[b][name] = {"hll": regs[b]}
            continue
        if spec.kind == "terms" and any(
                "top_idx" in p.get(name, {}) for p in partials):
            # device-compressed per-segment tops (executor._compress_topk)
            terms, _ = ctx.global_ords[spec.field]
            seg_entries = [p[name] for p in partials if name in p]
            sub_keys = [k for k in seg_entries[0] if k.startswith("sub\x00")]
            for b in range(batch):
                buckets: dict = {}
                total = 0.0
                for e in seg_entries:
                    idx = np.asarray(e["top_idx"][b])
                    cnt = np.asarray(e["top_counts"][b])
                    total += float(np.asarray(e["total"][b])[0])
                    for j in range(len(idx)):
                        c = float(cnt[j])
                        if c <= 0:
                            continue
                        g = int(idx[j])
                        if g >= len(terms):
                            continue
                        cur = buckets.setdefault(terms[g],
                                                 {"count": 0, "subs": {}})
                        cur["count"] += int(round(c))
                        for sk in sub_keys:
                            _, mname, skey = sk.split("\x00")
                            st = cur["subs"].setdefault(mname, {})
                            v = float(np.asarray(e[sk][b][j]))
                            if skey == "min":
                                st[skey] = min(st.get(skey, v), v)
                            elif skey == "max":
                                st[skey] = max(st.get(skey, v), v)
                            else:
                                st[skey] = st.get(skey, 0.0) + v
                out[b][name] = {"buckets": buckets, "total": total}
            continue
        if spec.kind in ("terms", "cardinality"):
            terms, _ = ctx.global_ords[spec.field]
            counts = _acc(partials, name, "counts")           # [B, G]
            sub_acc = _reduce_subs(spec, partials, name)
            shard_size = None
            # cardinality stays exact: no shard-level truncation
            if spec.kind == "terms" and spec.size < (1 << 30):
                shard_size = int(spec.size * 1.5) + 10
            for b in range(batch):
                row = counts[b][: len(terms)]
                nz = np.nonzero(row > 0)[0]
                total = float(row.sum())
                if shard_size is not None and len(nz) > shard_size:
                    okey, odir = spec.order
                    if okey in ("_count", "doc_count"):
                        sel = nz[np.argpartition(-row[nz],
                                                 shard_size)[:shard_size]]
                    elif okey == "_term":
                        sel = (nz[-shard_size:] if odir == "desc"
                               else nz[:shard_size])
                    else:
                        sel = nz
                    nz = np.sort(sel)
                buckets = {}
                for g in nz:
                    buckets[terms[g]] = {
                        "count": int(row[g]),
                        "subs": _sub_stats(spec, sub_acc, b, g)}
                entry = {"buckets": buckets}
                if spec.kind == "terms":
                    entry["total"] = total
                out[b][name] = entry
        elif spec.kind in ("date_histogram", "histogram"):
            counts = _acc(partials, name, "counts")
            sub_acc = _reduce_subs(spec, partials, name)
            if name in ctx.origins:
                origin, interval, n_raw = ctx.origins[name]
                keys = [origin + i * interval for i in range(n_raw)]
            else:
                edges = ctx.edges[name]
                keys = [int(e) for e in edges[:-1]]
                n_raw = len(keys)
            if spec.kind == "date_histogram":
                unit = ctx.date_unit.get(name, 1000)
                keys = [int(k) * unit for k in keys]  # normalize to millis
            for b in range(batch):
                buckets = {}
                for i in range(n_raw):
                    c = int(counts[b][i])
                    if c > 0:
                        buckets[keys[i]] = {
                            "count": c,
                            "subs": _sub_stats(spec, sub_acc, b, i)}
                out[b][name] = {"buckets": buckets}
        elif spec.kind == "value_count":
            counts = _acc(partials, name, "count")
            for b in range(batch):
                out[b][name] = {"stats": {"count": float(counts[b])}}
        elif spec.kind in ("percentiles", "percentile_ranks"):
            counts = _acc(partials, name, "counts")      # [B, bins]
            lo, width, n_bins = ctx.origins[name]
            centers = [lo + (i + 0.5) * width for i in range(n_bins)]
            for b in range(batch):
                points = {}
                row = counts[b]
                for i in np.nonzero(row > 0)[0]:
                    points[centers[int(i)]] = points.get(
                        centers[int(i)], 0.0) + float(row[int(i)])
                out[b][name] = {"points": points}
        else:
            stats = {
                "count": _acc(partials, name, "count"),
                "sum": _acc(partials, name, "sum"),
                "min": _acc(partials, name, "min", "min"),
                "max": _acc(partials, name, "max", "max"),
            }
            if spec.kind == "extended_stats":
                stats["sum_sq"] = _acc(partials, name, "sum_sq")
            for b in range(batch):
                out[b][name] = {"stats": {k: float(v[b])
                                          for k, v in stats.items()}}
    return out


def _sub_stats(spec: AggSpec, sub_acc: dict, b: int, g: int) -> dict:
    return {sm.name: {k: float(v[b][g]) for k, v in sub_acc[sm.name].items()}
            for sm in spec.sub_metrics}


def merge_shard_partials(specs: list[AggSpec], parts: list[dict]) -> dict:
    """Merge shard partials for ONE query (InternalAggregation.reduce)."""
    merged: dict = {}
    for spec in specs:
        name = spec.name
        entries = [p[name] for p in parts if name in p]
        if not entries:
            continue
        if any("hll" in e for e in entries):
            # shards may disagree on exact-vs-sketch (a per-shard term
            # count decision): exact bucket partials convert to sketch
            # registers (their keys hashed), as HyperLogLogPlusPlus
            # upgrades linear counting on merge
            from ..ops.hll import M as _HLL_M, term_registers
            regs = np.zeros(_HLL_M, dtype=np.float64)
            for e in entries:
                if "hll" in e:
                    regs = np.maximum(regs, np.asarray(e["hll"]))
                else:
                    keys = list(e["buckets"])
                    r_idx, r_rank = term_registers(keys, memo=False)
                    if keys:
                        np.maximum.at(regs, r_idx[: len(keys)],
                                      r_rank[: len(keys)])
            merged[name] = {"hll": regs}
        elif "points" in entries[0]:
            points: dict = {}
            for e in entries:
                for c, n in e["points"].items():
                    points[c] = points.get(c, 0.0) + n
            merged[name] = {"points": points}
        elif "derived" in entries[0]:
            merged[name] = {"derived": merge_derived(spec, entries)}
        elif "buckets" in entries[0]:
            buckets: dict = {}
            for e in entries:
                for key, bk in e["buckets"].items():
                    cur = buckets.get(key)
                    if cur is None:
                        buckets[key] = {"count": bk["count"],
                                        "subs": {n: dict(s) for n, s
                                                 in bk["subs"].items()}}
                        continue
                    cur["count"] += bk["count"]
                    for n, s in bk["subs"].items():
                        tgt = cur["subs"][n]
                        for k, v in s.items():
                            if k == "min":
                                tgt[k] = min(tgt[k], v)
                            elif k == "max":
                                tgt[k] = max(tgt[k], v)
                            else:
                                tgt[k] += v
            merged[name] = {"buckets": buckets}
            if any("total" in e for e in entries):
                merged[name]["total"] = sum(e.get("total", 0.0)
                                            for e in entries)
        else:
            stats: dict = {}
            for e in entries:
                for k, v in e["stats"].items():
                    if k not in stats:
                        stats[k] = v
                    elif k.startswith("min"):
                        stats[k] = min(stats[k], v)
                    elif k.startswith("max"):
                        stats[k] = max(stats[k], v)
                    else:
                        stats[k] += v
            merged[name] = {"stats": stats}
    return merged


def merge_derived(spec: AggSpec, entries: list[dict]) -> dict:
    """Cross-shard reduce of a derived agg: counts sum, nested partials
    merge recursively, top hits re-rank."""
    nested = parse_aggs(spec.sub_raw)
    out: dict = {}
    for key, _q, _extra in spec.buckets:
        parts = [e["derived"][key] for e in entries
                 if key in e.get("derived", {})]
        if not parts:
            continue
        bucket = {"count": sum(p["count"] for p in parts)}
        if nested:
            bucket["sub"] = merge_shard_partials(
                nested, [p.get("sub", {}) for p in parts])
        hits = [h for p in parts for h in p.get("hits", [])]
        if hits or spec.kind == "top_hits":
            hits.sort(key=lambda h: -(h.get("_score") or 0.0))
            bucket["hits"] = hits[: spec.top_hits_size]
        out[key] = bucket
    return out


def finalize_derived(spec: AggSpec, merged_buckets: dict) -> dict:
    nested = parse_aggs(spec.sub_raw)

    def bucket_json(key):
        b = merged_buckets.get(key)
        if b is None:
            return {"doc_count": 0}
        out = {"doc_count": int(b["count"])}
        if nested:
            out.update(finalize_partials(nested, b.get("sub", {})))
        if "hits" in b:
            out["hits"] = {"total": int(b["count"]),
                           "hits": b["hits"]}
        return out

    if spec.kind == "significant_terms":
        def totals(key):
            b = merged_buckets.get(key)
            if b is None:
                return 0, []
            fin = finalize_partials(nested, b.get("sub", {}))
            return (int(b["count"]),
                    fin.get("__sig_terms", {}).get("buckets", []))

        fg_t, fg_b = totals("fg")
        bg_t, bg_b = totals("bg")
        return significant_buckets(spec, fg_t, fg_b, bg_t, bg_b)
    if spec.kind in ("filter", "missing", "global", *SCOPE_KINDS):
        key = spec.buckets[0][0]
        return bucket_json(key)
    if spec.kind == "top_hits":
        key = spec.buckets[0][0]
        b = merged_buckets.get(key) or {"count": 0, "hits": []}
        return {"hits": {"total": int(b["count"]),
                         "max_score": (b["hits"][0].get("_score")
                                       if b.get("hits") else None),
                         "hits": b.get("hits", [])}}
    if spec.kind == "filters":
        return {"buckets": {key: bucket_json(key)
                            for key, _q, _x in spec.buckets}}
    # range / date_range: ordered array with from/to echoes
    buckets = []
    for key, _q, extra in spec.buckets:
        bj = bucket_json(key)
        entry = {"key": key, **{k: v for k, v in extra.items()
                                if v is not None}, **bj}
        buckets.append(entry)
    return {"buckets": buckets}


def jlh_score(fg_count: float, fg_total: float, bg_count: float,
              bg_total: float) -> float:
    """JLH significance heuristic (ref: bucket/significant/heuristics/
    JLHScore.java): (fgPct - bgPct) * (fgPct / bgPct), 0 when not more
    frequent in the foreground."""
    if fg_total <= 0 or bg_total <= 0 or bg_count <= 0:
        return 0.0
    fg_pct = fg_count / fg_total
    bg_pct = bg_count / bg_total
    if fg_pct <= bg_pct:
        return 0.0
    return (fg_pct - bg_pct) * (fg_pct / bg_pct)


def apply_sig_subs(agg_specs, aggregations: dict, readers: list,
                   raw_query: dict | None = None,
                   search_ids=None) -> None:
    """Stitch significant_terms sub-aggs into parent terms buckets, for
    one reader (ShardReader) or a node's shards. Foreground = enclosing
    query AND bucket term: with a real query, `search_ids(query_dict) ->
    set[str]` gives the matching doc ids (capped by the caller) and
    sig_term_counts intersects with them."""
    for spec in agg_specs:
        subs = spec.sig_subs
        if spec.kind != "terms" or not subs:
            continue
        agg_out = (aggregations or {}).get(spec.name)
        if not agg_out:
            continue
        allowed = None
        if raw_query is not None and search_ids is not None \
                and raw_query != {"match_all": {}}:
            allowed = search_ids(raw_query)
        for sname, conf in subs.items():
            field = conf.get("field")
            sub_spec = AggSpec(
                name=sname, kind="significant_terms", field=field,
                size=int(conf.get("size", 10) or 10),
                min_doc_count=int(conf.get("min_doc_count", 3)))

            def summed(flt_value=None, _f=field):
                total = 0
                counts: dict = {}
                for reader in readers:
                    t, c = reader.sig_term_counts(
                        _f, spec.field if flt_value is not None else None,
                        flt_value,
                        allowed_ids=(allowed if flt_value is not None
                                     else None))
                    total += t
                    for k, v in c.items():
                        counts[k] = counts.get(k, 0) + v
                return total, [{"key": k, "doc_count": v}
                               for k, v in counts.items()]

            bg_total, bg_counts = summed()
            for bucket in agg_out.get("buckets", []):
                fg_total, fg_counts = summed(bucket["key"])
                bucket[sname] = significant_buckets(
                    sub_spec, fg_total, fg_counts, bg_total, bg_counts)


def significant_buckets(spec: AggSpec, fg_total: int, fg_buckets: list,
                        bg_total: int, bg_buckets: list) -> dict:
    """Foreground / background term counts -> significant-terms buckets
    ranked by JLH score."""
    bg_counts = {b["key"]: b["doc_count"] for b in bg_buckets}
    out = []
    for b in fg_buckets:
        fg_c = b["doc_count"]
        if fg_c < spec.min_doc_count:
            continue
        bg_c = bg_counts.get(b["key"], fg_c)
        score = jlh_score(fg_c, fg_total, bg_c, bg_total)
        if score <= 0:
            continue
        out.append({"key": b["key"], "doc_count": fg_c,
                    "score": score, "bg_count": bg_c})
    out.sort(key=lambda x: (-x["score"], x["key"]))
    return {"doc_count": fg_total, "buckets": out[: spec.size]}


def percentile_rank_values(points: dict, values: tuple) -> dict:
    """Inverse of percentile_values: % of observed weight at or below each
    value (ref: metrics/percentiles/PercentileRanks)."""
    items = sorted(points.items())
    total = sum(c for _, c in items)
    out = {}
    for v in values:
        key = str(float(v))
        if total == 0:
            out[key] = None
            continue
        below = sum(c for x, c in items if x <= v)
        out[key] = 100.0 * below / total
    return out


def percentile_values(points: dict, percents: tuple) -> dict:
    """Weighted points -> percentile values by t-digest-style centroid
    interpolation (each histogram bin acts as a centroid whose mass sits
    at its center; quantiles interpolate linearly between adjacent
    centroid mid-ranks — ref: metrics/percentiles/tdigest/
    TDigestState.quantile)."""
    if not points:
        return {str(p): None for p in percents}
    items = sorted(points.items())
    total = sum(c for _, c in items)
    # cumulative mid-rank of each centroid
    mids: list[tuple[float, float]] = []
    cum = 0.0
    for center, cnt in items:
        mids.append((cum + cnt / 2.0, float(center)))
        cum += cnt
    out = {}
    for p in percents:
        target = total * p / 100.0
        if target <= mids[0][0]:
            out[str(p)] = mids[0][1]
            continue
        if target >= mids[-1][0]:
            out[str(p)] = mids[-1][1]
            continue
        val = mids[-1][1]
        for j in range(1, len(mids)):
            r0, v0 = mids[j - 1]
            r1, v1 = mids[j]
            if target <= r1:
                frac = (target - r0) / (r1 - r0) if r1 > r0 else 0.0
                val = v0 + frac * (v1 - v0)
                break
        out[str(p)] = float(val)
    return out


def _decimal_format(pattern: str, value: float) -> str:
    """Java DecimalFormat subset for histogram `format` patterns."""
    import re as _re
    m = _re.search(r"[#0][#0,.]*", pattern)
    if not m:
        return pattern
    mask = m.group(0)
    decimals = len(mask.split(".", 1)[1]) if "." in mask else 0
    num = f"{value:.{decimals}f}"
    return pattern[: m.start()] + num + pattern[m.end():]


def _stats_json(kind: str, s: dict) -> dict:
    count = s.get("count", 0.0)
    if kind == "sum":
        return {"value": s.get("sum", 0.0)}
    if kind == "value_count":
        return {"value": int(count)}
    if kind == "min":
        v = s.get("min", np.inf)
        return {"value": None if np.isinf(v) else v}
    if kind == "max":
        v = s.get("max", -np.inf)
        return {"value": None if np.isinf(v) else v}
    if kind == "avg":
        return {"value": (s.get("sum", 0.0) / count) if count else None}
    out = {
        "count": int(count),
        "min": None if count == 0 else s.get("min"),
        "max": None if count == 0 else s.get("max"),
        "sum": s.get("sum", 0.0),
        "avg": (s.get("sum", 0.0) / count) if count else None,
    }
    if kind == "extended_stats":
        ssq = s.get("sum_sq", 0.0)
        out["sum_of_squares"] = ssq
        if count:
            mean = out["avg"]
            var = max(ssq / count - mean * mean, 0.0)
            out["variance"] = var
            out["std_deviation"] = float(np.sqrt(var))
        else:
            out["variance"] = None
            out["std_deviation"] = None
    return out


def finalize_partials(specs: list[AggSpec], merged: dict) -> dict:
    """Merged partials -> response JSON (ordering, size, min_doc_count)."""
    response: dict = {}
    for spec in specs:
        name = spec.name
        if name not in merged:
            if spec.kind == "terms":
                response[name] = {"doc_count_error_upper_bound": 0,
                                  "sum_other_doc_count": 0, "buckets": []}
            elif spec.kind in ("date_histogram", "histogram"):
                response[name] = {"buckets": []}
            elif spec.kind in DERIVED_KINDS:
                response[name] = finalize_derived(spec, {})
            elif spec.kind == "cardinality":
                response[name] = {"value": 0}
            elif spec.kind == "percentiles":
                response[name] = {"values": percentile_values(
                    {}, spec.percents)}
            elif spec.kind == "percentile_ranks":
                response[name] = {"values": percentile_rank_values(
                    {}, spec.percents)}
            elif spec.kind == "scripted_metric":
                response[name] = {"value": 0.0}
            else:
                response[name] = _stats_json(spec.kind, {"count": 0.0})
            continue
        entry = merged[name]
        if spec.kind == "percentiles":
            response[name] = {"values": percentile_values(
                entry["points"], spec.percents)}
        elif spec.kind == "percentile_ranks":
            response[name] = {"values": percentile_rank_values(
                entry["points"], spec.percents)}
        elif spec.kind == "scripted_metric":
            response[name] = {"value": entry["stats"].get("sum", 0.0)}
        elif spec.kind == "cardinality":
            if "hll" in entry:
                from ..ops.hll import estimate
                response[name] = {"value": int(round(
                    estimate(entry["hll"])))}
            else:
                response[name] = {"value": len(entry["buckets"])}
        elif spec.kind in DERIVED_KINDS:
            response[name] = finalize_derived(spec, entry["derived"])
        elif spec.kind == "terms":
            items = [(key, bk) for key, bk in entry["buckets"].items()
                     if bk["count"] >= max(spec.min_doc_count, 1)]
            order_key, order_dir = spec.order
            reverse = order_dir == "desc"
            if order_key == "_term":
                items.sort(key=lambda kv: kv[0], reverse=reverse)
            elif order_key in ("_count", "doc_count"):
                items.sort(key=lambda kv: kv[0])
                items.sort(key=lambda kv: kv[1]["count"], reverse=reverse)
            else:
                sub_name = order_key.split(".")[0]
                sub = next((s for s in spec.sub_metrics
                            if s.name == sub_name), None)
                if sub is None:
                    raise SearchParseError(
                        f"unknown terms order key [{order_key}]")
                items.sort(key=lambda kv: kv[0])
                items.sort(key=lambda kv: _stats_json(
                    sub.kind, kv[1]["subs"][sub.name]).get("value") or 0.0,
                    reverse=reverse)
            total = int(entry.get("total",
                                  sum(bk["count"] for _, bk
                                      in entry["buckets"].items())))
            buckets = []
            for key, bk in items[: spec.size]:
                bucket = {"key": key, "doc_count": bk["count"]}
                for sm in spec.sub_metrics:
                    bucket[sm.name] = _stats_json(sm.kind,
                                                  bk["subs"][sm.name])
                buckets.append(bucket)
            response[name] = {
                "doc_count_error_upper_bound": 0,
                "sum_other_doc_count": total - sum(b["doc_count"]
                                                   for b in buckets),
                "buckets": buckets,
            }
        elif spec.kind in ("date_histogram", "histogram"):
            is_date = spec.kind == "date_histogram"
            buckets = []
            for key in sorted(entry["buckets"]):
                bk = entry["buckets"][key]
                if bk["count"] < spec.min_doc_count:
                    continue
                if is_date:
                    millis = int(key)  # partial keys are normalized millis
                    bucket = {"key": millis,
                              "key_as_string": format_date_millis(millis),
                              "doc_count": bk["count"]}
                else:
                    bucket = {"key": float(key), "doc_count": bk["count"]}
                    if spec.fmt:
                        bucket["key_as_string"] = _decimal_format(
                            spec.fmt, float(key))
                for sm in spec.sub_metrics:
                    bucket[sm.name] = _stats_json(sm.kind,
                                                  bk["subs"][sm.name])
                buckets.append(bucket)
            response[name] = {"buckets": buckets}
        else:
            response[name] = _stats_json(spec.kind, entry["stats"])
    return response


def _reduce_subs(spec: AggSpec, partials: list[dict], name: str) -> dict:
    out = {}
    for sm in spec.sub_metrics:
        entry = {}
        sample = partials[0][name].get(sm.name, {})
        for key in sample:
            how = "min" if key == "min" else "max" if key == "max" else "sum"
            arrays = [p[name][sm.name][key] for p in partials]
            acc = np.asarray(arrays[0], dtype=np.float64).copy()
            for a in arrays[1:]:
                a = np.asarray(a, dtype=np.float64)
                acc = acc + a if how == "sum" else (
                    np.minimum(acc, a) if how == "min" else np.maximum(acc, a))
            entry[key] = acc
        out[sm.name] = entry
    return out
