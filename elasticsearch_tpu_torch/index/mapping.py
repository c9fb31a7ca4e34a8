"""Document mapping: schema, field types, document parsing (host-only).

Counterpart of `elasticsearch_tpu/index/mapping.py`, trimmed to the
field types this slice of the port serves: `text`, `keyword`, the
integer and float numerics, `date`, `boolean`, `ip` and `dense_vector`
(`dims`, `similarity` cosine | dot_product | l2_norm, cosine when
unset). A parsed document becomes columnar contributions (term lists per
text field, values per keyword/numeric field, one float list per vector
field) that `index/segment.py` packs into columns. Geo, join,
completion and nested objects are not ported yet and raise.
"""

from __future__ import annotations

import datetime as _dt
import json
import numbers
import re
from dataclasses import dataclass, field

from ..utils.errors import MapperParsingError
from ..utils.settings import Settings
from .analysis import AnalysisService, Analyzer

TEXT = "text"
KEYWORD = "keyword"
LONG = "long"
INTEGER = "integer"
SHORT = "short"
BYTE = "byte"
DOUBLE = "double"
FLOAT = "float"
DATE = "date"
BOOLEAN = "boolean"
IP = "ip"
DENSE_VECTOR = "dense_vector"  # [dims] float embedding -> device matrix

NUMERIC_TYPES = {LONG, INTEGER, SHORT, BYTE, DOUBLE, FLOAT}
ALL_TYPES = NUMERIC_TYPES | {TEXT, KEYWORD, DATE, BOOLEAN, IP, DENSE_VECTOR}
# types the reference maps that this slice does not carry yet
_UNPORTED_TYPES = {"geo_point", "geo_shape", "join", "completion",
                   "nested"}
_LEGACY_STRING = "string"

_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)

_DATE_FORMATS = (
    "%Y-%m-%dT%H:%M:%S.%f%z", "%Y-%m-%dT%H:%M:%S%z",
    "%Y-%m-%dT%H:%M:%S.%f", "%Y-%m-%dT%H:%M:%S",
    "%Y-%m-%d %H:%M:%S", "%Y-%m-%d", "%d/%b/%Y:%H:%M:%S %z",
)


def parse_date_millis(value) -> int:
    """Parse a date value (epoch millis, ISO-8601, common-log) to epoch millis."""
    if isinstance(value, bool):
        raise MapperParsingError(f"cannot parse boolean [{value}] as date")
    if isinstance(value, numbers.Number):
        return int(value)
    s = str(value).strip()
    if re.fullmatch(r"[+-]?\d{10,}", s):
        return int(s)
    for fmt in _DATE_FORMATS:
        try:
            dt = _dt.datetime.strptime(s, fmt)
            if dt.tzinfo is None:
                dt = dt.replace(tzinfo=_dt.timezone.utc)
            return int(dt.timestamp() * 1000)
        except ValueError:
            continue
    raise MapperParsingError(f"failed to parse date value [{value}]")


def format_date_millis(millis: int) -> str:
    dt = _EPOCH + _dt.timedelta(milliseconds=int(millis))
    return dt.strftime("%Y-%m-%dT%H:%M:%S.") + f"{dt.microsecond // 1000:03d}Z"


_IP_RE = re.compile(r"^(\d{1,3})\.(\d{1,3})\.(\d{1,3})\.(\d{1,3})$")


def parse_ip(value) -> int:
    """IPv4 -> uint32."""
    if isinstance(value, numbers.Number) and not isinstance(value, bool):
        return int(value)
    m = _IP_RE.match(str(value))
    if not m:
        raise MapperParsingError(f"failed to parse ip [{value}]")
    parts = [int(g) for g in m.groups()]
    if any(p > 255 for p in parts):
        raise MapperParsingError(f"failed to parse ip [{value}]")
    return (parts[0] << 24) | (parts[1] << 16) | (parts[2] << 8) | parts[3]


@dataclass
class FieldMapper:
    """One field's schema entry."""

    name: str
    type: str
    analyzer: str = "standard"
    search_analyzer: str | None = None
    index: bool = True
    doc_values: bool = True
    boost: float = 1.0
    fmt: str | None = None
    ignore_malformed: bool = False
    # text: similarity name ("" = index default); dense_vector: cosine |
    # dot_product | l2_norm ("" = cosine, the reference's default)
    similarity: str = ""
    dims: int | None = None   # dense_vector dimensionality

    def to_dict(self) -> dict:
        """The field's mapping as the reference renders it (persisted in
        an index's `_meta.json`), plus the keys the reference drops."""
        d: dict = {"type": self.type}
        if self.type == TEXT and self.analyzer != "standard":
            d["analyzer"] = self.analyzer
        if self.type == TEXT and self.similarity not in ("", "cosine"):
            d["similarity"] = self.similarity
        if not self.index:
            d["index"] = False
        if self.boost != 1.0:
            d["boost"] = self.boost
        if self.type == DENSE_VECTOR:
            d["dims"] = self.dims
            d["similarity"] = self.similarity or "cosine"
        if self.search_analyzer is not None:
            d["search_analyzer"] = self.search_analyzer
        if self.fmt is not None:
            d["format"] = self.fmt
        if self.ignore_malformed:
            d["ignore_malformed"] = True
        if not self.doc_values:
            d["doc_values"] = False
        return d


@dataclass
class ParsedField:
    """Columnar contribution of one field of one document."""

    name: str
    type: str
    tokens: list[str] | None = None   # TEXT: analyzed terms
    value: object = None              # KEYWORD: str; numeric: number


@dataclass
class ParsedDocument:
    doc_id: str
    source: bytes
    fields: list[ParsedField] = field(default_factory=list)


class DocumentMapper:
    """Schema for one index: field name -> FieldMapper; parses JSON docs."""

    _META_KEYS = frozenset((
        "dynamic", "properties", "_meta", "_source", "_all", "_routing",
        "_parent", "_timestamp", "_ttl", "_size", "date_detection",
        "numeric_detection", "dynamic_templates", "dynamic_date_formats"))

    def __init__(self, analysis: AnalysisService, mapping: dict | None = None,
                 dynamic: bool = True):
        self.analysis = analysis
        self.dynamic = dynamic
        self._fields: dict[str, FieldMapper] = {}
        self._multi_fields: dict[str, list[str]] = {}
        if mapping:
            self._parse_mapping(mapping)

    def _parse_mapping(self, mapping: dict) -> None:
        if "dynamic" in mapping:
            dyn = mapping["dynamic"]
            if isinstance(dyn, bool):
                self.dynamic = dyn
            elif str(dyn).lower() == "strict":
                self.dynamic = "strict"
            else:
                self.dynamic = str(dyn).lower() != "false"
        if "properties" in mapping:
            props = mapping["properties"]
        else:
            props = {k: v for k, v in mapping.items() if k not in self._META_KEYS}
        if not isinstance(props, dict):
            raise MapperParsingError("mapping [properties] must be an object")
        for name, spec in props.items():
            self._add_field(name, spec)

    def _add_field(self, name: str, spec: dict) -> FieldMapper | None:
        if not isinstance(spec, dict):
            raise MapperParsingError(f"mapping for field [{name}] must be an object")
        if "properties" in spec and spec.get("type") in (None, "object"):
            for child, child_spec in spec["properties"].items():
                self._add_field(f"{name}.{child}", child_spec)
            return None
        typ = spec.get("type")
        if typ in _UNPORTED_TYPES:
            raise NotImplementedError(
                f"field type [{typ}] on [{name}] is not yet ported")
        legacy_string = typ == _LEGACY_STRING
        if legacy_string:
            typ = KEYWORD if spec.get("index") == "not_analyzed" else TEXT
        if typ not in ALL_TYPES:
            raise MapperParsingError(f"no handler for type [{typ}] declared on field [{name}]")
        idx = spec.get("index", True)
        sim = str(spec.get("similarity", ""))
        fm = FieldMapper(
            name=name, type=typ,
            analyzer=spec.get("analyzer", "standard"),
            search_analyzer=spec.get("search_analyzer"),
            index=idx not in (False, "no", "none"),
            doc_values=bool(spec.get("doc_values", True)),
            boost=float(spec.get("boost", 1.0)),
            fmt=spec.get("format"),
            ignore_malformed=bool(spec.get("ignore_malformed", False)),
            similarity="" if sim == "cosine" else sim,
            dims=(int(spec["dims"]) if spec.get("dims") is not None
                  else None),
        )
        for sub_name, sub_spec in (spec.get("fields") or {}).items():
            sub = self._add_field(f"{name}.{sub_name}", sub_spec)
            if sub is not None:
                self._multi_fields.setdefault(name, []).append(sub.name)
        existing = self._fields.get(name)
        if existing and existing.type != fm.type:
            raise MapperParsingError(
                f"mapper [{name}] of different type, current_type "
                f"[{existing.type}], merged_type [{fm.type}]")
        self._fields[name] = fm
        return fm

    def merge(self, mapping: dict) -> None:
        self._parse_mapping(mapping)

    def to_dict(self) -> dict:
        """{"properties": ...}, multi-field subs under their parent's
        "fields" (ref: DocumentMapper.to_dict)."""
        sub_names = {s for subs in self._multi_fields.values() for s in subs}
        props = {}
        for n, f in sorted(self._fields.items()):
            if n in sub_names:
                continue
            d = f.to_dict()
            subs = self._multi_fields.get(n)
            if subs:
                d["fields"] = {
                    s.rsplit(".", 1)[-1]: self._fields[s].to_dict()
                    for s in sorted(subs) if s in self._fields}
            props[n] = d
        return {"properties": props}

    def field(self, name: str) -> FieldMapper | None:
        return self._fields.get(name)

    @property
    def fields(self) -> dict[str, FieldMapper]:
        return dict(self._fields)

    def _dynamic_type(self, name: str, value) -> str:
        if isinstance(value, bool):
            return BOOLEAN
        if isinstance(value, int):
            return LONG
        if isinstance(value, float):
            return DOUBLE
        s = str(value)
        try:
            parse_date_millis(s)
            if re.match(r"^\d{4}-\d{2}-\d{2}", s) or re.match(r"^\d{2}/[A-Za-z]{3}/\d{4}", s):
                return DATE
        except MapperParsingError:
            pass
        return TEXT

    def _coerce(self, fm: FieldMapper, value):
        try:
            if fm.type == DATE:
                return parse_date_millis(value)
            if fm.type == BOOLEAN:
                if isinstance(value, bool):
                    return value
                return str(value).lower() in ("true", "1", "on", "yes")
            if fm.type == IP:
                return parse_ip(value)
            if fm.type in (LONG, INTEGER, SHORT, BYTE):
                if isinstance(value, str) and not value.strip().lstrip("+-").isdigit():
                    raise MapperParsingError(
                        f"failed to parse [{fm.name}] as {fm.type}: [{value}]")
                return int(value)
            if fm.type in (DOUBLE, FLOAT):
                return float(value)
        except (ValueError, TypeError):
            raise MapperParsingError(f"failed to parse [{fm.name}] value [{value}]")
        return value

    def parse(self, doc_id: str, source: dict | bytes | str) -> ParsedDocument:
        """JSON document -> columnar field contributions."""
        if isinstance(source, (bytes, str)):
            raw = source if isinstance(source, bytes) else source.encode()
            try:
                obj = json.loads(source)
            except json.JSONDecodeError as e:
                raise MapperParsingError(f"failed to parse document: {e}")
        else:
            obj = source
            raw = json.dumps(source, separators=(",", ":")).encode()
        if not isinstance(obj, dict):
            raise MapperParsingError("document root must be an object")
        out = ParsedDocument(doc_id=doc_id, source=raw)
        self._parse_object("", obj, out)
        return out

    def _parse_object(self, prefix: str, obj: dict, out: ParsedDocument) -> None:
        for key, value in obj.items():
            name = f"{prefix}{key}"
            if isinstance(value, dict):
                self._parse_object(f"{name}.", value, out)
                continue
            if isinstance(value, list):
                fm = self._fields.get(name)
                if fm is not None and fm.type == DENSE_VECTOR:
                    self._parse_value(name, value, out)
                    continue
            values = value if isinstance(value, list) else [value]
            for v in values:
                if v is None:
                    continue
                if isinstance(v, dict):
                    self._parse_object(f"{name}.", v, out)
                    continue
                self._parse_value(name, v, out)

    def _parse_value(self, name: str, value, out: ParsedDocument) -> None:
        fm = self._fields.get(name)
        if fm is None:
            if self.dynamic == "strict":
                raise MapperParsingError(
                    f"mapping set to strict, dynamic introduction of [{name}] "
                    f"within [_doc] is not allowed")
            if not self.dynamic:
                return
            fm = FieldMapper(name=name, type=self._dynamic_type(name, value))
            self._fields[name] = fm
            if fm.type == TEXT:
                twin = FieldMapper(name=f"{name}.keyword", type=KEYWORD)
                self._fields[twin.name] = twin
                self._multi_fields.setdefault(name, []).append(twin.name)
        self._emit_field(fm, value, out)
        for sub_name in self._multi_fields.get(name, ()):
            sub = self._fields.get(sub_name)
            if sub is not None:
                self._emit_field(sub, value, out)

    def _emit_field(self, fm: FieldMapper, value, out: ParsedDocument) -> None:
        if fm.type == TEXT:
            if not fm.index:
                return
            analyzer: Analyzer = self.analysis.analyzer(fm.analyzer)
            out.fields.append(ParsedField(name=fm.name, type=TEXT,
                                          tokens=analyzer.analyze(str(value))))
        elif not fm.index and not fm.doc_values:
            return
        elif fm.type == DENSE_VECTOR:
            if not isinstance(value, list):
                raise MapperParsingError(
                    f"dense_vector [{fm.name}] requires an array of floats")
            vec = [float(x) for x in value]
            if fm.dims is not None and len(vec) != fm.dims:
                raise MapperParsingError(
                    f"dense_vector [{fm.name}] has {len(vec)} dims, "
                    f"mapping expects {fm.dims}")
            out.fields.append(ParsedField(name=fm.name, type=DENSE_VECTOR,
                                          value=vec))
        elif fm.type == KEYWORD:
            if len(str(value)) <= 256 or "." not in fm.name:  # ignore_above on subs
                out.fields.append(ParsedField(name=fm.name, type=KEYWORD,
                                              value=str(value)))
        else:
            try:
                coerced = self._coerce(fm, value)
            except MapperParsingError:
                if fm.ignore_malformed:
                    return
                raise
            out.fields.append(ParsedField(name=fm.name, type=fm.type, value=coerced))


class MapperService:
    """Per-index mapper registry (single merged field space)."""

    def __init__(self, index_settings: Settings = Settings.EMPTY,
                 mapping: dict | None = None):
        self.analysis = AnalysisService(index_settings)
        self.index_settings = index_settings
        self._sim_service = None
        self.mapper = DocumentMapper(self.analysis, mapping)

    def parse(self, doc_id: str, source) -> ParsedDocument:
        return self.mapper.parse(doc_id, source)

    def merge_mapping(self, mapping: dict) -> None:
        self.mapper.merge(mapping)

    def mapping_dict(self) -> dict:
        return self.mapper.to_dict()

    def field(self, name: str) -> FieldMapper | None:
        return self.mapper.field(name)

    def similarity_for(self, field: str):
        from .similarity import SimilarityService
        if self._sim_service is None:
            self._sim_service = SimilarityService(self.index_settings)
        return self._sim_service.for_field(self, field)

    def search_analyzer_for(self, field_name: str) -> Analyzer:
        fm = self.mapper.field(field_name)
        if fm is None or fm.type != TEXT:
            return self.analysis.analyzer("keyword")
        return self.analysis.analyzer(fm.search_analyzer or fm.analyzer)
