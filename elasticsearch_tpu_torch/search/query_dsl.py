"""Query DSL: JSON -> query AST (host-only).

Counterpart of `elasticsearch_tpu/search/query_dsl.py`, trimmed to the
queries this slice of the port serves: `match` (with `operator` /
`minimum_should_match`, and `type: phrase / phrase_prefix`), `term`,
`terms`, `prefix`, `bool`, `range`, `match_all`, `match_none`,
`constant_score`, the positional `match_phrase` / `match_phrase_prefix`,
`span_term` / `span_near` / `span_or` / `span_first` / `span_not`, and
`multi_match` (`cross_fields` as BM25F, the other types as a bool of
per-field matches) and `knn` (a vector similarity clause). Compound queries desugar exactly as in the
reference (`match` -> bool over analyzed terms, `terms` -> bool should,
a one-term phrase -> term), so both packages bind the same plans. Every
other query of the reference raises NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.errors import QueryParsingError
from ..index.mapping import MapperService


@dataclass(frozen=True)
class Query:
    pass


@dataclass(frozen=True)
class MatchAllQuery(Query):
    boost: float = 1.0


@dataclass(frozen=True)
class MatchNoneQuery(Query):
    pass


@dataclass(frozen=True)
class TermQuery(Query):
    """Exact term; binds to text postings or keyword ordinal compare."""

    field: str
    value: object
    boost: float = 1.0


@dataclass(frozen=True)
class RangeQuery(Query):
    field: str
    gte: object = None
    gt: object = None
    lte: object = None
    lt: object = None
    boost: float = 1.0


@dataclass(frozen=True)
class PrefixQuery(Query):
    """Binds by expanding against the segment term dictionary."""

    field: str
    value: str
    boost: float = 1.0
    max_expansions: int = 128


@dataclass(frozen=True)
class PhraseQuery(Query):
    """Positional phrase over analyzed terms in order; prefix_last
    expands the final term against the term dictionary
    (match_phrase_prefix)."""

    field: str
    terms: tuple[str, ...]
    slop: int = 0
    boost: float = 1.0
    prefix_last: bool = False
    max_expansions: int = 50


@dataclass(frozen=True)
class BM25FQuery(Query):
    """multi_match type=cross_fields as BM25F: shared per-term IDF (max
    df across the fields), per-field weighted tf and length norm, one
    saturation. fields is ((name, weight), ...) from the `f^w` syntax."""

    fields: tuple[tuple[str, float], ...]
    terms: tuple[str, ...]
    boost: float = 1.0


@dataclass(frozen=True)
class SpanTermQuery(Query):
    field: str
    value: str
    boost: float = 1.0


@dataclass(frozen=True)
class SpanNearQuery(Query):
    clauses: tuple[Query, ...]
    slop: int = 0
    in_order: bool = True
    boost: float = 1.0


@dataclass(frozen=True)
class SpanOrQuery(Query):
    clauses: tuple[Query, ...]
    boost: float = 1.0


@dataclass(frozen=True)
class SpanFirstQuery(Query):
    match: Query
    end: int
    boost: float = 1.0


@dataclass(frozen=True)
class SpanNotQuery(Query):
    include: Query
    exclude: Query
    pre: int = 0
    post: int = 0
    boost: float = 1.0


@dataclass(frozen=True)
class BoolQuery(Query):
    must: tuple[Query, ...] = ()
    should: tuple[Query, ...] = ()
    must_not: tuple[Query, ...] = ()
    filter: tuple[Query, ...] = ()
    minimum_should_match: int | None = None
    boost: float = 1.0


@dataclass(frozen=True)
class ConstantScoreQuery(Query):
    query: Query
    boost: float = 1.0


@dataclass(frozen=True)
class KnnQuery(Query):
    """Vector similarity as a scoring clause: every live doc carrying a
    vector matches, scored by the field similarity's transformed value
    (ops/knn.knn_score_column) times `boost`. Composable in a bool, so a
    hybrid BM25+vector search is one fused bundle (the `knn_vec` clause
    kind, search/executor._fused_plan_bundle); the top-level `knn`
    search section rewrites onto it (shard_searcher.rewrite_knn_body)."""

    field: str
    vector: tuple[float, ...] = ()
    boost: float = 1.0


# queries the reference parses that this slice does not carry yet
_NOT_PORTED = frozenset((
    "exists", "missing", "ids", "wildcard", "fuzzy", "regexp", "span_multi",
    "more_like_this", "mlt", "common", "nested", "_parents_match",
    "wrapper", "indices", "type", "limit", "template", "filtered",
    "boosting", "dis_max", "and", "or", "not", "query_string",
    "simple_query_string", "function_score", "geo_distance",
    "geo_distance_range", "geo_bounding_box", "geo_polygon", "geo_shape",
    "script", "has_child", "has_parent", "parent_id"))


def _single_entry(obj: dict, ctx: str) -> tuple[str, object]:
    if not isinstance(obj, dict) or len(obj) != 1:
        raise QueryParsingError(
            f"[{ctx}] expected an object with a single key, got {obj!r}")
    return next(iter(obj.items()))


def resolve_msm(value, n_optional: int) -> int | None:
    """minimum_should_match forms: int, "3", "75%", "-25%"."""
    if value is None:
        return None
    s = str(value).strip()
    try:
        if s.endswith("%"):
            pct = float(s[:-1])
            if pct < 0:
                return max(n_optional - int(n_optional * -pct / 100.0), 0)
            return int(n_optional * pct / 100.0)
        return int(s)
    except ValueError:
        raise QueryParsingError(
            f"failed to parse minimum_should_match [{value}]")


class QueryParser:
    """JSON query dict -> AST. Needs the mapper for `match` analysis."""

    def __init__(self, mapper_service: MapperService):
        self.mappers = mapper_service

    def parse(self, query: dict | None) -> Query:
        if query is None or query == {}:
            return MatchAllQuery()
        name, body = _single_entry(query, "query")
        handler = getattr(self, f"_parse_{name}", None)
        if handler is None:
            if name in _NOT_PORTED:
                raise NotImplementedError(
                    f"query [{name}] is not yet ported to elasticsearch_tpu_torch")
            raise QueryParsingError(f"no query registered for [{name}]")
        return handler(body)

    def _parse_match_all(self, body) -> Query:
        return MatchAllQuery(boost=float((body or {}).get("boost", 1.0)))

    def _parse_match_none(self, body) -> Query:
        return MatchNoneQuery()

    def _parse_knn(self, body) -> Query:
        if not isinstance(body, dict) or "field" not in body:
            raise QueryParsingError("[knn] requires [field]")
        vec = body.get("query_vector")
        if not isinstance(vec, (list, tuple)) or not vec:
            raise QueryParsingError("[knn] requires [query_vector]")
        return KnnQuery(field=str(body["field"]),
                        vector=tuple(float(x) for x in vec),
                        boost=float(body.get("boost", 1.0)))

    @staticmethod
    def _no_ids(fld: str) -> None:
        if fld in ("_id", "_uid"):
            raise NotImplementedError(
                f"term queries on [{fld}] (ids) are not yet ported")

    def _parse_term(self, body) -> Query:
        fld, spec = _single_entry(body, "term")
        self._no_ids(fld)
        if isinstance(spec, dict):
            return TermQuery(fld, spec.get("value"),
                             float(spec.get("boost", 1.0)))
        return TermQuery(fld, spec)

    def _parse_terms(self, body) -> Query:
        body = dict(body)
        boost = float(body.pop("boost", 1.0))
        body.pop("minimum_should_match", None)
        fld, values = _single_entry(body, "terms")
        if not isinstance(values, (list, tuple)):
            raise QueryParsingError("[terms] values must be an array")
        self._no_ids(fld)
        return BoolQuery(should=tuple(TermQuery(fld, v) for v in values),
                         minimum_should_match=1, boost=boost)

    def _parse_match(self, body) -> Query:
        fld, spec = _single_entry(body, "match")
        if isinstance(spec, dict):
            mtype = str(spec.get("type", "boolean")).lower()
            if mtype in ("phrase", "phrase_prefix"):
                return self._phrase({fld: spec}, fld,
                                    prefix_last=mtype == "phrase_prefix")
            text = spec.get("query")
            operator = str(spec.get("operator", "or")).lower()
            boost = float(spec.get("boost", 1.0))
            msm = spec.get("minimum_should_match")
        else:
            text, operator, boost, msm = spec, "or", 1.0, None
        analyzer = self.mappers.search_analyzer_for(fld)
        terms = analyzer.analyze(str(text))
        if not terms:
            return MatchNoneQuery()
        clauses = tuple(TermQuery(fld, t) for t in terms)
        if len(clauses) == 1:
            return TermQuery(fld, clauses[0].value, boost)
        if operator == "and":
            return BoolQuery(must=clauses, boost=boost)
        return BoolQuery(
            should=clauses,
            minimum_should_match=resolve_msm(msm, len(clauses)) or 1,
            boost=boost)

    def _parse_multi_match(self, body) -> Query:
        """`cross_fields` -> BM25F over the fields; every other type a
        bool should of per-field `match` queries."""
        fields = body.get("fields") or []
        text = body.get("query")
        if not fields:
            raise QueryParsingError("[multi_match] requires [fields]")
        pairs = []
        for f in fields:
            boost = 1.0
            if "^" in f:
                f, b = f.split("^", 1)
                boost = float(b)
            pairs.append((f, boost))
        mtype = str(body.get("type", "best_fields")).lower()
        if mtype == "cross_fields":
            # one analyzer group: the first field's search analyzer
            analyzer = self.mappers.search_analyzer_for(pairs[0][0])
            terms = analyzer.analyze(str(text))
            if not terms:
                return MatchNoneQuery()
            return BM25FQuery(tuple(pairs), tuple(terms),
                              boost=float(body.get("boost", 1.0)))
        shoulds = []
        for f, boost in pairs:
            sub = self._parse_match({f: {"query": text, "boost": boost}})
            if not isinstance(sub, MatchNoneQuery):
                shoulds.append(sub)
        if not shoulds:
            return MatchNoneQuery()
        return BoolQuery(should=tuple(shoulds), minimum_should_match=1,
                         boost=float(body.get("boost", 1.0)))

    def _parse_match_phrase(self, body) -> Query:
        return self._phrase(body, "match_phrase", prefix_last=False)

    def _parse_match_phrase_prefix(self, body) -> Query:
        return self._phrase(body, "match_phrase_prefix", prefix_last=True)

    def _phrase(self, body, ctx: str, prefix_last: bool) -> Query:
        fld, spec = _single_entry(body, ctx)
        if isinstance(spec, dict):
            text = spec.get("query")
            slop = int(spec.get("slop", 0))
            boost = float(spec.get("boost", 1.0))
            max_exp = int(spec.get("max_expansions", 50))
        else:
            text, slop, boost, max_exp = spec, 0, 1.0, 50
        analyzer = self.mappers.search_analyzer_for(fld)
        terms = analyzer.analyze(str(text))
        if not terms:
            return MatchNoneQuery()
        if len(terms) == 1 and not prefix_last:
            return TermQuery(fld, terms[0], boost)
        if len(terms) == 1 and prefix_last:
            return PrefixQuery(fld, terms[0], boost, max_exp)
        return PhraseQuery(fld, tuple(terms), slop=slop, boost=boost,
                           prefix_last=prefix_last, max_expansions=max_exp)

    # -- spans -------------------------------------------------------------

    def _parse_span(self, query: dict, ctx: str) -> Query:
        q = self.parse(query)
        if not isinstance(q, (SpanTermQuery, SpanNearQuery, SpanOrQuery,
                              SpanFirstQuery, SpanNotQuery)):
            raise QueryParsingError(f"[{ctx}] clauses must be span queries")
        return q

    def _parse_span_term(self, body) -> Query:
        fld, spec = _single_entry(body, "span_term")
        if isinstance(spec, dict):
            return SpanTermQuery(fld, str(spec.get("value")),
                                 float(spec.get("boost", 1.0)))
        return SpanTermQuery(fld, str(spec))

    def _parse_span_near(self, body) -> Query:
        clauses = tuple(self._parse_span(c, "span_near")
                        for c in body.get("clauses") or [])
        if not clauses:
            raise QueryParsingError("[span_near] requires [clauses]")
        return SpanNearQuery(clauses, slop=int(body.get("slop", 0)),
                             in_order=bool(body.get("in_order", True)),
                             boost=float(body.get("boost", 1.0)))

    def _parse_span_or(self, body) -> Query:
        clauses = tuple(self._parse_span(c, "span_or")
                        for c in body.get("clauses") or [])
        if not clauses:
            raise QueryParsingError("[span_or] requires [clauses]")
        return SpanOrQuery(clauses, boost=float(body.get("boost", 1.0)))

    def _parse_span_first(self, body) -> Query:
        match = body.get("match")
        if match is None:
            raise QueryParsingError("[span_first] requires [match]")
        return SpanFirstQuery(self._parse_span(match, "span_first"),
                              end=int(body.get("end", 1)),
                              boost=float(body.get("boost", 1.0)))

    def _parse_span_not(self, body) -> Query:
        include = body.get("include")
        exclude = body.get("exclude")
        if include is None or exclude is None:
            raise QueryParsingError(
                "[span_not] requires [include] and [exclude]")
        return SpanNotQuery(self._parse_span(include, "span_not"),
                            self._parse_span(exclude, "span_not"),
                            pre=int(body.get("pre", 0)),
                            post=int(body.get("post", 0)),
                            boost=float(body.get("boost", 1.0)))

    def _parse_range(self, body) -> Query:
        fld, spec = _single_entry(body, "range")
        if not isinstance(spec, dict):
            raise QueryParsingError("[range] body must be an object")
        legacy = {"from": "gte", "to": "lte"}
        kw = {}
        for k, v in spec.items():
            k = legacy.get(k, k)
            if k in ("gte", "gt", "lte", "lt"):
                kw[k] = v
            elif k == "boost":
                kw["boost"] = float(v)
        return RangeQuery(fld, **kw)

    def _parse_prefix(self, body) -> Query:
        fld, spec = _single_entry(body, "prefix")
        if isinstance(spec, dict):
            return PrefixQuery(
                fld, str(spec.get("value") or spec.get("prefix")),
                float(spec.get("boost", 1.0)))
        return PrefixQuery(fld, str(spec))

    def _parse_list(self, body) -> tuple[Query, ...]:
        if body is None:
            return ()
        items = body if isinstance(body, list) else [body]
        return tuple(self.parse(i) for i in items)

    def _parse_bool(self, body) -> Query:
        should = self._parse_list(body.get("should"))
        return BoolQuery(
            must=self._parse_list(body.get("must")),
            should=should,
            must_not=self._parse_list(body.get("must_not")),
            filter=self._parse_list(body.get("filter")),
            minimum_should_match=resolve_msm(
                body.get("minimum_should_match"), len(should)),
            boost=float(body.get("boost", 1.0)),
        )

    def _parse_constant_score(self, body) -> Query:
        inner = body.get("filter") or body.get("query")
        if inner is None:
            raise QueryParsingError(
                "[constant_score] requires [filter] or [query]")
        return ConstantScoreQuery(self.parse(inner),
                                  float(body.get("boost", 1.0)))
