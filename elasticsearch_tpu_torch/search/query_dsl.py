"""Query DSL: JSON -> query AST (host-only).

Counterpart of `elasticsearch_tpu/search/query_dsl.py`. It parses the
leaf queries (`match` with `operator` / `minimum_should_match` and
`type: phrase / phrase_prefix`, `term` / `terms` (on `_id` / `_uid` an
`ids` lookup), `prefix`, `wildcard`, `regexp`, `fuzzy`, `range`,
`exists` / `missing`, `ids`, `match_all`, `match_none`, `knn`), the
positional ones (`match_phrase` / `match_phrase_prefix`, `span_term` /
`span_near` / `span_or` / `span_first` / `span_not` / `span_multi`,
`multi_match` with `cross_fields` as BM25F), the text rewrites
(`query_string` / `simple_query_string`, `common`, `more_like_this`),
the wrappers (`wrapper`, `indices`, `type`, `limit`, `template`) and the
compound queries (`bool`, `constant_score`, `filtered`, `boosting`,
`dis_max`, `and` / `or` / `not`, `function_score` with `script_score`)
and the `script` filter. Compound queries
desugar exactly as in the reference (`match` -> bool over analyzed
terms, `terms` -> bool should, `filtered` -> bool must + filter,
`dis_max` -> bool should summing its scores, a one-term phrase -> term),
so both packages bind the same plans. `nested` is the block join of a
child query onto its parents (score_mode none / sum / avg / max / min);
`_parents_match` is the internal scope filter of the nested agg. The
parent / child queries (`has_child`, `has_parent`, `parent_id`) are no
AST nodes: the shard searcher resolves them into ids / term filters
before parsing (`ShardReader._resolve_joins_all`), as the reference
does.
Geo queries raise NotImplementedError.
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
class ExistsQuery(Query):
    field: str


@dataclass(frozen=True)
class IdsQuery(Query):
    values: tuple[str, ...]


@dataclass(frozen=True)
class PrefixQuery(Query):
    """Binds by expanding against the segment term dictionary."""

    field: str
    value: str
    boost: float = 1.0
    max_expansions: int = 128


@dataclass(frozen=True)
class WildcardQuery(Query):
    """Expanded host-side against the term dictionary."""

    field: str
    value: str
    boost: float = 1.0
    max_expansions: int = 128


@dataclass(frozen=True)
class FuzzyQuery(Query):
    """Edit-distance expansion against the term dictionary."""

    field: str
    value: str
    fuzziness: int = 2
    boost: float = 1.0
    max_expansions: int = 50


@dataclass(frozen=True)
class RegexpQuery(Query):
    """Expanded host-side against the sorted term dictionary."""

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
class MoreLikeThisQuery(Query):
    """Lucene MoreLikeThis: the like-texts' tokens ranked by tf * idf
    against each segment's statistics at bind time; the top
    max_query_terms become a bool should of term queries."""

    fields: tuple[str, ...]
    like_texts: tuple[str, ...]
    unlike_texts: tuple[str, ...] = ()
    exclude_ids: tuple[str, ...] = ()      # the "like" docs themselves
    min_term_freq: int = 2
    min_doc_freq: int = 5
    max_query_terms: int = 25
    minimum_should_match: str = "30%"
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
class NestedQuery(Query):
    """Block-join child query projected onto parents (ref:
    index/query/NestedQueryParser.java, ToParentBlockJoinQuery)."""

    path: str
    query: Query
    score_mode: str = "avg"    # none | sum | avg | max | min
    boost: float = 1.0


@dataclass(frozen=True)
class ParentsMatchQuery(Query):
    """Internal: nested rows whose parent matches `query`, the scope
    filter of nested aggregations (NestedAggregator's parentDocs)."""

    query: Query


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


@dataclass(frozen=True)
class ScriptQuery(Query):
    """Script filter: matches docs where the expression is truthy (filter
    context, constant score)."""

    script: str
    params: tuple = ()             # sorted ((name, value), ...)
    boost: float = 1.0


@dataclass(frozen=True)
class ScoreFunction:
    """One function_score function: weight, field_value_factor,
    random_score, a gauss / exp / linear decay, or script_score."""

    kind: str
    field: str | None = None
    weight: float = 1.0
    filter: "Query | None" = None
    # field_value_factor
    factor: float = 1.0
    modifier: str = "none"
    missing: float = 0.0
    # random_score
    seed: int = 0
    # decay
    origin: object = None
    scale: object = None
    offset: object = 0
    decay: float = 0.5
    # script_score
    script: str | None = None
    script_params: tuple = ()      # sorted ((name, value), ...)


@dataclass(frozen=True)
class FunctionScoreQuery(Query):
    query: Query
    functions: tuple[ScoreFunction, ...] = ()
    score_mode: str = "multiply"   # multiply|sum|avg|max|min|first
    boost_mode: str = "multiply"   # multiply|replace|sum|avg|max|min
    max_boost: float = float("inf")
    min_score: float | None = None
    boost: float = 1.0


@dataclass(frozen=True)
class BoostingQuery(Query):
    """Positive scores, demoted by negative_boost where negative
    matches."""

    positive: Query
    negative: Query
    negative_boost: float = 0.2


# queries the reference parses that the port does not carry yet: geo
_NOT_PORTED = frozenset((
    "geo_distance", "geo_distance_range", "geo_bounding_box", "geo_polygon",
    "geo_shape"))


def _dotted_get(obj: dict, path: str):
    cur = obj
    for part in path.split("."):
        if not isinstance(cur, dict):
            return None
        cur = cur.get(part)
    return cur


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

    def __init__(self, mapper_service: MapperService,
                 index_name: str | None = None, doc_lookup=None):
        """doc_lookup: optional callable doc_id -> source dict | None,
        used by more_like_this for `like` documents given by id;
        index_name feeds the `indices` query."""
        self.mappers = mapper_service
        self.index_name = index_name
        self.doc_lookup = doc_lookup

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
    def _id_values(fld: str, values) -> tuple[str, ...]:
        """term / terms on `_id` / `_uid` are doc-id lookups; `_uid`
        values are "type#id"."""
        out = []
        for v in values:
            sv = str(v)
            if fld == "_uid" and "#" in sv:
                sv = sv.split("#", 1)[1]
            out.append(sv)
        return tuple(out)

    def _parse_term(self, body) -> Query:
        fld, spec = _single_entry(body, "term")
        value = spec.get("value") if isinstance(spec, dict) else spec
        if fld in ("_id", "_uid"):
            return IdsQuery(self._id_values(fld, [value]))
        if isinstance(spec, dict):
            return TermQuery(fld, value, float(spec.get("boost", 1.0)))
        return TermQuery(fld, spec)

    def _parse_terms(self, body) -> Query:
        body = dict(body)
        boost = float(body.pop("boost", 1.0))
        body.pop("minimum_should_match", None)
        fld, values = _single_entry(body, "terms")
        if not isinstance(values, (list, tuple)):
            raise QueryParsingError("[terms] values must be an array")
        if fld in ("_id", "_uid"):
            return IdsQuery(self._id_values(fld, values))
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

    def _parse_exists(self, body) -> Query:
        return ExistsQuery(body["field"])

    def _parse_missing(self, body) -> Query:
        # ref: index/query/MissingFilterParser.java == not exists
        return BoolQuery(must_not=(ExistsQuery(body["field"]),))

    def _parse_ids(self, body) -> Query:
        values = body.get("values") or []
        return IdsQuery(tuple(str(v) for v in values))

    def _parse_wildcard(self, body) -> Query:
        fld, spec = _single_entry(body, "wildcard")
        if isinstance(spec, dict):
            return WildcardQuery(
                fld, str(spec.get("value") or spec.get("wildcard")),
                float(spec.get("boost", 1.0)))
        return WildcardQuery(fld, str(spec))

    def _parse_fuzzy(self, body) -> Query:
        fld, spec = _single_entry(body, "fuzzy")
        if isinstance(spec, dict):
            fuzz = spec.get("fuzziness", "AUTO")
            fuzz = 2 if str(fuzz).upper() == "AUTO" else int(fuzz)
            return FuzzyQuery(fld, str(spec.get("value")), fuzz,
                              float(spec.get("boost", 1.0)))
        return FuzzyQuery(fld, str(spec))

    def _parse_regexp(self, body) -> Query:
        # no expansion cap: ES regexp matching is automaton-based over the
        # whole term dictionary (max_determinized_states guards automaton
        # complexity, not result count — Python's re has no analog)
        fld, spec = _single_entry(body, "regexp")
        if isinstance(spec, dict):
            return RegexpQuery(fld, str(spec.get("value")),
                               float(spec.get("boost", 1.0)),
                               max_expansions=1 << 30)
        return RegexpQuery(fld, str(spec), max_expansions=1 << 30)

    def _parse_span_multi(self, body) -> Query:
        # span wrapper around prefix/wildcard/fuzzy/regexp: expansion
        # happens at bind anyway; treat inner spans as single-position
        # terms is not possible generally, so accept and return the inner
        # multi-term query for scoring purposes (set semantics preserved
        # when used standalone; ref: SpanMultiTermQueryParser.java)
        inner = body.get("match")
        if inner is None:
            raise QueryParsingError("[span_multi] requires [match]")
        return self.parse(inner)

    # -- more_like_this / common -------------------------------------------

    def _parse_more_like_this(self, body) -> Query:
        fields = tuple(body.get("fields") or
                       [n for n, f in self.mappers.mapper.fields.items()
                        if f.type == "text"])
        likes = body.get("like")
        if likes is None:
            likes = body.get("like_text")
        if likes is None:
            # legacy docs/ids arrays (ref: MoreLikeThisQueryParser "docs"/
            # "ids"): ids are document references, not literal text;
            # both keys may appear together and merge
            likes = [({"_id": d} if isinstance(d, (str, int)) else d)
                     for d in [*(body.get("docs") or []),
                               *(body.get("ids") or [])]]
        if not isinstance(likes, list):
            likes = [likes]

        exclude_ids: list[str] = []

        def collect(entries) -> list[str]:
            texts: list[str] = []
            for like in entries:
                if isinstance(like, (str, int)):
                    # bare strings in like/like_text/ignore_like are
                    # literal text (doc references were wrapped into
                    # {_id} dicts above)
                    texts.append(str(like))
                    continue
                if isinstance(like, dict):
                    did = like.get("_id") or like.get(
                        "_doc", {}).get("_id")
                    if did is not None and self.doc_lookup is not None:
                        src = self.doc_lookup(str(did))
                        if src is not None:
                            exclude_ids.append(str(did))
                            for f in fields:
                                v = _dotted_get(src, f)
                                if v is not None:
                                    texts.append(str(v))
                    elif like.get("doc"):
                        for f in fields:
                            v = _dotted_get(like["doc"], f)
                            if v is not None:
                                texts.append(str(v))
            return texts

        texts = collect(likes)
        unlikes = body.get("ignore_like", body.get("unlike"))
        if unlikes is not None and not isinstance(unlikes, list):
            unlikes = [unlikes]
        n_excl = len(exclude_ids)
        unlike_texts = collect(unlikes or [])
        del exclude_ids[n_excl:]   # ignore-docs are not result excludes
        if not texts:
            return MatchNoneQuery()
        include = bool(body.get("include", False))
        return MoreLikeThisQuery(
            fields=fields, like_texts=tuple(texts),
            unlike_texts=tuple(unlike_texts),
            exclude_ids=() if include else tuple(exclude_ids),
            min_term_freq=int(body.get("min_term_freq", 2)),
            min_doc_freq=int(body.get("min_doc_freq", 5)),
            max_query_terms=int(body.get("max_query_terms", 25)),
            minimum_should_match=str(body.get("minimum_should_match", "30%")),
            boost=float(body.get("boost", 1.0)))

    _parse_mlt = _parse_more_like_this
    _parse_fuzzy_like_this = _parse_more_like_this  # deprecated alias

    def _parse_common(self, body) -> Query:
        """common terms query (ref: index/query/CommonTermsQueryParser.java).
        The high/low-frequency split depends on per-segment df, but the
        eager-impact design already down-weights frequent terms via idf, so
        the rewrite is a match query honoring low_freq_operator/msm."""
        fld, spec = _single_entry(body, "common")
        if not isinstance(spec, dict):
            spec = {"query": spec}
        msm = spec.get("minimum_should_match")
        if isinstance(msm, dict):
            msm = msm.get("low_freq")
        return self._parse_match({fld: {
            "query": spec.get("query"),
            "operator": spec.get("low_freq_operator", "or"),
            "minimum_should_match": msm,
            "boost": spec.get("boost", 1.0)}})

    # -- misc wrappers ------------------------------------------------------

    def _parse_nested(self, body) -> Query:
        path = body.get("path")
        if not path:
            raise QueryParsingError("[nested] requires [path]")
        inner = body.get("query") or body.get("filter")
        if inner is None:
            raise QueryParsingError("[nested] requires [query]")
        return NestedQuery(
            path=str(path), query=self.parse(inner),
            score_mode=str(body.get("score_mode", "avg")).lower(),
            boost=float(body.get("boost", 1.0)))

    def _parse__parents_match(self, body) -> Query:
        return ParentsMatchQuery(self.parse(body.get("query")))

    def _parse_wrapper(self, body) -> Query:
        import base64
        import json as _json
        raw = body.get("query") if isinstance(body, dict) else body
        if isinstance(raw, str):
            raw = _json.loads(base64.b64decode(raw))
        return self.parse(raw)

    def _parse_indices(self, body) -> Query:
        # ref: index/query/IndicesQueryParser.java
        targets = body.get("indices") or [body.get("index")]
        match = self.index_name is None or self.index_name in targets
        if match:
            return self.parse(body.get("query"))
        no_match = body.get("no_match_query", "all")
        if no_match == "none":
            return MatchNoneQuery()
        if no_match == "all" or no_match is None:
            return MatchAllQuery()
        return self.parse(no_match)

    def _parse_type(self, body) -> Query:
        # single-doc-type world (ref: TypeFilterParser; types were removed
        # in later ES — everything is _doc)
        value = body.get("value")
        if value in ("_doc", "doc", None):
            return MatchAllQuery()
        return MatchNoneQuery()

    def _parse_limit(self, body) -> Query:
        return MatchAllQuery()  # deprecated no-op filter (LimitFilterParser)

    def _parse_template(self, body) -> Query:
        """template query: inline mustache-rendered query
        (ref: index/query/TemplateQueryParser.java)."""
        from .templates import render_template
        spec = body.get("inline") or body.get("query") or body.get("template")
        params = body.get("params") or {}
        if isinstance(spec, dict) and "inline" in spec:
            params = spec.get("params") or params
            spec = spec["inline"]
        rendered = render_template(spec, params)
        return self.parse(rendered)

    def _parse_filtered(self, body) -> Query:
        # legacy ES 2.0 form, ref: index/query/FilteredQueryParser.java
        q = (self.parse(body.get("query")) if body.get("query")
             else MatchAllQuery())
        f = self.parse(body.get("filter")) if body.get("filter") else None
        if f is None:
            return q
        return BoolQuery(must=(q,), filter=(f,))

    def _parse_boosting(self, body) -> Query:
        return BoostingQuery(
            positive=self.parse(body["positive"]),
            negative=self.parse(body["negative"]),
            negative_boost=float(body.get("negative_boost", 0.2)),
        )

    def _parse_dis_max(self, body) -> Query:
        # approximation: sum-of-scores bool should (true max lands with the
        # executor's max-combine mode); matches set semantics exactly
        return BoolQuery(should=self._parse_list(body.get("queries")),
                         minimum_should_match=1,
                         boost=float(body.get("boost", 1.0)))

    def _parse_and(self, body) -> Query:
        filters = body.get("filters") if isinstance(body, dict) else body
        return BoolQuery(filter=self._parse_list(filters))

    def _parse_or(self, body) -> Query:
        filters = body.get("filters") if isinstance(body, dict) else body
        return BoolQuery(should=self._parse_list(filters),
                         minimum_should_match=1)

    def _parse_query_string(self, body) -> Query:
        """Minimal query_string: `field:value` pairs, AND/OR/NOT/-term
        operators, bare terms matched across all text fields.

        Ref: index/query/QueryStringQueryParser.java — the full Lucene
        syntax (grouping, ranges, fuzziness suffixes) lands with the
        parser module; this covers the URI-search `q=` workhorse forms.
        """
        if isinstance(body, str):
            text, default_field = body, None
        else:
            text = str(body.get("query", ""))
            default_field = body.get("default_field")
        default_and = (not isinstance(body, str)
                       and str(body.get("default_operator", "or")
                               ).lower() == "and")
        tokens = text.split()
        text_fields = [n for n, f in self.mappers.mapper.fields.items()
                       if f.type == "text"] or ["_all"]

        # pass 1: collect clauses with their surrounding explicit operators
        # items: [clause, op_before (AND/OR/None), negate, required(+)]
        items: list[list] = []
        op_before: str | None = None
        i = 0
        while i < len(tokens):
            tok = tokens[i]
            if tok in ("AND", "OR", "&&", "||"):
                op_before = "AND" if tok in ("AND", "&&") else "OR"
                i += 1
                continue
            negate = False
            required = False
            if tok == "NOT" or tok == "!":
                negate = True
                i += 1
                tok = tokens[i] if i < len(tokens) else ""
            elif tok.startswith("-") and len(tok) > 1:
                negate = True
                tok = tok[1:]
            elif tok.startswith("+") and len(tok) > 1:
                required = True
                tok = tok[1:]
            if ":" in tok:
                fld, val = tok.split(":", 1)
                clause = self._parse_match({fld: val})
            elif default_field:
                clause = self._parse_match({default_field: tok})
            else:
                subs = [self._parse_match({f: tok}) for f in text_fields]
                subs = [s for s in subs if not isinstance(s, MatchNoneQuery)]
                clause = (BoolQuery(should=tuple(subs),
                                    minimum_should_match=1)
                          if subs else MatchNoneQuery())
            items.append([clause, op_before, negate, required])
            op_before = None
            i += 1

        # pass 2: resolve operators BOTH ways — an AND binds its left and
        # right operands as required; an explicit OR makes both optional
        # (overriding default_operator=and), matching Lucene's resolution
        n = len(items)
        group = ["must" if default_and else "should"] * n
        for j in range(n):
            if items[j][1] == "AND":
                group[j] = "must"
                if j > 0:
                    group[j - 1] = "must"
            elif items[j][1] == "OR":
                group[j] = "should"
                if j > 0 and not items[j - 1][3]:
                    group[j - 1] = "should"
        musts, shoulds, must_nots = [], [], []
        for j, (clause, _op, negate, required) in enumerate(items):
            if negate:
                must_nots.append(clause)
            elif required or group[j] == "must":
                musts.append(clause)
            else:
                shoulds.append(clause)
        if not (musts or shoulds or must_nots):
            return MatchAllQuery()
        return BoolQuery(must=tuple(musts), should=tuple(shoulds),
                         must_not=tuple(must_nots),
                         minimum_should_match=(1 if shoulds and not musts
                                               else 0))

    def _parse_simple_query_string(self, body) -> Query:
        return self._parse_query_string(body)

    def _parse_function_score(self, body) -> Query:
        inner = self.parse(body.get("query")) if body.get("query") \
            else MatchAllQuery()
        raw_fns = body.get("functions")
        if raw_fns is None:
            # single-function shorthand: the function keys live at top level
            raw_fns = [{k: v for k, v in body.items()
                        if k not in ("query", "boost", "score_mode",
                                     "boost_mode", "max_boost", "min_score")}]
        functions = []
        for spec in raw_fns:
            spec = dict(spec)
            flt = self.parse(spec.pop("filter")) if spec.get("filter") \
                else None
            spec.pop("filter", None)
            weight = float(spec.pop("weight", 1.0))
            if not spec:
                functions.append(ScoreFunction("weight", weight=weight,
                                               filter=flt))
                continue
            kind, conf = _single_entry(spec, "function_score.functions")
            if kind == "field_value_factor":
                functions.append(ScoreFunction(
                    "field_value_factor", field=conf["field"], weight=weight,
                    filter=flt, factor=float(conf.get("factor", 1.0)),
                    modifier=str(conf.get("modifier", "none")).lower(),
                    missing=float(conf.get("missing", 0.0))))
            elif kind == "random_score":
                functions.append(ScoreFunction(
                    "random_score", weight=weight, filter=flt,
                    seed=int(conf.get("seed", 0) or 0)))
            elif kind in ("gauss", "exp", "linear", "lin"):
                fld, dconf = _single_entry(conf, kind)
                functions.append(ScoreFunction(
                    "linear" if kind == "lin" else kind, field=fld,
                    weight=weight, filter=flt,
                    origin=dconf.get("origin"), scale=dconf.get("scale"),
                    offset=dconf.get("offset", 0),
                    decay=float(dconf.get("decay", 0.5))))
            elif kind == "script_score":
                from ..script import parse_script_spec
                src, sparams = parse_script_spec(conf)
                functions.append(ScoreFunction(
                    "script_score", weight=weight, filter=flt, script=src,
                    script_params=tuple(sorted(sparams.items()))))
            else:
                raise QueryParsingError(
                    f"unknown score function [{kind}]")
        return FunctionScoreQuery(
            query=inner, functions=tuple(functions),
            score_mode=str(body.get("score_mode", "multiply")).lower(),
            boost_mode=str(body.get("boost_mode", "multiply")).lower(),
            max_boost=float(body.get("max_boost", float("inf"))),
            min_score=(float(body["min_score"])
                       if body.get("min_score") is not None else None),
            boost=float(body.get("boost", 1.0)))

    def _parse_script(self, body) -> Query:
        from ..script import parse_script_spec
        src, params = parse_script_spec(body)
        return ScriptQuery(script=src,
                           params=tuple(sorted(params.items())),
                           boost=float(body.get("boost", 1.0))
                           if isinstance(body, dict) else 1.0)

    def _parse_not(self, body) -> Query:
        if isinstance(body, dict):
            inner = body.get("query") or body.get("filter")
            if inner is None:
                inner = body  # legacy bare form: {"not": {<query>}}
        else:
            inner = body
        return BoolQuery(must_not=(self.parse(inner),))
