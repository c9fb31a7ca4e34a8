"""Query term collection.

Counterpart of `elasticsearch_tpu/search/highlight.py`, holding only
`collect_terms` (ref: Query.extractTerms), which the DFS pre-phase
(`node._aggregate_dfs`) uses to pick the (field, term) pairs whose
global statistics it sums. The highlighter itself is not ported.
"""

from __future__ import annotations

from .query_dsl import (BoolQuery, ConstantScoreQuery, PhraseQuery,
                        PrefixQuery, Query, SpanFirstQuery, SpanNearQuery,
                        SpanNotQuery, SpanOrQuery, SpanTermQuery, TermQuery)


def collect_terms(q: Query, field: str | None = None) -> dict[str, set[str]]:
    """Walk the query AST collecting field -> terms."""
    out: dict[str, set[str]] = {}

    def walk(node: Query):
        if isinstance(node, (TermQuery, PrefixQuery, SpanTermQuery)):
            out.setdefault(node.field, set()).add(str(node.value))
        elif isinstance(node, BoolQuery):
            for sub in (*node.must, *node.should, *node.filter):
                walk(sub)
        elif isinstance(node, ConstantScoreQuery):
            walk(node.query)
        elif isinstance(node, PhraseQuery):
            out.setdefault(node.field, set()).update(map(str, node.terms))
        elif isinstance(node, (SpanNearQuery, SpanOrQuery)):
            for sub in node.clauses:
                walk(sub)
        elif isinstance(node, SpanFirstQuery):
            walk(node.match)
        elif isinstance(node, SpanNotQuery):
            walk(node.include)
    walk(q)
    if field is not None:
        out = {f: t for f, t in out.items() if f == field}
    return out
