"""Cross-shard reduce: merge per-shard search results into one response.

Counterpart of `elasticsearch_tpu/search/controller.py` (host code; ref:
search/controller/SearchPhaseController.java): the TopDocs merge across
shard top-k with (key, shard index, per-shard rank) tie-breaking, the
multi-key merge, the aggregation reduce over shard partials, and the
`_shards` header with structured per-shard failures (a failed shard
enters the reduce as a failure entry; hits and aggs come from the
survivors).
"""

from __future__ import annotations

from .aggregations import AggSpec, finalize_partials, merge_shard_partials


def shards_header(total: int, successful: int,
                  failures: list[dict] | None = None,
                  failed: int | None = None) -> dict:
    """The `_shards` response section (ref: RestActions.buildBroadcast
    ShardsHeader). `failures` carries the structured per-shard entries;
    the key is emitted ONLY when non-empty so fully-successful responses
    stay byte-identical to the pre-failure-semantics output."""
    if failed is None:
        failed = len(failures or ())
    out = {"total": total, "successful": successful, "failed": failed}
    if failures:
        out["failures"] = list(failures)
    return out


def shard_failure(shard: int | None, index: str | None, exc: BaseException,
                  node: str | None = None) -> dict:
    """One structured `_shards.failures` entry (ref:
    ShardSearchFailure.toXContent: shard/index/node/status + the
    ElasticsearchException rendering with `caused_by`)."""
    reason = {"type": type(exc).__name__, "reason": str(exc)}
    # explicit causes only: the implicit __context__ chain re-states the
    # same error on retry paths (scheduler isolation re-raises inside an
    # except block), which would render every failure self-caused
    cause = exc.__cause__
    if cause is not None and cause is not exc:
        reason["caused_by"] = {"type": type(cause).__name__,
                               "reason": str(cause)}
    entry = {"shard": shard, "index": index,
             "status": getattr(exc, "status", 500), "reason": reason}
    if node is not None:
        entry["node"] = node
    return entry


def merge_shard_results(shard_responses: list[dict],
                        agg_specs: list[AggSpec] | None = None,
                        shard_partials: list[dict] | None = None,
                        frm: int = 0, size: int = 10,
                        descending: bool = True,
                        score_sort: bool = True,
                        multi_orders: list[bool] | None = None,
                        total_shards: int | None = None,
                        failures: list[dict] | None = None,
                        timed_out: bool = False) -> dict:
    """Merge per-shard responses (each already sorted, carrying up to
    from+size hits) into the final response.

    Tie-breaking matches the reference: equal keys resolve by shard index
    then per-shard rank (shard hits are already (seg, doc)-ordered).

    Partial-failure semantics: `failures` carries structured entries for
    shards that never produced a response (their count rides
    `total_shards`, which defaults to len(shard_responses) + failures);
    `timed_out` marks deadline-clipped responses. The reduce itself runs
    over the SURVIVING shards only — hits/aggs are exactly what a search
    over those shards alone would return (SearchPhaseController reduces
    whatever QuerySearchResults arrived).
    """
    total = 0
    failed = len(failures or ())
    successful = 0
    max_score = None
    cands: list[tuple] = []
    took = 0
    for shard_idx, resp in enumerate(shard_responses):
        if resp is None or resp.get("_failed"):
            failed += 1
            continue
        successful += 1
        took = max(took, resp.get("took", 0))
        total += resp["hits"]["total"]
        ms = resp["hits"].get("max_score")
        if ms is not None and (max_score is None or ms > max_score):
            max_score = ms
        for rank, hit in enumerate(resp["hits"]["hits"]):
            if multi_orders is not None:
                key = tuple(hit.get("sort") or [])
            elif score_sort:
                key = hit.get("_score") or 0.0
            else:
                key = hit.get("sort", [None])[0]
            cands.append((key, shard_idx, rank, hit))

    def sort_key(c):
        key, shard_idx, rank, _ = c
        missing = key is None
        if descending:
            primary = (missing, -(key if not missing else 0.0))
        else:
            primary = (missing, key if not missing else 0.0)
        return (*primary, shard_idx, rank)

    if multi_orders is not None:
        # multi-key merge: per-key direction + missing-last, mirroring
        # the shard-side lexsort (FieldComparator chain semantics)
        def sort_key(c):  # noqa: F811 — multi-key variant
            key_list, shard_idx, rank, _ = c
            parts = []
            for pos, desc in enumerate(multi_orders):
                v = key_list[pos] if pos < len(key_list) else None
                missing = v is None
                if isinstance(v, str):
                    parts.append((missing, _neg_str(v) if desc else v))
                else:
                    x = float(v) if v is not None else 0.0
                    parts.append((missing, -x if desc else x))
            return (*parts, shard_idx, rank)

        cands.sort(key=sort_key)
        hits = [h for _, _, _, h in cands[frm: frm + size]]
        out = {
            "took": took, "timed_out": timed_out,
            "_shards": shards_header(
                total_shards if total_shards is not None
                else len(shard_responses) + len(failures or ()),
                successful, failures, failed=failed),
            "hits": {"total": total, "max_score": None, "hits": hits},
        }
        if agg_specs:
            merged = merge_shard_partials(agg_specs, shard_partials or [])
            out["aggregations"] = finalize_partials(agg_specs, merged)
        return out

    # strings (keyword sort keys) and floats never mix within one query
    if cands and isinstance(next((c[0] for c in cands if c[0] is not None), 0.0),
                            str):
        def sort_key(c):  # noqa: F811 — string variant
            key, shard_idx, rank, _ = c
            missing = key is None
            k = key if not missing else ""
            return ((missing, k if not descending else _neg_str(k)),
                    shard_idx, rank)

    cands.sort(key=sort_key)
    hits = [h for _, _, _, h in cands[frm: frm + size]]

    out = {
        "took": took,
        "timed_out": timed_out,
        "_shards": shards_header(
            total_shards if total_shards is not None
            else len(shard_responses) + len(failures or ()),
            successful, failures, failed=failed),
        "hits": {"total": total,
                 "max_score": max_score if score_sort else None,
                 "hits": hits},
    }
    if agg_specs:
        merged = merge_shard_partials(agg_specs, shard_partials or [])
        out["aggregations"] = finalize_partials(agg_specs, merged)
    return out


class _neg_str:
    """Inverted string ordering for descending keyword sort."""

    __slots__ = ("s",)

    def __init__(self, s: str):
        self.s = s

    def __lt__(self, other: "_neg_str") -> bool:
        return self.s > other.s

    def __eq__(self, other) -> bool:
        return isinstance(other, _neg_str) and self.s == other.s
