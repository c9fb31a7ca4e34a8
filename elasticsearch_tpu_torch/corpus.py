"""Seeded http_logs-like corpus and request mixes.

The same generator shape as the repository's benchmark corpus (a Zipf
vocabulary of path words, Pareto-skewed popular paths, http methods and
status codes), written with numpy `Generator`s so a 2^20-doc shard can be
made in seconds. Documents carry `message` (text), `status` (keyword),
`size` (long), `@timestamp` (date, epoch millis) and `body` (text); one
document in `long_every` has a `body` of more than 256 distinct terms, so
the `body` field gets no forward index and its term queries take the
posting-scatter path. `message` carries positions, so its phrase, span
and cross_fields queries score on the positional pack.

The passages corpus (`passage_columns`, `make_passages`) is the shape of
BASELINE.json's fifth config, dense_vector kNN + BM25 rescore over
msmarco-v2 passages: a `passage` text field of 20-60 tokens over the
same Zipf vocabulary (the repository benchmark's msmarco passages) and
an `embedding` dense_vector. Embeddings are Gaussian, drawn around
Gaussian centers with Gaussian noise (the repository benchmark's IVF
corpus: vectors concentrate around semantic centers, which is what gives
a coarse quantizer something to find), and queries lie near members.
The dyadic option draws small integers in [-4, 4] for the docs and, for
the queries, +-1 on 4^m coordinates (m = 1 below 16 dims, else 2), so
every f32 partial sum of a dot product is exact and a query's norm is a
power of two: any summation order gives the same bits.
"""

from __future__ import annotations

import numpy as np

MAPPING = {"properties": {
    "message": {"type": "text"},
    "status": {"type": "keyword"},
    "size": {"type": "long"},
    "@timestamp": {"type": "date"},
    "body": {"type": "text"},
}}

COMMON_WORDS = ["images", "french", "english", "venues", "tickets", "news",
                "sport", "history", "results", "teams", "athletes", "medal",
                "schedule", "village", "torch", "ceremony", "host", "city",
                "official", "site", "main", "index", "home", "photos",
                "stories", "accueil", "francais", "anglais", "cgi", "bin"]
METHODS = ["get", "post", "head"]
EXTS = ["html", "gif", "jpg", "cgi", "htm"]
STATUS = ["200", "200", "200", "404", "500"]
VOCAB_SIZE = 4000
BODY_VOCAB = 20000
LONG_BODY_TERMS = 300
T0_MILLIS = 1420070400000          # 2015-01-01T00:00:00Z
SPAN_MILLIS = 30 * 86400 * 1000    # one month of logs


def vocab() -> list[str]:
    return COMMON_WORDS + [f"p{i:05d}" for i in range(VOCAB_SIZE)]


def zipf_weights(n: int) -> np.ndarray:
    w = 1.0 / (np.arange(n) + 3.0) ** 0.9
    return w / w.sum()


def _paths(rng: np.random.Generator, n: int) -> list[list[str]]:
    """The URL paths of an `n`-doc corpus, as token lists: 2-5 Zipf path
    words and an extension. The first draws of make_docs' generator."""
    words = np.asarray(vocab())
    n_paths = max(n // 25, 400)
    path_len = rng.integers(2, 6, size=n_paths)
    path_words = rng.choice(len(words), size=(n_paths, 5),
                            p=zipf_weights(len(words)))
    path_ext = rng.integers(0, len(EXTS), size=n_paths)
    return [[str(w) for w in words[path_words[i, :path_len[i]]]]
            + [EXTS[path_ext[i]]] for i in range(n_paths)]


def corpus_paths(n: int, seed: int = 42) -> list[list[str]]:
    """The paths make_docs(n, seed) draws its messages from."""
    return _paths(np.random.default_rng(seed), n)


def make_docs(n: int, seed: int = 42, start: int = 0,
              long_every: int = 1000) -> list[tuple[str, dict]]:
    """`n` documents with ids start..start+n-1."""
    rng = np.random.default_rng(seed)
    paths = [" ".join(p) for p in _paths(rng, n)]
    n_paths = len(paths)
    pick = np.minimum((rng.pareto(1.2, size=n) + 1.0).astype(np.int64) - 1,
                      n_paths - 1)
    method = rng.integers(0, len(METHODS), size=n)
    code = rng.integers(0, len(STATUS), size=n)
    status = rng.integers(0, len(STATUS), size=n)
    size = rng.integers(100, 100_001, size=n)
    ts = T0_MILLIS + rng.integers(0, SPAN_MILLIS, size=n)
    body_w = zipf_weights(BODY_VOCAB)
    body_len = rng.integers(2, 5, size=n)
    body_ids = rng.choice(BODY_VOCAB, size=(n, 4), p=body_w)
    docs = []
    for i in range(n):
        doc_id = start + i
        if long_every and doc_id % long_every == long_every - 1:
            ids = rng.choice(BODY_VOCAB, size=LONG_BODY_TERMS, replace=False)
        else:
            ids = body_ids[i, :body_len[i]]
        docs.append((str(doc_id), {
            "message": f"{METHODS[method[i]]} {paths[pick[i]]} "
                       f"{STATUS[code[i]]}",
            "status": STATUS[status[i]],
            "size": int(size[i]),
            "@timestamp": int(ts[i]),
            "body": " ".join(f"b{j:05d}" for j in ids),
        }))
    return docs


def head_terms(rng: np.random.Generator, n: int, k_max: int = 3
               ) -> list[str]:
    """`n` match texts of 1..k_max Zipf-picked head words."""
    words = vocab()
    head = words[: max(len(words) // 8, 30)]
    w = zipf_weights(len(head))
    return [" ".join(head[j] for j in rng.choice(len(head),
                                                 size=rng.integers(1, k_max + 1),
                                                 p=w))
            for _ in range(n)]


def phrase_texts(rng: np.random.Generator, paths: list[list[str]], n: int
                 ) -> list[list[str]]:
    """`n` runs of 2-3 consecutive tokens of Pareto-picked (popular)
    paths, so most phrases match."""
    pick = np.minimum((rng.pareto(1.2, size=n) + 1.0).astype(np.int64) - 1,
                      len(paths) - 1)
    out = []
    for i in range(n):
        toks = paths[pick[i]]
        m = int(rng.integers(2, 4))
        s0 = int(rng.integers(0, len(toks) - m + 1))
        out.append(toks[s0:s0 + m])
    return out


def request_mixes(n: int, seed: int = 7, n_docs: int = 1 << 20,
                  doc_seed: int = 42) -> dict[str, list[dict]]:
    """The request mixes of the main path, `n` requests each:
    (a) match on message, 1-3 head terms (forward-index scoring; the
        fused bundle engine);
    (b) bool must-match + range filter on size + terms filter on status,
        with terms(status)->sum(size) and a daily date_histogram (the
        keyword terms filter keeps it off the fused engine);
    (c) prefix on message over tail words (posting scatter, many terms);
    (d) term on body (posting scatter on a field without forward index);
    (e) size 0, a range filter and aggregations only;
    (f) match_range_aggs: bool must-match + range filter on size with
        (b)'s aggs, size 10 (the fused engine with the match mask);
    (g) count_match: match on message, size 0, terms on status (the
        fused engine's mask-only grid).
    (h) phrase: match_phrase on message, slop 0 (the fused engine's
        exact-phrase leaf);
    (i) phrase_slop_aggs: bool must match_phrase with slop 1-2 (every
        other one with two words swapped) + range filter on size, with
        (b)'s aggs (the fused engine with the match mask, sloppy leaf);
    (j) span_near: span_near of 2-3 span_terms on message, in_order
        alternating, slop 0-2 (the ordered and unordered span leaves);
    (k) cross_fields: multi_match type cross_fields over message, 1-3
        head terms (the BM25F leaf);
    (l) phrase_filter: bool must match_phrase + terms filter on status
        (the keyword terms filter keeps it off the fused engine: the
        unfused positional leaf);
    (m) stats_aggs: size 0, a range filter on size, terms(status) ->
        extended_stats(size) and a stats(size) agg (a dashboard's
        per-status size panel: min / max-bearing metrics keep the
        doc-space bucket sums, the stats agg the row sums).
    Phrases are 2-3 consecutive tokens of the paths of make_docs(n_docs,
    doc_seed). (f)-(g), (h)-(l) and (m) each draw from a generator of
    their own, so earlier mixes are the same requests for a seed whatever
    the later ones hold."""
    rng = np.random.default_rng(seed)
    texts = head_terms(rng, 2 * n)
    body_w = zipf_weights(BODY_VOCAB)
    aggs = {"by_status": {"terms": {"field": "status"},
                          "aggs": {"bytes": {"sum": {"field": "size"}}}},
            "per_day": {"date_histogram": {"field": "@timestamp",
                                           "interval": "day"}}}
    mixes: dict[str, list[dict]] = {"match": [], "bool_aggs": [],
                                    "prefix": [], "term_body": [],
                                    "aggs_only": []}
    for i in range(n):
        mixes["match"].append({"query": {"match": {"message": texts[i]}},
                               "size": 10})
        lo = int(rng.integers(100, 60_000))
        mixes["bool_aggs"].append({
            "query": {"bool": {
                "must": [{"match": {"message": texts[n + i]}}],
                "filter": [{"range": {"size": {"gte": lo,
                                               "lte": lo + 40_000}}},
                           {"terms": {"status": ["200", "404"]}}]}},
            "aggs": aggs, "size": 10})
        mixes["prefix"].append({
            "query": {"prefix": {"message": f"p0{int(rng.integers(1, 4))}"
                                            f"{int(rng.integers(0, 10))}"}},
            "size": 10})
        term = int(rng.choice(BODY_VOCAB, p=body_w))
        mixes["term_body"].append({"query": {"term": {"body": f"b{term:05d}"}},
                                   "size": 10})
        mixes["aggs_only"].append({
            "query": {"range": {"size": {"gte": lo}}},
            "aggs": {"by_status": {"terms": {"field": "status"},
                                   "aggs": {"avg_size": {"avg": {
                                       "field": "size"}}}},
                     "per_day": aggs["per_day"]},
            "size": 0})
    rng2 = np.random.default_rng([seed, 2])
    texts2 = head_terms(rng2, 2 * n)
    mixes["match_range_aggs"] = []
    mixes["count_match"] = []
    for i in range(n):
        lo = int(rng2.integers(100, 60_000))
        mixes["match_range_aggs"].append({
            "query": {"bool": {
                "must": [{"match": {"message": texts2[i]}}],
                "filter": [{"range": {"size": {"gte": lo,
                                               "lte": lo + 40_000}}}]}},
            "aggs": aggs, "size": 10})
        mixes["count_match"].append({
            "query": {"match": {"message": texts2[n + i]}},
            "aggs": {"by_status": {"terms": {"field": "status"}}},
            "size": 0})
    rng3 = np.random.default_rng([seed, 3])
    paths = corpus_paths(n_docs, doc_seed)
    phrases = phrase_texts(rng3, paths, 4 * n)
    heads = head_terms(rng3, n)
    for k in ("phrase", "phrase_slop_aggs", "span_near", "cross_fields",
              "phrase_filter"):
        mixes[k] = []
    for i in range(n):
        mixes["phrase"].append({
            "query": {"match_phrase": {"message": " ".join(phrases[i])}},
            "size": 10})
        words = list(phrases[n + i])
        if i % 2:
            words[0], words[1] = words[1], words[0]
        lo = int(rng3.integers(100, 60_000))
        mixes["phrase_slop_aggs"].append({
            "query": {"bool": {
                "must": [{"match_phrase": {"message": {
                    "query": " ".join(words),
                    "slop": int(rng3.integers(1, 3))}}}],
                "filter": [{"range": {"size": {"gte": lo,
                                               "lte": lo + 40_000}}}]}},
            "aggs": aggs, "size": 10})
        mixes["span_near"].append({
            "query": {"span_near": {
                "clauses": [{"span_term": {"message": w}}
                            for w in phrases[2 * n + i]],
                "slop": int(rng3.integers(0, 3)),
                "in_order": i % 2 == 0}},
            "size": 10})
        mixes["cross_fields"].append({
            "query": {"multi_match": {"query": heads[i],
                                      "type": "cross_fields",
                                      "fields": ["message"]}},
            "size": 10})
        mixes["phrase_filter"].append({
            "query": {"bool": {
                "must": [{"match_phrase": {
                    "message": " ".join(phrases[3 * n + i])}}],
                "filter": [{"terms": {"status": ["200", "404"]}}]}},
            "size": 10})
    rng4 = np.random.default_rng([seed, 4])
    mixes["stats_aggs"] = []
    for _ in range(n):
        lo = int(rng4.integers(100, 60_000))
        mixes["stats_aggs"].append({
            "query": {"range": {"size": {"gte": lo, "lte": lo + 40_000}}},
            "aggs": {"by_status": {"terms": {"field": "status"},
                                   "aggs": {"size_stats": {
                                       "extended_stats": {
                                           "field": "size"}}}},
                     "size_stats": {"stats": {"field": "size"}}},
            "size": 0})
    return mixes


def synthetic_positions(rng: np.random.Generator, tids: np.ndarray, P: int
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A positions pack for a synthetic forward index `tids` [cap, L]:
    every filled slot gets 1..P ascending positions below about 3 * L,
    delta-encoded as index/segment.pack_positions stores them (first
    absolute, then gaps, pad -1), plus k1ln / lnorm from random doc
    lengths. Returns (fwd_pos [cap, L*P] int16, k1ln, lnorm)."""
    from .index.segment import bm25_norms
    cap, L = tids.shape
    tf = rng.integers(1, P + 1, size=(cap, L))
    deltas = np.concatenate([rng.integers(0, 2 * L, size=(cap, L, 1)),
                             rng.integers(1, 3, size=(cap, L, P - 1))],
                            axis=2)
    keep = (np.arange(P)[None, None, :] < tf[..., None]) \
        & (tids[..., None] >= 0)
    fwd_pos = np.where(keep, deltas, -1).astype(np.int16).reshape(cap, L * P)
    doc_len = rng.integers(1, 4 * L, size=cap).astype(np.float32)
    lnorm, k1ln = bm25_norms(doc_len, float(doc_len.mean()))
    return fwd_pos, k1ln, lnorm


def passage_mapping(dims: int, similarity: str = "cosine") -> dict:
    return {"properties": {
        "passage": {"type": "text"},
        "embedding": {"type": "dense_vector", "dims": dims,
                      "similarity": similarity},
    }}


def _dyadic_queries(rng: np.random.Generator, n: int, dims: int
                    ) -> np.ndarray:
    m = 1 if dims < 16 else 2
    q = np.zeros((n, dims), dtype=np.float32)
    for i in range(n):
        idx = rng.choice(dims, size=4 ** m, replace=False)
        q[i, idx] = rng.choice([-1.0, 1.0], size=4 ** m)
    return q


def passage_columns(n: int, dims: int, seed: int = 23,
                    dyadic: bool = False, n_centers: int = 1024,
                    center_seed: int | None = None
                    ) -> tuple[list[str], np.ndarray, np.ndarray]:
    """`n` passages as columns: (texts, embeddings f32 [n, dims], centers
    f32 [n_centers, dims]; empty when dyadic). The centers come from
    `center_seed` (default `seed`): shards drawn with one center seed
    share one embedding space."""
    rng = np.random.default_rng(seed)
    words = np.asarray(vocab())
    w = zipf_weights(len(words))
    lens = rng.integers(20, 61, size=n)
    toks = rng.choice(len(words), size=int(lens.sum()), p=w)
    ends = np.cumsum(lens)
    texts = [" ".join(words[toks[e - ln:e]]) for e, ln in zip(ends, lens)]
    if dyadic:
        emb = rng.integers(-4, 5, size=(n, dims)).astype(np.float32)
        return texts, emb, np.zeros((0, dims), np.float32)
    centers = (rng if center_seed is None
               else np.random.default_rng(center_seed)).standard_normal(
        (n_centers, dims)).astype(np.float32)
    emb = np.empty((n, dims), dtype=np.float32)
    for lo in range(0, n, 1 << 18):
        hi = min(lo + (1 << 18), n)
        emb[lo:hi] = centers[rng.integers(0, n_centers, hi - lo)] \
            + rng.standard_normal((hi - lo, dims)).astype(np.float32) \
            * np.float32(0.2)
    return texts, emb, centers


def make_passages(n: int, dims: int, seed: int = 23, start: int = 0,
                  dyadic: bool = False, n_centers: int = 1024,
                  missing_every: int = 0) -> list[tuple[str, dict]]:
    """`n` passage documents with ids start..start+n-1; with
    `missing_every`, every such doc has no embedding."""
    texts, emb, _c = passage_columns(n, dims, seed, dyadic, n_centers)
    docs = []
    for i in range(n):
        doc = {"passage": texts[i]}
        if not (missing_every and (start + i) % missing_every
                == missing_every - 1):
            doc["embedding"] = [float(x) for x in emb[i]]
        docs.append((str(start + i), doc))
    return docs


def passage_queries(n: int, dims: int, seed: int = 29,
                    dyadic: bool = False, near: np.ndarray | None = None
                    ) -> np.ndarray:
    """`n` query vectors [n, dims] f32: dyadic, or rows of `near` (a
    corpus's embeddings) plus Gaussian noise, or plain Gaussian."""
    rng = np.random.default_rng(seed)
    if dyadic:
        return _dyadic_queries(rng, n, dims)
    if near is not None:
        rows = near[rng.integers(0, near.shape[0], n)]
        return (rows + rng.standard_normal((n, dims)).astype(np.float32)
                * np.float32(0.1)).astype(np.float32)
    return rng.standard_normal((n, dims)).astype(np.float32)


def knn_mixes(queries: np.ndarray, n: int, seed: int = 31
              ) -> dict[str, list[dict]]:
    """The vector request mixes, `n` requests each, query vector i from
    `queries` (cycled):
    (a) knn: a top-level `knn` section, k 10 (pure knn: the IVF probe or
        the exact scan);
    (b) hybrid: the same beside a `match` on `passage` of 1-3 head terms
        (rewritten into a bool of the match and a knn clause: K3 with a
        knn_vec clause);
    (c) knn_rescore: a `knn` query node, size 10, rescored over a window
        of 100 by a `match` on `passage` (BASELINE config 5's shape)."""
    rng = np.random.default_rng(seed)
    texts = head_terms(rng, 2 * n)
    qs = [[float(x) for x in queries[i % len(queries)]] for i in range(n)]
    mixes: dict[str, list[dict]] = {"knn": [], "hybrid": [],
                                    "knn_rescore": []}
    for i in range(n):
        spec = {"field": "embedding", "query_vector": qs[i], "k": 10}
        mixes["knn"].append({"knn": dict(spec), "size": 10})
        mixes["hybrid"].append({
            "knn": dict(spec),
            "query": {"match": {"passage": texts[i]}}, "size": 10})
        mixes["knn_rescore"].append({
            "query": {"knn": {"field": "embedding",
                              "query_vector": qs[i]}},
            "size": 10,
            "rescore": {"window_size": 100, "query": {
                "rescore_query": {"match": {"passage": texts[n + i]}},
                "query_weight": 1.0, "rescore_query_weight": 1.0}}})
    return mixes


DSL_MIXES = ("query_string", "compound", "multi_term", "function_score",
             "exists_ids", "more_like_this", "bucket_aggs", "top_hits_sig")


def dsl_mixes(n: int, seed: int = 11, n_ids: int = 1 << 21
              ) -> dict[str, list[dict]]:
    """The query-DSL mixes, `n` requests each, over make_docs corpora
    whose ids lie in [0, n_ids):
    query_string: `message:` terms joined by AND / OR / NOT (bools over
        message terms: the fused engine);
    compound: filtered / and / or / not / dis_max / boosting over
        message matches and size ranges (fused and unfused plans);
    multi_term: wildcard / regexp / fuzzy on message (term expansions:
        posting scatter) and wildcard / regexp on status (keyword
        ordinal sets); fuzzy, which runs an edit distance against every
        term, is one request in sixteen;
    function_score: a message match under field_value_factor on size
        (log1p), gauss on @timestamp with an explicit origin, a filtered
        weight and random_score, score_mode sum (unfused);
    exists_ids: exists / missing on body and size, and ids of 100 ids;
    more_like_this: like-text only, at most 6 query terms (a one-clause
        should: the fused engine);
    bucket_aggs: size 0 under a message match: filters on status, range
        on size, date_range on @timestamp, missing on body and global,
        each with a terms or avg sub-aggregation;
    top_hits_sig: a message match with top_hits (3) and
        significant_terms on status."""
    rng = np.random.default_rng(seed)
    words = vocab()
    head = words[: max(len(words) // 8, 30)]
    w = zipf_weights(len(head))

    def pick(k: int) -> list[str]:
        return [head[j] for j in rng.choice(len(head), size=k, replace=False,
                                            p=w)]

    mixes: dict[str, list[dict]] = {k: [] for k in DSL_MIXES}
    for i in range(n):
        a, b, c = pick(3)
        form = i % 3
        q = (f"message:{a} AND message:{b}" if form == 0 else
             f"message:{a} OR message:{b}" if form == 1 else
             f"message:{a} OR message:{b} NOT message:{c}")
        mixes["query_string"].append(
            {"query": {"query_string": {"query": q}}, "size": 10})
        lo = int(rng.integers(100, 60_000))
        rng_q = {"range": {"size": {"gte": lo, "lte": lo + 40_000}}}
        match = {"match": {"message": f"{a} {b}"}}
        form = i % 6
        q = ({"filtered": {"query": match, "filter": rng_q}} if form == 0 else
             {"and": [match, rng_q]} if form == 1 else
             {"or": [{"match": {"message": a}}, rng_q]} if form == 2 else
             {"bool": {"must": [match], "must_not": [
                 {"not": {"range": {"size": {"gte": lo}}}}]}} if form == 3
             else {"dis_max": {"queries": [{"match": {"message": a}},
                                           {"match": {"message": b}}]}}
             if form == 4 else
             {"boosting": {"positive": match, "negative": rng_q,
                           "negative_boost": 0.25}})
        mixes["compound"].append({"query": q, "size": 10})
        d1, d2 = (int(x) for x in rng.integers(0, 10, size=2))
        st = STATUS[int(rng.integers(0, len(STATUS)))]
        form = i % 16
        q = ({"wildcard": {"message": f"p0{d1}{d2}*"}} if form < 4 else
             {"regexp": {"message": f"p00{d1}[0-9]{d2}"}} if form < 8
             else {"fuzzy": {"message": {"value": f"p00{d1}{d2}7",
                                         "fuzziness": 1}}} if form == 8
             else {"wildcard": {"status": f"{st[0]}*"}} if form < 13
             else {"regexp": {"status": f"{st[0]}0[0-9]"}})
        mixes["multi_term"].append({"query": q, "size": 10})
        day = int(rng.integers(1, 29))
        mixes["function_score"].append({"query": {"function_score": {
            "query": {"match": {"message": f"{a} {b}"}},
            "functions": [
                {"field_value_factor": {"field": "size", "factor": 0.001,
                                        "modifier": "log1p"}},
                {"gauss": {"@timestamp": {
                    "origin": f"2015-01-{day:02d}T12:00:00",
                    "scale": "3d", "decay": 0.5}}},
                {"filter": {"term": {"status": "404"}},
                 "weight": float(1 + i % 4)},
                {"random_score": {"seed": int(rng.integers(0, 2 ** 32))}}],
            "score_mode": "sum"}}, "size": 10})
        form = i % 5
        field = "body" if i % 2 else "size"
        q = ({"exists": {"field": field}} if form in (0, 1) else
             {"missing": {"field": field}} if form in (2, 3) else
             {"ids": {"values": [str(int(x)) for x in
                                 rng.integers(0, n_ids, size=100)]}})
        mixes["exists_ids"].append({"query": q, "size": 10})
        mixes["more_like_this"].append({"query": {"more_like_this": {
            "fields": ["message"], "like": " ".join(pick(5)),
            "min_term_freq": 1, "min_doc_freq": 1, "max_query_terms": 6}},
            "size": 10})
        mixes["bucket_aggs"].append({
            "query": {"match": {"message": a}}, "size": 0, "aggs": {
                "by_status": {"filters": {"filters": {
                    s: {"term": {"status": s}} for s in ("200", "404",
                                                         "500")}},
                    "aggs": {"avg_size": {"avg": {"field": "size"}}}},
                "sizes": {"range": {"field": "size", "ranges": [
                    {"to": lo}, {"from": lo, "to": lo + 40_000},
                    {"from": lo + 40_000}]},
                    "aggs": {"st": {"terms": {"field": "status"}}}},
                "days": {"date_range": {"field": "@timestamp", "ranges": [
                    {"to": f"2015-01-{day:02d}"},
                    {"from": f"2015-01-{day:02d}"}]},
                    "aggs": {"avg_size": {"avg": {"field": "size"}}}},
                "no_body": {"missing": {"field": "body"},
                            "aggs": {"avg_size": {"avg": {
                                "field": "size"}}}},
                "all": {"global": {},
                        "aggs": {"st": {"terms": {"field": "status"}}}}}})
        mixes["top_hits_sig"].append({
            "query": {"match": {"message": f"{a} {b}"}}, "size": 10,
            "aggs": {"top": {"top_hits": {"size": 3}},
                     "sig": {"significant_terms": {"field": "status",
                                                   "min_doc_count": 1}}}})
    return mixes


SCRIPT_MIXES = ("script_filter", "script_score", "script_sort", "script_aggs",
                "pctl_card")


def script_mixes(n: int, seed: int = 13) -> dict[str, list[dict]]:
    """The script and device metric agg mixes, `n` requests each:
    script_filter: a message match with a script filter over size and
        status (a keyword, which a device script reads as the missing
        value 0) with params;
    script_score: function_score over a message match with a script_score
        of `_score`, a param and tanh (XLA's own approximation);
    script_sort: a message match sorted by a `_script` key, descending;
    script_aggs: size 0 under a message match: terms on status with an avg
        over a script (the reference runs a bucket's script sub-metric as
        a missing field: null), stats over a script with params and a
        scripted_metric;
    pctl_card: size 0 under a size range: percentiles and
        percentile_ranks of size and cardinality of status, exact and
        with precision_threshold 1 (the HLL sketch), top-level and in
        daily date_range buckets (the reference takes these metric kinds
        under derived bucket aggs, not under terms or date_histogram)."""
    rng = np.random.default_rng(seed)
    words = vocab()
    head = words[: max(len(words) // 8, 30)]
    w = zipf_weights(len(head))
    mixes: dict[str, list[dict]] = {k: [] for k in SCRIPT_MIXES}
    for i in range(n):
        a, b = (head[j] for j in rng.choice(len(head), size=2,
                                            replace=False, p=w))
        lo = int(rng.integers(100, 60_000))
        match = {"match": {"message": f"{a} {b}"}}
        mixes["script_filter"].append({"query": {"bool": {
            "must": [match],
            "filter": [{"script": {"script": {
                "source": "doc['size'].value > params.lo && "
                          "doc['size'].value < params.hi "
                          "+ doc['status'].value",
                "params": {"lo": lo, "hi": lo + 40_000}}}}]}},
            "size": 10})
        mixes["script_score"].append({"query": {"function_score": {
            "query": match,
            "functions": [{"script_score": {"script": {
                "source": "_score * params.w + Math.tanh("
                          "doc['size'].value / params.s)",
                "params": {"w": 0.5 + (i % 4) * 0.25, "s": 50_000}}}}],
            "boost_mode": "replace"}}, "size": 10})
        mixes["script_sort"].append({
            "query": {"match": {"message": a}}, "size": 10,
            "sort": [{"_script": {"type": "number", "order": "desc",
                                  "script": {
                                      "source": "doc['size'].value % "
                                                "params.m - params.c",
                                      "params": {"m": 1000, "c": 500}}}}]})
        mixes["script_aggs"].append({
            "query": {"match": {"message": a}}, "size": 0, "aggs": {
                "by_status": {"terms": {"field": "status"}, "aggs": {
                    "avg_kb": {"avg": {"script": "doc['size'].value / 1024"}}}},
                "kb": {"stats": {"script": {
                    "source": "doc['size'].value / params.d",
                    "params": {"d": 1024}}}},
                "total_kb": {"scripted_metric": {
                    "map_script": "doc['size'].value * params.f",
                    "params": {"f": 0.001}}}}})
        day = int(rng.integers(1, 28))
        card = {"status_n": {"cardinality": {"field": "status"}},
                "status_hll": {"cardinality": {"field": "status",
                                               "precision_threshold": 1}}}
        pctl = {"size_p": {"percentiles": {"field": "size",
                                           "percents": [50, 95, 99]}},
                "size_r": {"percentile_ranks": {
                    "field": "size", "values": [lo, lo + 20_000]}}}
        mixes["pctl_card"].append({
            "query": {"range": {"size": {"gte": lo, "lte": lo + 40_000}}},
            "size": 0, "aggs": {
                **pctl, **card,
                "days": {"date_range": {"field": "@timestamp", "ranges": [
                    {"from": f"2015-01-{day:02d}",
                     "to": f"2015-01-{day + 1:02d}"},
                    {"from": f"2015-01-{day + 1:02d}",
                     "to": f"2015-01-{day + 2:02d}"}]},
                    "aggs": {**pctl, **card}}}})
    return mixes


# ---------------------------------------------------------------------------
# Joins: questions and answers, nested and parent / child
# ---------------------------------------------------------------------------

# Rally's `nested` track (StackOverflow questions, their answers as nested
# objects), its answers also carrying a text body and their score
QA_NESTED_MAPPING = {"properties": {
    "title": {"type": "text"},
    "user": {"type": "keyword"},
    "creationDate": {"type": "date"},
    "tag": {"type": "keyword"},
    "answer_count": {"type": "integer"},
    "answers": {"type": "nested", "properties": {
        "user": {"type": "keyword"},
        "date": {"type": "date"},
        "body": {"type": "text"},
        "score": {"type": "integer"}}},
}}
# the ES 2.0 `children` aggregation docs' question / answer types, as one
# join field: questions with tags and an owner, answers with an owner,
# a creation date, a body and a score
QA_JOIN_MAPPING = {"properties": {
    "qa": {"type": "join", "relations": {"question": "answer"}},
    "title": {"type": "text"},
    "body": {"type": "text"},
    "tags": {"type": "keyword"},
    "owner": {"type": "keyword"},
    "creation_date": {"type": "date"},
    "score": {"type": "integer"},
}}
QA_USERS = 50_000
QA_TAGS = 500
QA_MAX_ANSWERS = 8
QA_SPAN_MILLIS = 365 * 86400 * 1000     # one year of questions
QA_HOT_ANSWERS = 5000                   # answers of a hot question


def _qa_draws(n: int, seed: int, hot) -> dict:
    """The per-question draws both join corpora share: answer counts
    (0..QA_MAX_ANSWERS, `hot` = ((question index, answers), ...) with
    more), text words, users, tags, dates and answer scores."""
    rng = np.random.default_rng(seed)
    n_ans = rng.integers(0, QA_MAX_ANSWERS + 1, size=n)
    for i, k in hot:
        if i < n:
            n_ans[i] = k
    total = int(n_ans.sum())
    words = vocab()
    w = zipf_weights(len(words))
    title_len = rng.integers(3, 7, size=n)
    body_len = rng.integers(3, 9, size=total)
    return {
        "n_ans": n_ans, "words": words,
        "title": rng.choice(len(words), size=(n, 6), p=w),
        "title_len": title_len,
        "body": rng.choice(len(words), size=(total, 8), p=w),
        "body_len": body_len,
        "q_user": rng.choice(QA_USERS, size=n, p=zipf_weights(QA_USERS)),
        "a_user": rng.choice(QA_USERS, size=total, p=zipf_weights(QA_USERS)),
        "tags": rng.choice(QA_TAGS, size=(n, 3), p=zipf_weights(QA_TAGS)),
        "n_tags": rng.integers(1, 4, size=n),
        "q_date": T0_MILLIS + rng.integers(0, QA_SPAN_MILLIS, size=n),
        "a_delay": rng.integers(60_000, 30 * 86400 * 1000, size=total),
        # votes: mostly small, some negative
        "score": np.minimum(rng.geometric(0.3, size=total) - 3, 500),
    }


def _qa_text(d: dict, key: str, i: int, n: int) -> str:
    return " ".join(d["words"][j] for j in d[key][i, :n])


def qa_nested_docs(n: int, seed: int = 51, start: int = 0,
                   hot=((0, QA_HOT_ANSWERS),)) -> list[tuple[str, dict]]:
    """`n` questions (ids start..start+n-1), each with 0..QA_MAX_ANSWERS
    answers as nested objects (`hot` questions with more): a StackOverflow
    question's title, asker, creation date and 1-3 tags, each answer's
    user, date, body and score."""
    d = _qa_draws(n, seed, hot)
    docs = []
    a = 0
    for i in range(n):
        k = int(d["n_ans"][i])
        qd = int(d["q_date"][i])
        answers = [{"user": f"u{d['a_user'][a + j]}",
                    "date": qd + int(d["a_delay"][a + j]),
                    "body": _qa_text(d, "body", a + j,
                                     int(d["body_len"][a + j])),
                    "score": int(d["score"][a + j])} for j in range(k)]
        a += k
        docs.append((str(start + i), {
            "title": _qa_text(d, "title", i, int(d["title_len"][i])),
            "user": f"u{d['q_user'][i]}",
            "creationDate": qd,
            "tag": [f"t{t}" for t in d["tags"][i, :int(d["n_tags"][i])]],
            "answer_count": k,
            "answers": answers}))
    return docs


def qa_join_docs(n: int, seed: int = 52, start: int = 0,
                 hot=((0, QA_HOT_ANSWERS),)) -> list[tuple[str, dict, str]]:
    """`n` questions and their answers as parent / child documents of the
    `qa` join field: (id, source, routing), each question first, then its
    answers, routed by the question's id (its shard, as `_parent` routes
    a child)."""
    d = _qa_draws(n, seed, hot)
    docs = []
    a = 0
    for i in range(n):
        qid = f"q{start + i}"
        k = int(d["n_ans"][i])
        qd = int(d["q_date"][i])
        docs.append((qid, {
            "qa": "question",
            "title": _qa_text(d, "title", i, int(d["title_len"][i])),
            "owner": f"u{d['q_user'][i]}",
            "creation_date": qd,
            "tags": [f"t{t}" for t in d["tags"][i, :int(d["n_tags"][i])]]},
            qid))
        for j in range(k):
            docs.append((f"a{start + i}_{j}", {
                "qa": {"name": "answer", "parent": qid},
                "body": _qa_text(d, "body", a + j, int(d["body_len"][a + j])),
                "owner": f"u{d['a_user'][a + j]}",
                "creation_date": qd + int(d["a_delay"][a + j]),
                "score": int(d["score"][a + j])}, qid))
        a += k
    return docs


QA_NESTED_MIXES = ("nested_match", "nested_aggs")
QA_JOIN_MIXES = ("has_child", "has_parent", "parent_id", "children_agg")
NESTED_SCORE_MODES = ("none", "sum", "avg", "max", "min")


def mid_terms(rng: np.random.Generator, n: int, lo: int = 100,
              hi: int = 1000) -> list[str]:
    """`n` single words of the vocabulary's ranks lo..hi-1 (Zipf ranks:
    each in a few hundredths of a percent of the tokens)."""
    words = vocab()
    return [words[j] for j in rng.integers(lo, hi, size=n)]


def qa_nested_mixes(n: int, seed: int = 53) -> dict[str, list[dict]]:
    """The nested mixes, `n` requests each:
    nested_match: a match of 1-2 head words on the answers' body under
        `nested`, score modes none / sum / avg / max / min in turn, every
        fifth inside a bool beside a title match with a boost; ids and
        scores only (`_source` false: a hot question's source carries
        thousands of answers);
    nested_aggs: size 0 under a title match: a nested agg over the
        answers -> terms on the answer's user and a monthly
        date_histogram of its date, with reverse_nested -> terms on the
        question's tags.
    Smoke checks of the nested paths, not a model of users' traffic: no
    published source gives these queries' words or their mix."""
    rng = np.random.default_rng(seed)
    texts = head_terms(rng, 2 * n, k_max=2)
    mixes: dict[str, list[dict]] = {k: [] for k in QA_NESTED_MIXES}
    for i in range(n):
        nested = {"nested": {
            "path": "answers",
            "score_mode": NESTED_SCORE_MODES[i % len(NESTED_SCORE_MODES)],
            "query": {"match": {"answers.body": texts[2 * i]}}}}
        if i % 5 == 4:
            nested["nested"]["boost"] = 1.7
            q = {"bool": {"must": [nested],
                          "should": [{"match": {"title": texts[2 * i + 1]}}]}}
        else:
            q = nested
        mixes["nested_match"].append({"query": q, "size": 10,
                                      "_source": False})
        mixes["nested_aggs"].append({
            "query": {"match": {"title": texts[2 * i + 1]}}, "size": 0,
            "aggs": {"answers": {"nested": {"path": "answers"}, "aggs": {
                "by_user": {"terms": {"field": "answers.user", "size": 5}},
                "by_month": {"date_histogram": {"field": "answers.date",
                                                "interval": "month"}},
                "questions": {"reverse_nested": {}, "aggs": {
                    "tags": {"terms": {"field": "tag", "size": 5}}}}}}}})
    return mixes


def qa_join_mixes(n: int, seed: int = 54, n_questions: int = 1 << 18
                  ) -> dict[str, list[dict]]:
    """The parent / child mixes, `n` requests each:
    has_child: questions with at least 2 answers matching one of 2 words
        of the vocabulary's ranks 100-999 in their body (min_children 2);
    has_parent: answers of the questions asked by one user (of the 2,000
        most active);
    parent_id: the answers of one question (ids 0..n_questions-1);
    children_agg: size 0 under a title match of a word of ranks 30-299:
        a children agg over the answers -> terms on their owner and the
        top score.
    Smoke checks of the parent / child paths, not a model of users'
    traffic: no published source gives their selectivity, and the words'
    ranks were chosen so that the host's join resolution of a batch of
    256 fits a whole chip_smoke run."""
    rng = np.random.default_rng(seed)
    words = mid_terms(rng, 2 * n)
    titles = mid_terms(rng, n, lo=30, hi=300)
    texts = [f"{words[2 * i]} {words[2 * i + 1]}" for i in range(n)]
    users = rng.integers(0, 2000, size=n)
    qids = rng.integers(0, n_questions, size=n)
    mixes: dict[str, list[dict]] = {k: [] for k in QA_JOIN_MIXES}
    for i in range(n):
        mixes["has_child"].append({"query": {"has_child": {
            "type": "answer", "min_children": 2,
            "query": {"match": {"body": texts[i]}}}}, "size": 10})
        mixes["has_parent"].append({"query": {"has_parent": {
            "parent_type": "question",
            "query": {"term": {"owner": f"u{users[i]}"}}}}, "size": 10})
        mixes["parent_id"].append({"query": {"parent_id": {
            "type": "answer", "id": f"q{qids[i]}"}}, "size": 10})
        mixes["children_agg"].append({
            "query": {"match": {"title": titles[i]}}, "size": 0,
            "aggs": {"answers": {"children": {"type": "answer"}, "aggs": {
                "owners": {"terms": {"field": "owner", "size": 5}},
                "top": {"max": {"field": "score"}}}}}})
    return mixes
