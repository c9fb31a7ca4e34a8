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
