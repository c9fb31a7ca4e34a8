"""Seeded http_logs-like corpus and request mixes.

The same generator shape as the repository's benchmark corpus (a Zipf
vocabulary of path words, Pareto-skewed popular paths, http methods and
status codes), written with numpy `Generator`s so a 2^20-doc shard can be
made in seconds. Documents carry `message` (text), `status` (keyword),
`size` (long), `@timestamp` (date, epoch millis) and `body` (text); one
document in `long_every` has a `body` of more than 256 distinct terms, so
the `body` field gets no forward index and its term queries take the
posting-scatter path.
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


def make_docs(n: int, seed: int = 42, start: int = 0,
              long_every: int = 1000) -> list[tuple[str, dict]]:
    """`n` documents with ids start..start+n-1."""
    rng = np.random.default_rng(seed)
    words = np.asarray(vocab())
    n_paths = max(n // 25, 400)
    path_len = rng.integers(2, 6, size=n_paths)
    path_words = rng.choice(len(words), size=(n_paths, 5),
                            p=zipf_weights(len(words)))
    path_ext = rng.integers(0, len(EXTS), size=n_paths)
    paths = [" ".join(list(words[path_words[i, :path_len[i]]])
                      + [EXTS[path_ext[i]]]) for i in range(n_paths)]
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


def request_mixes(n: int, seed: int = 7) -> dict[str, list[dict]]:
    """The seven request mixes of the main path, `n` requests each:
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
    (f) and (g) draw from their own generator, so (a)-(e) are the same
    requests for a seed whatever (f) and (g) hold."""
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
    return mixes
