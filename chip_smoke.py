#!/usr/bin/env python3
"""Drive the PyTorch port of the search engine on one NVIDIA GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs one
CUDA device and exits non-zero, printing no result, without one. Phases,
each of which fails the run on any error:

1. device: the card's name and power limit as nvidia-smi reports them;
2. build: the hand-written CUDA kernels of `elasticsearch_tpu_torch/ops`
   compiled from their sources with nvcc for sm_90a;
3. kernels (in a process of its own on the card, beside the node ingest
   of phase 7): each kernel held bit-exact (`torch.equal`) against its
   plain PyTorch version at the slice's shapes, with kernel / plain / library
   times (CUDA events) and the card's least time for the same work (K3,
   the fused bundle walk: one to three clauses, with and without a range
   filter, k 10 and 100, the match mask on and off, the mask-only grid;
   its positional leaf: exact and sloppy phrases, ordered and unordered
   spans, BM25F over two fields; the unfused positional leaf entry; the
   positional rows against their plain versions on their first 16 rows;
   K1 on random term ids (few pairs share a term) and on a small
   vocabulary (most pairs do), with the share of pairs its signature
   filter lets through; K2 also at the main path's prefix shape, B 128
   x 262,144 postings; the agg kernels, not ports of a TPU kernel: the
   scan `ordered_prefix` (a keyword sort, a timestamp sort, no perm),
   the tree `ordered_sum` (the views' blocks, whole rows, rows off a
   power of two) and the bucket stats `ordered_bucket_stats` (sum, sum
   of squares, count, min, max: XLA's scatter results), at B 256 over
   2^20 docs drawn like the agg mixes' inputs, with the add's dependent
   latency measured by a one-thread chain, the bucket stats' bound; and
   all three on rows of subnormals, signed zeros and normal values whose
   sums cancel into the subnormal range, bit for bit their plain
   versions, which flush as XLA's CPU runtime does);
   then K3's launch forms on `match` and `phrase_pos:2:e` bundles: the
   stepped walk (8 launches, the threshold carried) equal to the single
   launch and to the plain stepped walk, the seeded walk (a 2^17-doc
   delta opened at a base walk's k-th best) equal to its plain version,
   and a stepped walk whose check flips at chunk 4 launching K3 4 times;
4. main paths: two shards of 2^20 http_logs-like docs (seeds 42, 43),
   the node's compacted bases (phase 7), request mixes of 256 requests
   through `ShardReader.msearch` + `merge_shard_results`: the earlier
   slices' seven mixes and stats_aggs (terms -> extended_stats and a
   stats agg: the bucket stats), then the positional mixes (phrase,
   sloppy phrase with aggs, span_near, cross_fields, phrase with a
   keyword filter), each path run with the launch counts zeroed just
   before it; each path's kernels must have launched, the fused engine
   must admit exactly the plans of the fused mixes (the positional ones
   carrying a positional clause, none falling back to the host), the
   first 64 requests with the plain versions swapped in must give identical
   responses, a small index searched on the card must give the CPU's
   responses exactly (every agg sum, terms -> stats / extended_stats and
   stats aggs included), each kernel must equal its plain version on
   the inputs the main path handed it (the scan kernel on every agg
   mix's first call of each permutation kind), and stats_aggs' profiled
   batch must spend no device time in `scatter_reduce_` / `index_add_`
   (its doc-space metrics are the bucket stats kernel's); the `match` mix is
   also timed on the unfused path (`ES_TPU_FUSED=0`), and 16 requests of the
   positional mixes on the host oracle (`ES_TPU_POSITIONAL=0`, the
   phrase / span / BM25F code of search/phrase.py through K2), whose
   responses must be identical, with matches in every mix compared;
5. the delta path: per shard a delta segment of 2^17 docs (seeds 142,
   143; built in 2 workers beside the node ingest, with the small
   index's shards) beside the shard's segment as its base, `match`,
   `match_range_aggs`, `count_match` and `phrase` through the base+delta
   pack dispatch (the agg mixes 64 requests per msearch, DELTA_BATCH;
   every fused group must go as one pack, K3's seeded form must launch),
   then with `ES_TPU_PACK_DISPATCH=0` in turns, responses identical;
6. the resident path: `match` and `phrase` on the main index with
   `ES_TPU_RESIDENT_LOOP=1` and a far deadline (K3's stepped form must
   launch, responses identical to the cold path's, resident hits > 0),
   timed in turns with the cold path; then a batch whose deadline has
   passed and one whose poll flips at chunk 4 must each raise
   SearchTimeoutError and count as preempted;
6b. the query DSL (path u), on the main index: eight mixes of
   `corpus.dsl_mixes` (query_string, compound, multi_term,
   function_score, exists_ids, more_like_this, bucket_aggs with 10
   derived buckets a request, 64 requests an msearch, top_hits_sig), a
   warm-up batch and one timed batch each inside a profiler session of
   its own (the card's activity alone: a `dsl mix` line
   with req/s, p50, device busy ms and idle share), the launch counts
   zeroed just before; K3, K1, K2 and the scan must launch, query_string
   and more_like_this must be admitted to K3 and function_score rejected
   as `clause:fnscore`; the first 32 requests of each mix with the plain
   versions swapped in give identical responses; 16 requests a mix on
   the small index give the CPU's responses exactly (function_score's
   exp / log are XLA's, computed op by op: ops/xla_math); a 2-shard
   node of 3,000 docs a shard answers query_string, function_score and
   bucket_aggs over HTTP _msearch and `GET /logs/_search?q=` as its
   engines' readers do;
6c. scripts and the device metric aggs (path v), on the same index: five
   mixes of `corpus.script_mixes` (script_filter: a match with a script
   filter over size and status with params; script_score: function_score
   of `_score`, a param and tanh; script_sort: a match sorted by
   `_script`; script_aggs: terms(status) -> avg over a script, stats over
   a script and a scripted_metric; pctl_card: percentiles and
   percentile_ranks of size and cardinality of status, exact and with
   precision_threshold 1 (the HLL sketch), top-level and in two daily
   date_range buckets), a warm-up of 32 requests a mix and one timed
   batch each in a profiler session of its own (`script mix` lines as
   path (u)'s),
   the counts zeroed just before; K1, the bucket stats (the HLL
   registers' max fold), the scan and the tree must launch, script
   clauses and function_score must be rejected by the fused engine; the
   first 32 requests of each mix with the plain versions swapped in give
   identical responses, and 8 pctl_card requests' HLL registers are
   `torch.equal` to the plain version's; 16 requests a mix on the small
   index give the CPU's responses exactly. After the scroll (beside the
   kill -9 and small node workers, `script node` line): a
   durable 2-shard node of 2,000 docs a shard over HTTP stores a script
   (`PUT /_scripts/size_kb`), serves a search filtered and sorted by it
   as its readers do, runs an `_update` with a script, and after a
   restart (the process's registry emptied) has the script back from
   scripts.json and answers with the same hits;
7. the node path: the main path's index comes from a `Node` on the card
   behind a loopback `RestServer` (index `logs`, 2 shards, the streaming
   delta mode): shard s takes corpus.make_docs(2^20, seed 42 + s, start
   s * 2^20), routed there, through node.bulk in batches (one over HTTP
   _bulk), and one refresh compacts each shard's delta into its base
   (phase 4 searches these bases). After the other paths: a delta of
   2^17 docs per shard beside each base; every mix through node.msearch
   (timed), a sample of each through HTTP POST /_msearch and the same
   requests through the engines' own readers, all equal (took aside),
   every fused group one pack, each kernel of the path launched (counts
   zeroed just before); 2,000 deletes and 2,000 updates, a refresh,
   responses again equal to the engines' readers; compaction, after which
   the responses equal those before the swap (hits, totals, keys and
   counts exactly, f32 agg sums within COMPACTION_AGG_RTOL (not the
   variance derived from them), the
   positional mixes, which score with the segment's field statistics,
   by their totals) and the replaced segments' fielddata holds are
   released; then (in a process of its own after the scroll) a
   12,000-doc node (SMALL_NODE_DOCS) on the card and one on the CPU take
   the same writes, Part A's subnormal docs included (bulk + compaction,
   a delta, deletes and updates, compaction, _forcemerge), and give the
   same responses exactly after each; a `node summary` line with the
   card's name and power limit. The node is durable: `path.data` (under
   the checkout's git-ignored `smoke_data/`, removed at the end) and
   the `async` translog (fsynced at flush; `request` mode fsyncs per op
   and runs in the kill -9 rounds), its ingest rate printed beside the
   rate measured before the node had a store;
8. the restart: 2^14 new docs a shard, a refresh and a flush (the commit
   holds each base and a delta), then 1,000 deletes, 1,000 updates and
   2^12 new docs a shard in the translog only, a refresh; 64 requests of
   every mix, each segment's fingerprint / cache key / live mask and
   device columns recorded; the node closed and a new one booted on the
   same path must equal it (keys, torch.equal columns, responses, the
   fielddata held); a `durable` line (flush seconds, bytes on disk,
   recovery seconds by part, ops replayed, fielddata);
9. scroll / scan / dfs on the recovered node: a `match` scrolled in 16
   pages of 1,000 equals one request of 16,000 hits (K3 at ck 1,024 on
   the deep pages, held against its plain version and timed; a batch of
   16 deep pages equals the pages one at a time); a `range` filter
   scanned in 16 pages comes in doc order with the exact total; the
   `match` and `phrase` mixes as dfs_query_then_fetch give the same
   responses with the plain versions swapped in; a `scroll` line (page
   p50 at from 0 and from 15,000);
10. kill -9 (the rounds in a process of their own after the scroll,
   `--worker kill9`): a request-mode node (2 shards) in a subprocess
   (`python3 chip_smoke.py --durability-worker ...`) on the card, SIGKILLed once
   at a random instant after 10,000 acked docs, once by
   `crash_point:site=translog:phase=append:rate=0.05:seed=11:kill=1`,
   once by `crash_point:site=store:phase=commit:kill=1`; after each, a
   node booted on the card over its data recovers every acked doc
   (through get and a term query), verifies clean and answers with the
   kernels as with their plain versions (`kill -9` lines);
11. vectors (path t): two shards of 2^19 passages (BASELINE config 5's
   2^20 x 256 over two shards: a `passage` text field and a 256-dim
   cosine `embedding`, Gaussian around seeded centers, seeds 23 and 24)
   with a 2^15-doc delta each, built in the background (4 workers at
   nice 19) from the node path's start on; the IVF build timed apart,
   its assignment also
   on the card; four mixes of 256 requests through the base + delta
   readers, the counts zeroed just before: `knn` (a top-level knn
   section, k 10, the IVF probe on the bases), `knn_exact` (the same on
   copies whose IVF build is refused: the exact scan), `hybrid` (knn + a
   match on passage, K3 with a knn_vec clause, 128 requests an msearch:
   one base + delta pack; also timed as one msearch of 256, per segment,
   answering the same) and `knn_rescore` (a knn query node rescored over
   a window of 100 by a match); req/s, p50, the IVF probe's host syncs
   per batch and its
   cluster counters, a profiled batch per mix; IVF recall@10 >= 0.95
   against knn_exact and knn_exact's >= 0.99 against a float64 top-10
   of its similarity (the bf16-rounded vectors and queries, the stored
   norms); the plain versions swapped in
   give identical hybrid responses; K3 on the hybrid path's knn_vec walk
   equal to its plain version in the single, stepped and seeded forms
   (timed, with its bound); the similarity column timed beside its bound;
   a small dyadic index answering all four mixes on the card exactly as
   on the CPU; a small node with path.data taking vector docs through
   _bulk, restarting and answering as before;
11b. joins (path w), after the scroll and the script node, beside the
   kill -9 and small node workers: two nested shards of 200,000
   StackOverflow questions with 0-8 answers each as nested objects and
   three with thousands (about 2^20 rows a shard; corpus.qa_nested_docs,
   the shape of Rally's `nested` track), and a parent / child index `qa`
   (corpus.qa_join_docs, the ES 2.0 children agg's question / answer
   types: 2^16 questions with their answers), both built with the port's
   SegmentBuilder in the side workers beside the node ingest (`qa` on the
   shards its routing gives, as a node's _bulk places them; the node's
   _bulk with routing runs on the small nodes below); six mixes of 256
   requests (`nested_match`: a body match under `nested` in each score
   mode, boosted inside a bool every fifth; `nested_aggs`: nested ->
   terms, date_histogram and reverse_nested -> terms; `has_child` with
   min_children, `has_parent`, `parent_id`, `children_agg`), smoke checks
   of the join paths at full size, not a model of users' traffic (their
   query words chosen so that the host's join resolution fits the run),
   a warm-up of 32 and one timed batch a mix in a profiler session of its
   own (`join mix` lines), the counts zeroed just before; the to-parent
   fold and K1 must launch, nested plans be rejected by the fused engine
   as `clause:nested`; the first 32 requests a mix with the plain
   versions swapped in identical; HTTP _msearch equal to the node's
   readers; durable 2-shard nodes on the card and the CPU equal after the
   ingest, a parent's delete, a force merge and a restart; once the
   workers have ended, the fold `torch.equal` to its plain version on the
   path's first call of each score mode and on a sweep row of the nested
   shard's layout (its hottest parent over 4,096 rows), timed beside its
   bound and the library's scatters;
12. a `kernels` JSON line, then the result line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

`--rehearse` runs the main, delta, resident, query DSL, scripts, node,
restart, scroll, kill -9, vectors and joins paths' checks on the CPU at a toy
size (no build, no timings, no
result line), to exercise this script without a card (the kill -9 rounds
and the small node in worker processes, as a whole run starts them).
`--worker KIND OUT DEVICE ARG` is the entry of those processes (the
kernel sweeps, the kill -9 rounds, the small node), which the run starts
itself. `--ab-parent DIR` loads the K3 of an earlier
commit unpacked under DIR (its `elasticsearch_tpu_torch/ops`, e.g. in the
git-ignored `smoke_checkout/`) beside this one and times the two in turns
on every K3 sweep and launch-form row, K1's, K2's, the unfused leaf's,
the scan's, the tree's and the bucket stats' sweep rows and, in a whole
run, their main-path calls, K3's in each form (`ab`; the bucket stats against the earlier
commit's two bucket sums plus the library calls it made for counts,
min and max);
`tools/k3_variants.py`
builds patched copies of this checkout's K3 (a design step undone, or a
probe) under DIR and times them this way. `--kernels-only` stops after
the kernel phase, `--vectors-only` runs the build and path (t) alone,
`--dsl-only` the build, two 2^20-doc shards built in workers and paths
(u) and (v) alone, with (v)'s HTTP node, `--joins-only` the build and
path (w) alone (no result line either).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import gc
import io
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM data sheet
# the bounds' operations are compares, selects, adds and multiplies, each
# one instruction of a lane: 132 SMs x 128 f32 lanes x ~1.98 GHz. The data
# sheet's float32 rate, 67e12, counts a fused multiply-add as two
# operations, which none of these kernels does
H100_F32_OPS_PER_S = 33.5e12
# the positional sweep holds the kernels against their plain versions on
# the first two batch tiles of rows: the plain positional leaf takes
# seconds for all 256 rows over 2^20 docs, and the main path's own calls
# are held against it in full
PLAIN_ROWS = 16
# the plain swap's requests a mix: the plain K3 walk takes seconds per
# call over 2^20 docs, and its time grows with the rows
PLAIN_SWAP_REQUESTS = 64
# the main paths, in slice order: each runs with the launch counts
# zeroed just before it, and every kernel listed must launch in it
PATHS = {
    "dense": (("match", "bool_aggs", "prefix", "term_body", "aggs_only",
               "match_range_aggs", "count_match", "stats_aggs"),
              ("dense_score", "scatter_add", "bundle_topk", "ordered_prefix",
               "ordered_sum", "ordered_bucket_stats")),
    "positional": (("phrase", "phrase_slop_aggs", "span_near",
                    "cross_fields", "phrase_filter"),
                   ("bundle_topk", "positional_leaf", "ordered_prefix")),
}
MIXES = tuple(m for mixes, _k in PATHS.values() for m in mixes)
POSITIONAL_MIXES = ("phrase", "phrase_slop_aggs", "span_near",
                    "cross_fields")
FUSED_MIXES = ("match", "match_range_aggs", "count_match") + POSITIONAL_MIXES
KERNEL_SOURCES = {
    "dense_score": ("elasticsearch_tpu_torch/ops/csrc/dense_score.cu",
                    "elasticsearch_tpu/ops/pallas_scoring.py:60"),
    "scatter_add": ("elasticsearch_tpu_torch/ops/csrc/scatter_add.cu",
                    "elasticsearch_tpu/ops/pallas_scoring.py:142"),
    "bundle_topk": ("elasticsearch_tpu_torch/ops/csrc/bundle_topk.cu",
                    "elasticsearch_tpu/ops/pallas_scoring.py:337"),
    "positional_leaf": (
        "elasticsearch_tpu_torch/ops/csrc/positional_leaf.cuh",
        "elasticsearch_tpu/ops/pallas_scoring.py:458"),
    # not TPU kernels: the reference's agg sums in XLA (cumsum, sum), in
    # XLA's exact order
    "ordered_prefix": ("elasticsearch_tpu_torch/ops/csrc/ordered_scan.cu",
                       "elasticsearch_tpu/ops/aggs.py:123 (jnp.cumsum in "
                       "XLA, not a TPU kernel)"),
    "ordered_sum": ("elasticsearch_tpu_torch/ops/csrc/ordered_scan.cu",
                    "elasticsearch_tpu/ops/aggs.py:83 (.sum(-1) in XLA, "
                    "not a TPU kernel)"),
    "ordered_bucket_stats": (
        "elasticsearch_tpu_torch/ops/csrc/bucket_stats.cu",
        "elasticsearch_tpu/ops/aggs.py:25 (.at[].add / .min / .max in XLA, "
        "not a TPU kernel)"),
}
# K3's other launch forms, entries of the kernels line of their own: the
# stepped walk (`_bundle_pallas_walk`'s step branch) and the seeded walk
# (its thr_init seed, the delta walk of a base+delta pack)
FORM_SOURCES = {
    "bundle_topk_stepped": ("elasticsearch_tpu_torch/ops/csrc/bundle_topk.cu",
                            "elasticsearch_tpu/ops/pallas_scoring.py:848"),
    "bundle_topk_seeded": ("elasticsearch_tpu_torch/ops/csrc/bundle_topk.cu",
                           "elasticsearch_tpu/ops/pallas_scoring.py:825"),
}
# the delta path's mixes (fused: each group must go as one pack) and the
# resident path's
DELTA_MIXES = ("match", "match_range_aggs", "count_match", "phrase")
RESIDENT_MIXES = ("match", "phrase")
DELTA_DOCS = 1 << 17      # per shard; the reference compacts at half the base
# requests per msearch on the delta path: a pack runs one un-chunked walk
# over both segments, so the reference's transient budget
# (executor._chunk_b, 2^27 elements) sends a group per segment once its
# padded batch times the per-row transient (the [cap_b + cap_d] match
# mask of an agg plan) exceeds it: 64 rows of an agg plan fit at 2^20 +
# 2^17 docs, 128 do not
DELTA_BATCH = {"match_range_aggs": 64, "count_match": 64}
FORM_CHUNKS = 8           # launches of the kernel phase's stepped walk
# the wrapper of each kernel that counts its launches
WRAPPERS = {"dense_score": "dense_score", "scatter_add": "scatter_add",
            "bundle_topk": "bundle_walk", "positional_leaf": "positional_leaf",
            "ordered_prefix": "ordered_prefix", "ordered_sum": "ordered_sum",
            "ordered_bucket_stats": "ordered_bucket_stats"}
# the agg mixes: their sorted-layout and view sums go through the scan
# kernel (ordered_prefix), aggs_only's view sums and stats_aggs' stats
# through the tree (ordered_sum), stats_aggs' terms -> extended_stats
# through the bucket stats (ordered_bucket_stats)
AGG_MIXES = ("bool_aggs", "aggs_only", "match_range_aggs", "count_match",
             "stats_aggs", "phrase_slop_aggs")


_log_file = None     # chip_smoke.log under --out-dir


def log(msg: str) -> None:
    """A line to stdout and, with --out-dir, to its chip_smoke.log."""
    print(msg, flush=True)
    if _log_file is not None:
        _log_file.write(msg + "\n")
        _log_file.flush()


def _build_shard(job):
    """Worker: build one shard's segment with the port's builder."""
    shard, n_docs, long_every = job
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.index.mapping import MapperService
    from elasticsearch_tpu_torch.index.segment import SegmentBuilder
    svc = MapperService(mapping=corpus.MAPPING)
    builder = SegmentBuilder()
    for did, doc in corpus.make_docs(n_docs, seed=42 + shard,
                                     start=shard * n_docs,
                                     long_every=long_every):
        builder.add(svc.parse(did, doc))
    return builder.build(f"shard{shard}")


def build_shards(n_docs: int, n_shards: int, long_every: int,
                 workers: int) -> list:
    jobs = [(s, n_docs, long_every) for s in range(n_shards)]
    if workers <= 1:
        return [_build_shard(j) for j in jobs]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(workers, n_shards)) as pool:
        return pool.map(_build_shard, jobs)


def make_readers(segments, device, mapping=None, index: str = "logs"):
    """A reader per shard segment (the corpus's mapping by default)."""
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.index.mapping import MapperService
    from elasticsearch_tpu_torch.search.shard_searcher import ShardReader
    svc = MapperService(mapping=mapping or corpus.MAPPING)
    return [ShardReader(index, [seg], {}, svc, shard_id=s, device=device)
            for s, seg in enumerate(segments)]


def search_merged(readers, bodies, deadline=None) -> list[dict]:
    """Every shard answers the batch, then the cross-shard reduce merges
    each request's shard responses."""
    from elasticsearch_tpu_torch.search.aggregations import parse_aggs
    from elasticsearch_tpu_torch.search.controller import merge_shard_results
    per_shard = [r.msearch(bodies, with_partials=True, deadline=deadline)
                 for r in readers]
    out = []
    for i, body in enumerate(bodies):
        resps = [shard[i] for shard in per_shard]
        out.append(merge_shard_results(
            resps, agg_specs=parse_aggs(body.get("aggs")),
            shard_partials=[r.get("_agg_partials", {}) for r in resps],
            frm=body.get("from", 0), size=body.get("size", 10),
            **_merge_order(body.get("sort"))))
    return out


def _merge_order(sort) -> dict:
    """The merge's order for a request's one sort key, as the node's."""
    entry = sort[0] if isinstance(sort, list) and sort else sort
    if entry in (None, "_score"):
        return {}
    if isinstance(entry, str):
        return {"score_sort": False, "descending": False}
    spec = next(iter(entry.values()))
    if next(iter(entry)) == "_score":
        return {}
    order = spec.get("order", "asc") if isinstance(spec, dict) else str(spec)
    return {"score_sort": False, "descending": str(order).lower() == "desc"}


def _strip(resps: list[dict]) -> list[dict]:
    return [{k: v for k, v in r.items() if k != "took"} for r in resps]


def assert_close_responses(got, want, path="resp", rtol=1e-6) -> None:
    """Exact, except float agg metrics (`value`, a stats agg's `sum`,
    `avg` ...: f32 partial sums may be added in another order) at
    `rtol`."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            raise AssertionError(f"{path}: keys differ")
        for k, v in want.items():
            if k == "took":
                continue
            if isinstance(v, float) and "aggregations" in path:
                if not np.isclose(got[k], v, rtol=rtol, atol=0):
                    raise AssertionError(f"{path}.{k}: {got[k]} != {v}")
                continue
            assert_close_responses(got[k], v, f"{path}.{k}", rtol)
    elif isinstance(want, list):
        if not isinstance(got, list) or len(got) != len(want):
            raise AssertionError(f"{path}: lengths differ")
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close_responses(g, w, f"{path}[{i}]", rtol)
    elif type(got) is not type(want) or got != want:
        raise AssertionError(f"{path}: {got!r} != {want!r}")


def _message_words(body: dict) -> list[str]:
    """The message-field words of a positional request."""
    q = body["query"]
    if "bool" in q:
        q = q["bool"]["must"][0]
    if "match_phrase" in q:
        spec = q["match_phrase"]["message"]
        return (spec["query"] if isinstance(spec, dict) else spec).split()
    if "span_near" in q:
        return [c["span_term"]["message"] for c in q["span_near"]["clauses"]]
    return q["multi_match"]["query"].split()


def request_mixes(n: int, readers, n_docs: int) -> dict[str, list[dict]]:
    """The corpus module's mixes (phrases from the paths of n_docs-doc
    shards), with prefixes that expand and positional requests whose
    words are in the dictionary on every shard (either binds to
    match-nothing otherwise)."""
    from elasticsearch_tpu_torch import corpus
    mixes = corpus.request_mixes(max(4 * n, 96), seed=7, n_docs=n_docs)
    vocab = [set(r.segments[0].text["message"].terms) for r in readers]
    mixes["prefix"] = [b for b in mixes["prefix"] if all(
        any(t.startswith(b["query"]["prefix"]["message"]) for t in v)
        for v in vocab)]
    for name in PATHS["positional"][0]:
        mixes[name] = [b for b in mixes[name] if all(
            set(_message_words(b)) <= v for v in vocab)]
    return {k: v[:n] for k, v in mixes.items()}


@contextlib.contextmanager
def swapped_kernels(**impls):
    """Temporarily replace wrapper functions of ops/cuda_scoring (the
    executor and ops/scoring call them through the module)."""
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    saved = {k: getattr(cs, k) for k in impls}
    for k, fn in impls.items():
        setattr(cs, k, fn)
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(cs, k, fn)


def plain_versions() -> dict:
    """Wrapper name -> its plain version, for the plain swap."""
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    from elasticsearch_tpu_torch.ops import ordered
    return {"dense_score": cs.dense_score_ref,
            "scatter_add": cs.scatter_add_ref,
            "fused_topk_bundle": cs.fused_topk_bundle_ref,
            "match_mask_bundle": cs.match_mask_bundle_ref,
            "positional_leaf": cs.positional_leaf_ref,
            "ordered_prefix": ordered.prefix_at,
            "ordered_sum": ordered.xla_block_sum,
            "ordered_bucket_stats": cs.ordered_bucket_stats_ref}


def check_plain_swap(readers, mixes, last) -> None:
    """The first PLAIN_SWAP_REQUESTS requests of each mix with the plain
    versions swapped in give the kernels' responses."""
    n = PLAIN_SWAP_REQUESTS
    with swapped_kernels(**plain_versions()):
        for name in MIXES:
            if _strip(search_merged(readers, mixes[name][:n])) \
                    != _strip(last[name][:n]):
                raise AssertionError(f"{name}: responses with the plain "
                                     f"versions swapped in differ")


def check_admission(stats) -> None:
    """The fused engine admits the plans of the fused mixes and no other
    (bool_aggs' and phrase_filter's keyword terms filter, prefix /
    term_body's posting scatter and aggs_only's range-only query have no
    bundle form); every plan of a positional mix carries a positional
    clause, and no positional query falls back to the host path."""
    for name, st in stats.items():
        adm = st["fused"]["admission"]
        if name in FUSED_MIXES and (adm["admitted"] == 0 or adm["rejected"]):
            raise AssertionError(f"{name}: fused admission {adm}")
        if name not in FUSED_MIXES and adm["admitted"]:
            raise AssertionError(f"{name}: admitted to the fused engine")
        if adm["positional_fallbacks"]:
            raise AssertionError(f"{name}: positional fallbacks {adm}")
        want = adm["admitted"] if name in POSITIONAL_MIXES else 0
        if adm["positional_admitted"] != want:
            raise AssertionError(f"{name}: positional admission {adm}")


def time_mix(readers, bodies, reps, sync, deadline=None,
             batch=None) -> tuple[dict, list[dict]]:
    """`reps` timed batches of `bodies` -> (stats, last responses); with
    `batch`, each rep sends the bodies `batch` at a time."""
    lat = []
    step = batch or len(bodies)
    t_all = time.perf_counter()
    for _ in range(reps):
        t0 = time.perf_counter()
        resps = [r for i in range(0, len(bodies), step)
                 for r in search_merged(readers, bodies[i:i + step],
                                        deadline)]
        sync()
        lat.append((time.perf_counter() - t0) * 1e3)
    wall = time.perf_counter() - t_all
    return {"requests": len(bodies), "reps": reps,
            "qps": len(bodies) * reps / wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99))}, resps


def run_main_path(readers, mixes, reps, sync):
    """Phase 4 core: each path of PATHS with the launch counts zeroed
    just before it and read just after. Returns per-mix stats (fused
    engine admission and prune counters included), the last responses
    per mix, and per path the kernel launch counts of its run."""
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    from elasticsearch_tpu_torch.search import executor
    stats, last, launches = {}, {}, {}
    for path, (names, _kernels) in PATHS.items():
        for counts in (cs.LAUNCHES, cs.SCAN_ROUTES):
            for k in counts:
                counts[k] = 0
        for name in names:
            bodies = mixes[name]
            before = dict(cs.LAUNCHES)
            executor._fused_stats.reset()
            st, last[name] = time_mix(readers, bodies, reps, sync)
            stats[name] = {
                **st,
                "launches": {k: cs.LAUNCHES[k] - before[k]
                             for k in cs.LAUNCHES},
                "hits": sum(r["hits"]["total"] for r in last[name]),
                "fused": executor.fused_scoring_stats(),
            }
        launches[path] = {**cs.LAUNCHES,
                          "ordered_prefix_routes": dict(cs.SCAN_ROUTES)}
    return stats, last, launches


def check_launches(launches) -> dict:
    """Every kernel of each path launched in that path's run. Returns the
    launch count of each kernel summed over the paths that run it."""
    total: dict = {}
    for path, (_names, kernels) in PATHS.items():
        missing = [k for k in kernels if launches[path][k] <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on the {path} "
                                 f"path: {missing}")
        for k in kernels:
            total[k] = total.get(k, 0) + launches[path][k]
    return total


# the host oracle sweeps sloppy phrases and spans doc by doc in Python
# (about 20-30 us per candidate doc), so the A/B takes those requests
# only where their words co-occur in at most this many docs per shard
HOST_SWEEP_MAX_CANDS = 20_000


def host_affordable(readers, bodies, n: int,
                    max_cands: int = HOST_SWEEP_MAX_CANDS) -> list[dict]:
    """Up to n requests, in the mix's order, whose message words
    co-occur in some doc and in at most max_cands docs on every shard."""
    def cands(body) -> int:
        """0 if no shard has a doc with all the words, else the most
        docs with all of them on one shard."""
        worst = 0
        for r in readers:
            seg = r.segments[0]
            pf = seg.text["message"]
            tids = [pf.lookup(w) for w in set(_message_words(body))]
            lists = sorted((pf.doc_ids[pf.indptr[t]:pf.indptr[t + 1]]
                            for t in tids), key=len)
            docs = lists[0]
            for other in lists[1:]:           # mark, then keep the marked
                seen = np.zeros(seg.capacity, dtype=bool)
                seen[other] = True
                docs = docs[seen[docs]]
            worst = max(worst, len(docs))
        return worst

    return [b for b in bodies if 0 < cands(b) <= max_cands][:n]


def positional_ab(readers, subset: dict[str, list[dict]], sync) -> dict:
    """The subset ({mix: requests}) on the fused engine, then with
    ES_TPU_POSITIONAL=0 (the host oracle through docs_w on K2), one rep
    each: identical responses, and every mix of the subset has requests
    that match."""
    bodies = [b for name in subset for b in subset[name]]
    fused, fused_resps = time_mix(readers, bodies, 1, sync)
    os.environ["ES_TPU_POSITIONAL"] = "0"
    try:
        host, host_resps = time_mix(readers, bodies, 1, sync)
    finally:
        del os.environ["ES_TPU_POSITIONAL"]
    if _strip(host_resps) != _strip(fused_resps):
        raise AssertionError("positional A/B: host-oracle responses differ "
                             "from the fused engine's")
    out = {"requests": {}, "matching_requests": {}, "hits": {}}
    resps = iter(fused_resps)
    for name, reqs in subset.items():
        totals = [next(resps)["hits"]["total"] for _ in reqs]
        out["requests"][name] = len(reqs)
        out["matching_requests"][name] = sum(t > 0 for t in totals)
        out["hits"][name] = sum(totals)
        if not any(totals):
            raise AssertionError(f"positional A/B: no {name} request of the "
                                 f"subset matched anything")
    return {**out, "fused_ms": fused["p50_ms"], "host_ms": host["p50_ms"]}


# the main path's requests on the host oracle: cut from 16 (34 s of the
# host's time) so that the durable phases fit the time limit
POSITIONAL_AB = 8


def positional_ab_subset(readers, mixes, n: int = 64) -> dict:
    """n requests of the positional mixes for the host A/B: the sloppy
    phrase and span_near requests the host can afford (up to n/4 each),
    the rest split between exact phrases and cross_fields."""
    sub = {name: host_affordable(readers, mixes[name], n // 4)
           for name in ("phrase_slop_aggs", "span_near")}
    rest = n - sum(len(v) for v in sub.values())
    sub["phrase"] = mixes["phrase"][:rest - rest // 2]
    sub["cross_fields"] = mixes["cross_fields"][:rest // 2]
    return {k: v for k, v in sub.items() if v}


def check_responses(last) -> None:
    for name, resps in last.items():
        scores = [h["_score"] for r in resps for h in r["hits"]["hits"]
                  if h["_score"] is not None]
        if not np.isfinite(scores).all():
            raise AssertionError(f"{name}: non-finite scores")
        if not any(r["hits"]["total"] > 0 for r in resps):
            raise AssertionError(f"{name}: no request matched anything")


# ---------------------------------------------------------------------------
# the delta path (base + delta packs) and the resident path
# ---------------------------------------------------------------------------


def _zero_counts() -> None:
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    for counts in (cs.LAUNCHES, cs.BUNDLE_FORMS):
        for k in counts:
            counts[k] = 0


def _read_counts() -> dict:
    """The kernels' launch counts, K3's also by launch form."""
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    return {**cs.LAUNCHES, **{f"bundle_topk_{k}": v
                              for k, v in cs.BUNDLE_FORMS.items()}}


def _build_delta(job):
    """Worker: one shard's delta segment, docs after every base doc."""
    shard, n_docs, start, long_every = job
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.index.mapping import MapperService
    from elasticsearch_tpu_torch.index.segment import SegmentBuilder
    svc = MapperService(mapping=corpus.MAPPING)
    builder = SegmentBuilder()
    for did, doc in corpus.make_docs(n_docs, seed=142 + shard, start=start,
                                     long_every=long_every):
        builder.add(svc.parse(did, doc))
    return builder.build(f"delta{shard}")


def _delta_jobs(n_bases: int, n_base: int, n_docs: int,
                long_every: int) -> list:
    start = n_bases * n_base
    return [(s, n_docs, start + s * n_docs, long_every)
            for s in range(n_bases)]


def pair_deltas(bases: list, deltas: list) -> list:
    """Each delta keyed on its base's generation (`delta_parent`) and its
    term dimension bucketed (pad_delta_shapes)."""
    from elasticsearch_tpu_torch.index.segment import pad_delta_shapes
    for base, delta in zip(bases, deltas):
        delta.delta_parent = base.cache_key()
        pad_delta_shapes(delta)
    return deltas


def build_deltas(bases: list, n_base: int, n_docs: int, long_every: int,
                 workers: int) -> list:
    """A delta segment per base (`pair_deltas`)."""
    jobs = _delta_jobs(len(bases), n_base, n_docs, long_every)
    if workers <= 1:
        deltas = [_build_delta(j) for j in jobs]
    else:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(workers, len(jobs))) as pool:
            deltas = pool.map(_build_delta, jobs)
    return pair_deltas(bases, deltas)


def start_side_builds(args, joins: bool = True) -> dict:
    """Builds in 4 worker processes in the background from the node
    ingest on (its bulk loads one of the host's cores), so none waits in
    the main flow: path (w)'s two nested shards first (the long jobs, two
    workers), then on the other two the delta path's two deltas, the
    small index's two shards and path (w)'s parent / child shards. The
    workers run at the lowest scheduling priority (nice 19): the main
    process's host work goes first. -> {"pool", "start", and a pending
    result per build}."""
    ctx = multiprocessing.get_context("spawn")
    with worker_threads(1):
        pool = ctx.Pool(4, initializer=os.nice, initargs=(19,))
    out = {"pool": pool, "start": time.perf_counter(),
           "qa_questions": JOIN_QA_QUESTIONS}
    if joins:
        out["nested"] = pool.map_async(_build_join_shard, _join_jobs(
            JOIN_QUESTIONS, JOIN_HOT), chunksize=1)
    out["deltas"] = pool.map_async(
        _build_delta, _delta_jobs(2, args.docs, args.delta_docs, 1000),
        chunksize=1)
    out["small"] = pool.map_async(
        _build_shard, [(s, args.small_docs, 300) for s in range(2)],
        chunksize=1)
    if joins:
        out["qa"] = pool.map_async(_build_qa_join_shard, _qa_join_jobs(
            JOIN_QA_QUESTIONS, JOIN_HOT), chunksize=1)
    return out


def side_result(side: dict, name: str, waits: dict) -> list:
    """A side build's segments, the seconds waited for them in `waits`."""
    t0 = time.perf_counter()
    segs = side[name].get()
    waits[name] = time.perf_counter() - t0
    return segs


def make_pack_readers(bases, deltas, device):
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.index.mapping import MapperService
    from elasticsearch_tpu_torch.search.shard_searcher import ShardReader
    svc = MapperService(mapping=corpus.MAPPING)
    return [ShardReader("logs", [b, d], {}, svc, shard_id=s, device=device)
            for s, (b, d) in enumerate(zip(bases, deltas))]


def _query_words(body: dict) -> list[str]:
    """The message-field words of a request of the delta path's mixes."""
    q = body["query"]
    if "bool" in q:
        q = q["bool"]["must"][0]
    if "match" in q:
        return q["match"]["message"].split()
    return _message_words(body)


def delta_mixes(n: int, readers_d, n_docs: int) -> dict[str, list[dict]]:
    """n requests of each delta mix whose message words every segment
    holds: a word one segment lacks binds its side of the pair to
    another plan, and the pair then goes per segment."""
    from elasticsearch_tpu_torch import corpus
    mixes = corpus.request_mixes(max(8 * n, 96), seed=7, n_docs=n_docs)
    vocab = [set(seg.text["message"].terms) for r in readers_d
             for seg in r.segments]
    out = {name: [b for b in mixes[name]
                  if all(set(_query_words(b)) <= v for v in vocab)][:n]
           for name in DELTA_MIXES}
    for name, bodies in out.items():
        if not bodies:
            raise AssertionError(f"delta path: no {name} request binds on "
                                 f"every segment")
    return out


@contextlib.contextmanager
def counted_dispatches():
    """Count the shard reader's dispatches: packs, pack refusals (the
    pair went per segment) and per-segment dispatches."""
    from elasticsearch_tpu_torch.search import shard_searcher as ss
    counts = {"pack": 0, "refused": 0, "segment": 0}
    pack_fn, seg_fn = ss.execute_pack_async, ss.execute_segment_async

    def pack(*a, **kw):
        out = pack_fn(*a, **kw)
        counts["pack" if out is not None else "refused"] += 1
        return out

    def seg(*a, **kw):
        counts["segment"] += 1
        return seg_fn(*a, **kw)

    ss.execute_pack_async, ss.execute_segment_async = pack, seg
    try:
        yield counts
    finally:
        ss.execute_pack_async, ss.execute_segment_async = pack_fn, seg_fn


def run_delta_path(readers_d, mixes, reps, sync):
    """The delta path with the launch counts zeroed just before it and
    read just after: each mix through the base+delta pack dispatch, every
    fused group one pack (no refusal, no per-segment dispatch). Returns
    per-mix stats, the last responses and the launch counts."""
    from elasticsearch_tpu_torch.search import executor
    stats, last = {}, {}
    _zero_counts()
    with counted_dispatches() as counts:
        for name in DELTA_MIXES:
            before = dict(counts)
            executor._fused_stats.reset()
            st, last[name] = time_mix(readers_d, mixes[name], reps, sync,
                                      batch=DELTA_BATCH.get(name))
            d = {k: counts[k] - before[k] for k in counts}
            stats[name] = {**st, "dispatches": d,
                           "hits": sum(r["hits"]["total"]
                                       for r in last[name]),
                           "fused": executor.fused_scoring_stats()}
            if d["refused"] or d["segment"] or not d["pack"]:
                raise AssertionError(f"delta path, {name}: a fused group "
                                     f"did not go as one pack: {d}")
    return stats, last, _read_counts()


def delta_ab(readers_d, mixes, last, reps, sync) -> dict:
    """The delta mixes through the pack dispatch and per segment
    (`ES_TPU_PACK_DISPATCH=0`), in turns (pack, segments, segments,
    pack); responses identical."""
    turns = {"pack": {n: [] for n in DELTA_MIXES},
             "segments": {n: [] for n in DELTA_MIXES}}
    for turn in ("pack", "segments", "segments", "pack"):
        if turn == "segments":
            os.environ["ES_TPU_PACK_DISPATCH"] = "0"
        try:
            for name in DELTA_MIXES:
                st, resps = time_mix(readers_d, mixes[name], reps, sync,
                                     batch=DELTA_BATCH.get(name))
                if _strip(resps) != _strip(last[name]):
                    raise AssertionError(f"delta path, {name}: {turn} "
                                         f"responses differ")
                turns[turn][name].append(st)
        finally:
            os.environ.pop("ES_TPU_PACK_DISPATCH", None)
    return {turn: {name: {"qps": float(np.mean([r["qps"] for r in v])),
                          "p50_ms": float(np.mean([r["p50_ms"] for r in v])),
                          "turns": [{"qps": r["qps"], "p50_ms": r["p50_ms"]}
                                    for r in v]}
                   for name, v in per.items()}
            for turn, per in turns.items()}


def _resident_chunks(reader) -> int:
    """Chunks of a resident stepped walk over the reader's segment."""
    from elasticsearch_tpu_torch.search import executor
    n_tiles = reader.segments[0].text["message"].tile_max.shape[1]
    chunk = max(1, -(-n_tiles // executor._RESIDENT_CHUNKS))
    return -(-n_tiles // chunk)


def run_resident_path(readers, mixes, cold_last, reps, sync,
                      on_card: bool = True) -> dict:
    """The resident path on the main index: `match` and `phrase` with
    ES_TPU_RESIDENT_LOOP=1 and a far deadline, the launch counts zeroed
    just before the timed run and read just after (K3's stepped form
    must launch), responses identical to the cold path's, resident hits
    > 0; timed in turns with the cold path (resident, cold, cold,
    resident). Then a batch whose deadline has passed and one whose poll
    flips at chunk 4 (or the last chunk of a smaller index) must raise
    SearchTimeoutError, each counted as preempted; the second launches
    K3 exactly that many times."""
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    from elasticsearch_tpu_torch.search import executor, resident
    from elasticsearch_tpu_torch.utils.errors import SearchTimeoutError
    far = time.monotonic() + 24 * 3600
    out = {}
    os.environ["ES_TPU_RESIDENT_LOOP"] = "1"
    resident.reset()
    try:
        for name in RESIDENT_MIXES:          # pin the entries
            search_merged(readers, mixes[name], far)
        sync()
        _zero_counts()
        for name in RESIDENT_MIXES:
            st, resps = time_mix(readers, mixes[name], reps, sync, far)
            if _strip(resps) != _strip(cold_last[name]):
                raise AssertionError(f"resident {name}: responses differ "
                                     f"from the cold path's")
            out[name] = st
        out["launches"] = _read_counts()
        if on_card and out["launches"]["bundle_topk_stepped"] <= 0:
            raise AssertionError("resident path: K3's stepped form never "
                                 "launched")
        out["stats"] = resident.resident_stats()
        out["stats"].pop("entries")
        if out["stats"]["resident_hits"] <= 0:
            raise AssertionError(f"resident path: no hit {out['stats']}")
        turns = {"resident": {n: [] for n in RESIDENT_MIXES},
                 "cold": {n: [] for n in RESIDENT_MIXES}}
        for turn in ("resident", "cold", "cold", "resident"):
            if turn == "cold":
                del os.environ["ES_TPU_RESIDENT_LOOP"]
            try:
                for name in RESIDENT_MIXES:
                    turns[turn][name].append(time_mix(
                        readers, mixes[name], reps, sync, far)[0])
            finally:
                os.environ["ES_TPU_RESIDENT_LOOP"] = "1"
        out["turns"] = {
            turn: {n: {"qps": float(np.mean([r["qps"] for r in v])),
                       "p50_ms": float(np.mean([r["p50_ms"] for r in v])),
                       "turns": [{"qps": r["qps"], "p50_ms": r["p50_ms"]}
                                 for r in v]}
                   for n, v in per.items()} for turn, per in turns.items()}
        # preemption: a deadline already past
        try:
            search_merged(readers, mixes["match"], time.monotonic() - 1.0)
        except SearchTimeoutError:
            pass
        else:
            raise AssertionError("a deadline already past did not raise")
        if resident.stats.preempted_by_deadline.count != 1:
            raise AssertionError("the past deadline was not preempted")
        # preemption: the poll reports late from chunk `flip`
        flip = min(4, _resident_chunks(readers[0]) - 1)
        polls = []

        def late_from_flip(hi, lo, timed):
            polls.append(timed)
            return bool(timed) or len(polls) > flip

        poll = executor._step_poll
        executor._step_poll = late_from_flip
        before = cs.LAUNCHES["bundle_topk"]
        try:
            search_merged(readers, mixes["match"], far)
        except SearchTimeoutError:
            pass
        else:
            raise AssertionError("a poll late from chunk "
                                 f"{flip} did not raise")
        finally:
            executor._step_poll = poll
        sync()
        flipped = cs.LAUNCHES["bundle_topk"] - before
        if on_card and flipped != flip:
            raise AssertionError(f"a walk late from chunk {flip} launched "
                                 f"K3 {flipped} times")
        if resident.stats.preempted_by_deadline.count != 2:
            raise AssertionError("the late poll was not preempted")
        out["preemption"] = {"batches_raised": 2, "flip_chunk": flip,
                             "flip_launches": flipped,
                             "preempted_by_deadline":
                                 resident.stats.preempted_by_deadline.count}
    finally:
        os.environ.pop("ES_TPU_RESIDENT_LOOP", None)
        resident.reset()
    return out


def capture_forms(delta_cap: int):
    """A shim of `bundle_walk_steps` that remembers the first stepped
    walk (the resident path's) and the first seeded walk over a delta of
    `delta_cap` docs (the delta path's): seen[form] = (args, kw)."""
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    seen: dict = {}
    orig = cs.bundle_walk_steps

    def shim(walk, *args, **kw):
        if kw.get("step") is not None:
            seen.setdefault("stepped", (args, kw))
        elif kw.get("thr_init") is not None \
                and args[6].shape[0] == delta_cap:
            seen.setdefault("seeded", (args, kw))
        return orig(walk, *args, **kw)

    return seen, shim


def rehearse(n_docs: int, batch: int) -> int:
    """The main path's checks on the CPU at a toy size."""
    import torch
    torch.set_num_threads(2)
    segs = build_shards(n_docs, 2, 200, workers=1)
    readers = make_readers(segs, "cpu")
    mixes = request_mixes(batch, readers, n_docs)
    stats, last, _launches = run_main_path(readers, mixes, 1, lambda: None)
    check_responses(last)
    check_admission(stats)
    check_plain_swap(readers, mixes, last)
    ab = positional_ab(readers, positional_ab_subset(readers, mixes, 12),
                       lambda: None)
    deltas = build_deltas(segs, n_docs, n_docs // 4, 200, workers=1)
    readers_d = make_pack_readers(segs, deltas, "cpu")
    dmix = delta_mixes(batch, readers_d, n_docs)
    d_stats, d_last, _counts = run_delta_path(readers_d, dmix, 1,
                                              lambda: None)
    delta_ab(readers_d, dmix, d_last, 1, lambda: None)
    res = run_resident_path(readers, mixes, last, 1, lambda: None,
                            on_card=False)
    # their lines stay out of stdout, which holds the result line alone
    with contextlib.redirect_stdout(io.StringIO()):
        node_out = rehearse_node(n_docs, batch)
        subnormal_rows("cpu", np.random.default_rng(5), B=8, cap=2048)
    log("rehearse: " + json.dumps({
        **{k: {"requests": v["requests"], "hits": v["hits"],
               "fused_admitted": v["fused"]["admission"]["admitted"]}
           for k, v in stats.items()},
        "positional_ab": ab["matching_requests"],
        "delta": {k: {"requests": v["requests"], "hits": v["hits"],
                      "packs": v["dispatches"]["pack"]}
                  for k, v in d_stats.items()},
        "resident": {"hits": res["stats"]["resident_hits"],
                     "preemption": res["preemption"]},
        "node": node_out}))
    # the vectors path at a toy size: passages of 2,000 docs a shard with
    # an IVF index each (ES_TPU_ANN_MIN_DOCS lowered: the small checks'
    # own settings come and go before the bases build), 32 dims
    os.environ["ES_TPU_ANN_MIN_DOCS"] = "256"
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            vec, _entry = vector_phase(argparse.Namespace(
                batch=batch, small_docs=2000), "cpu", lambda: None,
                on_card=False, n=2000, nd=256, D=32)
    finally:
        del os.environ["ES_TPU_ANN_MIN_DOCS"]
    # path (u): the query DSL's mixes on the main readers, a 600-doc
    # small index (the CPU against the CPU) and a 400-doc node over HTTP
    small = build_shards(min(n_docs, 600), 2, 200, workers=1)
    with contextlib.redirect_stdout(io.StringIO()):
        dsl, _ = dsl_phase(argparse.Namespace(
            batch=batch, docs=n_docs, small_docs=min(n_docs, 600)), readers,
            make_readers(small, "cpu"),
            make_readers([copy.copy(s) for s in small], "cpu"), "cpu",
            lambda: None, on_card=False)
    log("rehearse dsl: " + json.dumps({
        "small": dsl["small"], "node": dsl["node"],
        **{k: {"hits": v["hits"],
               "fused_admitted": v["fused"]["admission"]["admitted"],
               "rejected": v["fused"]["admission"]["rejected"]}
           for k, v in dsl["mixes"].items()}}))
    # path (v): the script mixes on the same readers and small index, and
    # the HTTP node with a stored script, a scripted update and a restart
    with contextlib.redirect_stdout(io.StringIO()):
        scripts, _ = script_phase(argparse.Namespace(batch=batch), readers,
                                  make_readers(small, "cpu"),
                                  make_readers([copy.copy(s) for s in small],
                                               "cpu"), lambda: None,
                                  on_card=False)
        script_node = script_node_check(300, "cpu")
    log("rehearse scripts: " + json.dumps({
        "small": scripts["small"], "node": script_node,
        **{k: {"hits": v["hits"],
               "rejected": v["fused"]["admission"]["rejected"]}
           for k, v in scripts["mixes"].items()}}))
    # path (w): joins at a toy size (the nested shards built here, the
    # CPU against the CPU on the small nodes)
    with contextlib.redirect_stdout(io.StringIO()):
        side = rehearse_join_builds(min(n_docs, 400))
        joins, _launches, _entry = join_phase(
            argparse.Namespace(batch=batch), "cpu", lambda: None, side, {},
            on_card=False)
    log("rehearse joins: " + json.dumps({
        "setup": joins["setup"], "small": joins["small"],
        **{k: {"hits": v["hits"],
               "rejected": v["fused"]["admission"]["rejected"]}
           for k, v in joins["mixes"].items()}}))
    log("rehearse vectors: " + json.dumps({
        "recall": vec["recall"], "small": vec["small"], "node": vec["node"],
        **{k: {"hits": v["hits"], "ivf_host_syncs_per_batch":
               v["ivf_host_syncs_per_batch"],
               "knn_admission": v["fused"]["admission"]["knn"]}
           for k, v in vec["mixes"].items()}}))
    return 0


class _Done:
    """A finished build in place of a pool's pending result."""

    def __init__(self, value):
        self.value = value

    def get(self):
        return self.value


def rehearse_join_builds(n: int) -> dict:
    """Path (w)'s shards at a toy size, built here (`start_side_builds`'
    shape)."""
    hot = ((0, 300), (10, 120))
    return {"start": time.perf_counter(), "qa_questions": 2 * n,
            "nested": _Done([_build_join_shard(j)
                             for j in _join_jobs(n, hot)]),
            # a question with 1,000 answers: has_child's rare words
            # match two of them
            "qa": _Done([_build_qa_join_shard(j)
                         for j in _qa_join_jobs(2 * n, ((0, 4000),))])}


def rehearse_node(n_docs: int, batch: int) -> dict:
    """The node path's steps on the CPU at a toy size: ingest (one batch
    over HTTP) into a durable node, refresh with compaction, a delta,
    every mix through node.msearch / HTTP / the engines' readers, edits,
    compaction, the restart, scroll / scan / dfs, the kill -9 rounds (a
    CPU worker, 300 docs) and the small node's steps (a CPU node against
    a CPU node)."""
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.rest.server import RestServer
    data = data_dir("rehearse")
    settings = node_settings(data)
    node = Node(settings, device="cpu")
    server = RestServer(node, "127.0.0.1", 0).start()
    url = f"http://127.0.0.1:{server.port}"
    try:
        # a toy base compacts only under a toy threshold
        node.create_index("logs", {"number_of_shards": 2,
                                   "index.streaming.delta": True,
                                   "index.delta.min_compact_docs": 64},
                          corpus.MAPPING)
        docs = [corpus.make_docs(n_docs, seed=42 + s, start=s * n_docs,
                                 long_every=200) for s in range(2)]
        ingest = node_ingest(node, url, docs, routing_keys(2),
                             http_docs=100)
        node.refresh("logs")
        ns = argparse.Namespace(docs=n_docs, delta_docs=n_docs // 4,
                                batch=batch, reps=1)
        out, launches = node_phase(ns, node, url, lambda: None)
        server.stop()
        node, durable, _ = restart_phase(ns, node, settings, "cpu",
                                         lambda: None)
        scroll_out, _, _ = scroll_phase(ns, node, "cpu", lambda: None,
                                        on_card=False, pages=4, page=50)
    finally:
        server.stop()
        node.close()
    # the kill -9 rounds (a CPU worker, 300 docs) and the small node in
    # processes of their own, as the whole run starts them
    window = [start_worker("kill9", "cpu"),
              start_worker("small_node", "cpu", str(min(n_docs, 600)))]
    kills = finish_worker(window[0])
    small = finish_worker(window[1])
    return {"ingest": ingest["docs"], "compaction_s": out["compaction_s"],
            "fielddata": out["fielddata"],
            "launched": sorted(k for k in NODE_KERNELS if launches[k] > 0),
            "durable": {k: durable[k] for k in ("flush_s", "store_bytes",
                                                "recovery", "segments")},
            "scroll": {k: scroll_out[k] for k in ("scroll", "scan")},
            "kill9_acked": [k["acked"] for k in kills["rounds"]],
            "small": small["steps"]}


# ---------------------------------------------------------------------------
# the node path: Node -> IndexService -> Engine -> ShardReader behind the
# REST handlers
# ---------------------------------------------------------------------------

# the node path's msearch size per mix: a base + delta pack runs one
# un-chunked walk over both segments, so an agg plan of more rows than the
# transient budget allows goes per segment (DELTA_BATCH)
NODE_BATCH = {"match_range_aggs": 64, "count_match": 64,
              "phrase_slop_aggs": 64}
# every kernel of the main paths runs on the node path, K3's seeded form
# for the base + delta packs
NODE_KERNELS = ("dense_score", "scatter_add", "bundle_topk",
                "bundle_topk_seeded", "positional_leaf", "ordered_prefix",
                "ordered_sum", "ordered_bucket_stats")
NODE_HTTP_SAMPLE = 32      # requests per mix also sent over HTTP _msearch
# the node path's timed batches a mix; the small node's docs a shard,
# cut from 20,000 so that the durable phases fit
NODE_REPS = 3
SMALL_NODE_DOCS = 12_000
NODE_PROFILE_MIXES = ("match", "bool_aggs", "stats_aggs", "phrase")
NODE_WRITE_BATCH = 16384   # documents per node.bulk call
NODE_EDITS = 1000          # deletes and updates of the node path's step 4
# f32 agg metrics across a compaction: summed in one segment instead of
# two, each in XLA's order. A bucket's left fold over ~700,000 values of
# `size` (or its square) ends near 3.5e10 (2.3e15), where an add rounds
# by up to half of an ulp of 4,096 (2.7e8): the two orders differ by
# about 3e-5 relative (one standard deviation), up to ~1e-4 over a run's
# 768 buckets. Sums compared within COMPACTION_AGG_RTOL; not the metrics
# derived from them by a cancelling subtraction (variance,
# std_deviation: full runs showed 1.0e-4 and 1.15e-3 relative there)
COMPACTION_AGG_RTOL = 1e-3
DERIVED_METRICS = ("variance", "std_deviation")
# Part A's values: subnormals of both signs, signed zeros, normal values
# just above 2^-126 whose sums cancel into the subnormal range
SUBNORMALS = (1e-40, -1e-40, 1e-45, -1e-45, 1e-38, 9.9e-39, -1e-38,
              -9.9e-39, 3e-39, -2e-39, 0.0, -0.0, 1.5e-38, -1.4e-38, 1.2e-38,
              -1.19e-38, 1e-20, -1e-20, 1.5, -2.25)


def routing_keys(n_shards: int) -> list[str]:
    """A `_routing` value per shard that the node's routing (DjbHash)
    places on that shard."""
    from elasticsearch_tpu_torch.cluster.routing import shard_id
    keys: dict[int, str] = {}
    i = 0
    while len(keys) < n_shards:
        keys.setdefault(shard_id("", n_shards, f"r{i}"), f"r{i}")
        i += 1
    return [keys[s] for s in range(n_shards)]


def _bulk_ops(docs, key: str, index: str = "logs") -> list:
    return [("index", {"_index": index, "_id": did, "_routing": key,
                       "doc": d}) for did, d in docs]


def _ndjson(lines) -> bytes:
    return ("\n".join(json.dumps(x) for x in lines) + "\n").encode()


def http_call(url: str, method: str, path: str, lines=None):
    import urllib.request
    data = _ndjson(lines) if lines is not None else None
    req = urllib.request.Request(url + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as f:
        return json.loads(f.read())


def node_ingest(node, url: str, shard_docs, keys, index: str = "logs",
                http_docs: int = 4096) -> dict:
    """Every shard's documents through node.bulk in batches of
    NODE_WRITE_BATCH, routed to their shard; shard 0's first `http_docs`
    go as one NDJSON _bulk over HTTP. Returns docs and seconds."""
    t0 = time.perf_counter()
    n = 0
    for s, docs in enumerate(shard_docs):
        lo = 0
        if s == 0 and http_docs:
            lines = []
            for did, d in docs[:http_docs]:
                lines += [{"index": {"_index": index, "_id": did,
                                     "routing": keys[s]}}, d]
            r = http_call(url, "POST", "/_bulk", lines=lines)
            if r["errors"] or len(r["items"]) != min(http_docs, len(docs)):
                raise AssertionError("HTTP _bulk: " + json.dumps(r)[:400])
            lo = http_docs
        for i in range(lo, len(docs), NODE_WRITE_BATCH):
            r = node.bulk(_bulk_ops(docs[i:i + NODE_WRITE_BATCH], keys[s],
                                    index))
            if r["errors"]:
                raise AssertionError("node.bulk: " + json.dumps(r)[:400])
        n += len(docs)
    return {"docs": n, "s": time.perf_counter() - t0}


def node_readers(node, index: str = "logs") -> list:
    return [eng.acquire_searcher()
            for eng in node.indices[index].shards.values()]


def node_search(node, bodies, batch=None, index: str = "logs") -> list:
    step = batch or len(bodies)
    out = []
    for i in range(0, len(bodies), step):
        out += node.msearch([(index, b)
                             for b in bodies[i:i + step]])["responses"]
    bad = [r for r in out if r.get("status") != 200]
    if bad:
        raise AssertionError("node.msearch item failed: "
                             + json.dumps(bad[0])[:400])
    return out


def _node_strip(resps: list[dict]) -> list[dict]:
    return [{k: v for k, v in r.items() if k not in ("took", "status")}
            for r in resps]


def node_mixes(n: int, readers, n_docs: int) -> dict[str, list[dict]]:
    """request_mixes for the node's readers (base + delta): fused mixes
    keep the requests whose message words every segment holds, so that
    each fused group goes as one pack."""
    mixes = request_mixes(max(16 * n, 256), readers, n_docs)
    vocab = [set(seg.text["message"].terms) for r in readers
             for seg in r.segments]
    out = {}
    for name, bodies in mixes.items():
        if name in FUSED_MIXES:
            bodies = [b for b in bodies
                      if all(set(_query_words(b)) <= v for v in vocab)]
        out[name] = bodies[:n]
        if not out[name]:
            raise AssertionError(f"node path: no {name} request")
    return out


class FullCollections:
    """The cyclic collector's full (generation 2) passes and their
    milliseconds while `on`: one over the host heap of a 2^20-doc node
    costs seconds on the card's host, and the node path's batches report
    any that fell inside them."""

    def __init__(self):
        self.on = False
        self.passes = 0
        self.ms = 0.0
        self._t0 = None

    def __call__(self, phase, info):
        if not self.on or info["generation"] != 2:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.passes += 1
            self.ms += (time.perf_counter() - self._t0) * 1e3
            self._t0 = None

    @contextlib.contextmanager
    def counting(self):
        self.passes, self.ms, self.on = 0, 0.0, True
        gc.callbacks.append(self)
        try:
            yield self
        finally:
            self.on = False
            gc.callbacks.remove(self)


def run_node_path(node, url: str, mixes, reps: int, sync) -> tuple:
    """Every mix through node.msearch (timed), a sample of each through
    HTTP POST /_msearch, and the same requests through the engines' own
    readers (search_merged); the three must agree (took aside), every
    fused group must go as one pack. The launch counts are zeroed just
    before and read just after. Returns (stats, last responses,
    launches)."""
    stats, last = {}, {}
    readers = node_readers(node)
    _zero_counts()
    with counted_dispatches() as counts:
        for name in MIXES:
            bodies = mixes[name]
            batch = NODE_BATCH.get(name)
            before = dict(counts)
            t0 = time.perf_counter()
            lat = []
            with FullCollections().counting() as full_gc:
                for _ in range(reps):
                    t1 = time.perf_counter()
                    resps = node_search(node, bodies, batch)
                    sync()
                    lat.append((time.perf_counter() - t1) * 1e3)
            wall = time.perf_counter() - t0
            d = {k: counts[k] - before[k] for k in counts}
            # an unfused plan is refused by the pack and goes per segment
            if name in FUSED_MIXES and (d["refused"] or d["segment"]
                                        or not d["pack"]):
                raise AssertionError(f"node path, {name}: a fused group "
                                     f"did not go as one pack: {d}")
            direct_st, direct = time_mix(readers, bodies, max(1, reps - 2),
                                         sync, batch=batch)
            if _node_strip(resps) != _strip(direct):
                raise AssertionError(f"node path, {name}: node.msearch != "
                                     f"the engines' readers")
            sample = bodies[:NODE_HTTP_SAMPLE]
            lines = [x for b in sample for x in ({"index": "logs"}, b)]
            lat_h = []
            for _ in range(max(1, reps - 2)):
                t1 = time.perf_counter()
                over_http = http_call(url, "POST", "/_msearch",
                                      lines=lines)["responses"]
                lat_h.append((time.perf_counter() - t1) * 1e3)
            if _node_strip(over_http) != _node_strip(resps[:len(sample)]):
                raise AssertionError(f"node path, {name}: HTTP _msearch != "
                                     f"node.msearch")
            stats[name] = {
                "requests": len(bodies), "msearch_batch": batch or len(bodies),
                "node": {"qps": len(bodies) * reps / wall,
                         "p50_ms": float(np.percentile(lat, 50)),
                         "full_gc": {"passes": full_gc.passes,
                                     "ms": full_gc.ms}},
                "rest": {"requests": len(sample),
                         "qps": len(sample) / (float(np.median(lat_h)) / 1e3),
                         "p50_ms": float(np.percentile(lat_h, 50))},
                "direct": {"qps": direct_st["qps"],
                           "p50_ms": direct_st["p50_ms"]},
                "dispatches": d,
                "hits": sum(r["hits"]["total"] for r in resps)}
            last[name] = resps
            log("node mix " + json.dumps({"mix": name, **stats[name]}))
    return stats, last, _read_counts()


def node_serve_equal(node, mixes, want: dict, what: str,
                     agg_rtol: float = 0.0, totals_only=()) -> dict:
    """Every mix through node.msearch once; with `want`, the responses
    must equal it (took aside), float agg metrics within `agg_rtol`, the
    mixes of `totals_only` their hit totals only. Returns the
    responses."""
    got = {name: node_search(node, mixes[name], NODE_BATCH.get(name))
           for name in MIXES}
    if want is not None:
        for name in MIXES:
            g, w = _node_strip(got[name]), _node_strip(want[name])
            if name in totals_only:
                g = [r["hits"]["total"] for r in g]
                w = [r["hits"]["total"] for r in w]
            elif agg_rtol:
                g, w = _drop_keys(g, DERIVED_METRICS), \
                    _drop_keys(w, DERIVED_METRICS)
            try:
                assert_close_responses(g, w, rtol=agg_rtol)
            except AssertionError as e:
                raise AssertionError(f"node path, {name}: responses "
                                     f"differ {what}: {e}") from None
    return got


def _drop_keys(x, keys):
    if isinstance(x, dict):
        return {k: _drop_keys(v, keys) for k, v in x.items() if k not in keys}
    if isinstance(x, list):
        return [_drop_keys(v, keys) for v in x]
    return x


def node_direct_equal(node, mixes, got: dict, what: str) -> None:
    readers = node_readers(node)
    for name in MIXES:
        direct = search_merged(readers, mixes[name])
        if _node_strip(got[name]) != _strip(direct):
            raise AssertionError(f"node path, {name}: node.msearch != the "
                                 f"engines' readers {what}")


def fielddata_bytes() -> int:
    from elasticsearch_tpu_torch.utils.breaker import breaker_service
    return breaker_service().breaker("fielddata").used


def subnormal_docs(docs, seed: int) -> list:
    """The corpus docs with a `double` and a `float` field holding Part
    A's values (85% of docs each)."""
    rng = np.random.default_rng(seed)
    vals = np.array(SUBNORMALS, np.float32)
    out = []
    for did, d in docs:
        d = dict(d)
        if rng.random() < 0.85:
            d["dval"] = float(rng.choice(vals))
        if rng.random() < 0.85:
            d["fval"] = float(rng.choice(vals))
        out.append((did, d))
    return out


def subnormal_bodies() -> list[dict]:
    out = []
    for f in ("dval", "fval"):
        aggs = {
            "st": {"stats": {"field": f}},
            "ex": {"extended_stats": {"field": f}},
            "mn": {"min": {"field": f}}, "mx": {"max": {"field": f}},
            "sm": {"sum": {"field": f}}, "av": {"avg": {"field": f}},
            "by_status": {"terms": {"field": "status"},
                          "aggs": {"st": {"stats": {"field": f}},
                                   "ex": {"extended_stats": {
                                       "field": f}}}},
            "by_size": {"histogram": {"field": "size", "interval": 20_000},
                        "aggs": {"s": {"sum": {"field": f}},
                                 "mn": {"min": {"field": f}}}}}
        out += [
            {"query": {"range": {f: {"gte": 1e-45}}}, "size": 0,
             "aggs": aggs},
            {"query": {"range": {f: {"gte": 1e-45, "lt": 1e-39}}},
             "size": 30, "sort": [{f: "asc"}]},
            {"query": {"range": {f: {"gt": -1e-45}}}, "size": 0},
            {"query": {"match": {"message": "images"}}, "size": 0,
             "aggs": aggs},
            {"query": {"match_all": {}}, "size": 100,
             "sort": [{f: "desc"}]},
            {"query": {"bool": {"must": [{"match": {"message": "images"}}],
                                "filter": [{"range": {f: {"lt": 1e-39}}}]}},
             "size": 10, "aggs": aggs}]
    return out


def small_node_check(n_docs: int, n_per_mix: int, dev, sync) -> dict:
    """A node on the card and one on the CPU take the same writes (Part
    A's subnormal docs included): bulk + refresh (compaction), a delta,
    deletes and updates, compaction, _forcemerge. After each step every
    mix and the subnormal bodies give the CPU's responses exactly."""
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.node import Node
    mapping = {"properties": {**corpus.MAPPING["properties"],
                              "dval": {"type": "double"},
                              "fval": {"type": "float"}}}
    keys = routing_keys(2)
    docs = [subnormal_docs(list(corpus.make_docs(
        n_docs, seed=42 + s, start=s * n_docs, long_every=300)), 900 + s)
        for s in range(2)]
    extra = [subnormal_docs(list(corpus.make_docs(
        n_docs // 10, seed=142 + s, start=(2 + s) * n_docs,
        long_every=300)), 910 + s) for s in range(2)]
    nodes = {"gpu": Node({"node.name": "small-gpu"}, device=dev),
             "cpu": Node({"node.name": "small-cpu"}, device="cpu")}
    steps = []
    try:
        for n in nodes.values():
            n.create_index("small", {"number_of_shards": 2,
                                     "index.streaming.delta": True,
                                     "index.delta.min_compact_docs":
                                         min(4096, n_docs // 2)},
                           mapping)
        mixes = None

        def compare(step):
            nonlocal mixes
            if mixes is None:
                mixes = request_mixes(n_per_mix, node_readers(
                    nodes["cpu"], "small"), n_docs)
                mixes["subnormal"] = subnormal_bodies()
            for name, bodies in mixes.items():
                got = {side: _node_strip(node_search(n, bodies,
                                                     index="small"))
                       for side, n in nodes.items()}
                if json.dumps(got["gpu"], sort_keys=True) != json.dumps(
                        got["cpu"], sort_keys=True):
                    raise AssertionError(f"small node, {step}, {name}: "
                                         "the card != the CPU")
            steps.append(step)

        for n in nodes.values():
            for s in range(2):
                n.bulk(_bulk_ops(docs[s], keys[s], "small"))
            n.refresh("small")
        compare("ingest + refresh (compaction)")
        for n in nodes.values():
            for s in range(2):
                n.bulk(_bulk_ops(extra[s], keys[s], "small"))
            n.refresh("small")
        compare("delta")
        for n in nodes.values():
            ops = []
            for s in range(2):
                pick = np.random.default_rng(78 + s).choice(
                    n_docs, size=200, replace=False)
                ops += [("delete", {"_index": "small",
                                    "_id": docs[s][i][0],
                                    "_routing": keys[s]})
                        for i in pick[:100]]
                ops += [("update", {"_index": "small",
                                    "_id": docs[s][i][0],
                                    "_routing": keys[s],
                                    "doc": {"doc": {"size": 7,
                                                    "fval": -1e-40}}})
                        for i in pick[100:]]
            r = n.bulk(ops)
            if r["errors"]:
                raise AssertionError("small node bulk edits failed")
            n.refresh("small")
        compare("deletes + updates")
        for n in nodes.values():
            for eng in n.indices["small"].shards.values():
                eng.compact()
        compare("compaction")
        for n in nodes.values():
            n.force_merge("small")
        compare("_forcemerge")
    finally:
        for n in nodes.values():
            n.close()
    return {"docs_per_shard": n_docs, "steps": steps,
            "mixes": len(mixes) if mixes else 0}


def node_phase(args, node, url: str, sync, profile=None) -> tuple:
    """Steps 2-5 of the node path on the full-width node: a delta beside
    each base, every mix served (node / REST / direct readers), deletes
    and updates, compaction (identical responses across the swap; the
    replaced segments' fielddata holds released)."""
    from elasticsearch_tpu_torch import corpus
    keys = routing_keys(2)
    out: dict = {}
    # 2. a delta of DELTA_DOCS per shard beside each base
    extra = [list(corpus.make_docs(args.delta_docs, seed=242 + s,
                                   start=2 * args.docs + s * args.delta_docs,
                                   long_every=1000)) for s in range(2)]
    w = node_ingest(node, url, extra, keys, http_docs=0)
    t0 = time.perf_counter()
    node.refresh("logs")
    out["delta_refresh_s"] = time.perf_counter() - t0
    out["delta_ingest"] = {"docs": w["docs"], "s": w["s"],
                           "docs_per_s": w["docs"] / w["s"]}
    segs = [[s.num_docs for s in eng.segments]
            for eng in node.indices["logs"].shards.values()]
    if any(len(x) != 2 for x in segs):
        raise AssertionError(f"node path: not a base + delta: {segs}")
    log("node delta: " + json.dumps({**out, "segments": segs}))
    # the delta's host side (its docs' parsed fields, kept for the next
    # rebuild: ~9 tracked objects a doc) joins the frozen index, so that
    # no full collection over it lands inside a timed batch
    gc.collect()
    gc.freeze()
    # 3. serve
    readers = node_readers(node)
    mixes = node_mixes(args.batch, readers, args.docs)
    node_search(node, mixes["match"][:8])            # warm-up
    for name in MIXES:
        node_search(node, mixes[name], NODE_BATCH.get(name))
    sync()
    stats, last, launches = run_node_path(node, url, mixes,
                                          min(args.reps, NODE_REPS), sync)
    out["mixes"] = stats
    if profile is not None:
        out["profiles"] = profile(
            lambda bodies: node_search(node, bodies), mixes)
    # 4. deletes and updates
    rng = np.random.default_rng(99)
    n_edits = min(NODE_EDITS, args.docs // 4)
    ops = []
    for s in range(2):
        ids = rng.choice(args.docs, size=2 * n_edits, replace=False)
        base_ids = [str(s * args.docs + int(i)) for i in ids]
        ops += [("delete", {"_index": "logs", "_id": d, "_routing": keys[s]})
                for d in base_ids[:n_edits]]
        ops += [("update", {"_index": "logs", "_id": d, "_routing": keys[s],
                            "doc": {"doc": {"size": 7}}})
                for d in base_ids[n_edits:]]
    r = node.bulk(ops)
    if r["errors"]:
        raise AssertionError("node path edits: " + json.dumps(
            [i for i in r["items"] if "error" in next(iter(i.values()))][:3]))
    t0 = time.perf_counter()
    node.refresh("logs")
    out["edits_refresh_s"] = time.perf_counter() - t0
    edited = node_serve_equal(node, mixes, None, "after the edits")
    node_direct_equal(node, mixes, edited, "after the edits")
    log("node edits: " + json.dumps({"deletes": 2 * n_edits,
                                     "updates": 2 * n_edits,
                                     "refresh_s": out["edits_refresh_s"]}))
    # 5. compaction: identical responses across the swap, the replaced
    # segments' fielddata holds released
    svc = node.indices["logs"]
    old_holds = [seg._breaker_hold for eng in svc.shards.values()
                 for seg in eng.segments]
    held = sum(h.bytes for h in old_holds)
    before = fielddata_bytes()
    t0 = time.perf_counter()
    for eng in svc.shards.values():
        if not eng.compact():
            raise AssertionError("node path: compaction did not swap")
    out["compaction_s"] = time.perf_counter() - t0
    del readers
    gc.collect()
    released = sum(1 for h in old_holds if h.bytes == 0)
    after_swap = fielddata_bytes()
    # hits, totals, scores, keys and counts identical across the swap;
    # f32 agg sums within COMPACTION_AGG_RTOL: the compacted base sums in
    # one segment what base and delta summed apart; the positional mixes
    # score with the field statistics of the segment they search, which
    # the fold changes, so their totals only. The reference's compaction
    # does the same (tests/test_torch_engine.py holds the port to it
    # across compactions; ROADMAP Queue 3)
    compacted = node_serve_equal(node, mixes, edited, "across compaction",
                                 agg_rtol=COMPACTION_AGG_RTOL,
                                 totals_only=PATHS["positional"][0])
    out["fielddata"] = {"before_compaction": before,
                        "replaced_segments_held": held,
                        "after_swap": after_swap,
                        "after_serving": fielddata_bytes(),
                        "replaced_holds_released": released,
                        "replaced_holds": len(old_holds)}
    if released != len(old_holds) or after_swap > before - held:
        raise AssertionError("node path: the replaced segments' fielddata "
                             "holds were not released: "
                             + json.dumps(out["fielddata"]))
    del compacted, edited
    log("node compaction: " + json.dumps(
        {"s": out["compaction_s"], "fielddata": out["fielddata"]}))
    return out, launches


# ---------------------------------------------------------------------------
# the durable node: a full-scale restart, kill -9 rounds, and scroll /
# scan / dfs on the recovered node
# ---------------------------------------------------------------------------

# the node's data directories: under the checkout, git-ignored, removed
# at the end of the run (a failed run removes them too)
DATA_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "smoke_data")
# the node ingest on the H100 before the node had a store (PERF.md §5)
NO_TRANSLOG_INGEST_DOCS_PER_S = 14153.0
RESTART_NEW_DOCS = 1 << 14        # per shard, flushed with the base
RESTART_TAIL_DOCS = 1 << 12       # per shard, the translog only
RESTART_EDITS = 1000              # deletes and updates, the translog only
RESTART_REQUESTS = 64             # requests of each mix held across it
SCROLL_PAGES = 16
SCROLL_PAGE = 1000
DFS_PLAIN = 16                    # dfs requests a mix held against plain
KILL_DOCS = 10_000                # the kill -9 node's docs before a kill
KILL_BATCH = 100                  # docs per node.bulk while loading
KILL_FAULT_BATCH = 5              # docs per node.bulk in the fault rounds
KILL_FLUSH_EVERY = 2000           # the worker flushes every this many
KILL_MAPPING = {"properties": {**{
    "message": {"type": "text"}, "status": {"type": "keyword"},
    "size": {"type": "long"}, "@timestamp": {"type": "date"},
    "body": {"type": "text"}}, "key": {"type": "keyword"}}}
# the kill -9 rounds: (fault spec, seconds after the load to SIGKILL)
KILL_ROUNDS = (
    (None, "random"),
    ("crash_point:site=translog:phase=append:rate=0.05:seed=11:kill=1",
     None),
    ("crash_point:site=store:phase=commit:kill=1", None),
)


def remove_data() -> None:
    """Remove this process's data directories (and the root, if empty)."""
    if not os.path.isdir(DATA_ROOT):
        return
    for name in os.listdir(DATA_ROOT):
        if name.endswith(f"-{os.getpid()}"):
            shutil.rmtree(os.path.join(DATA_ROOT, name), ignore_errors=True)
    with contextlib.suppress(OSError):
        os.rmdir(DATA_ROOT)


def data_dir(tag: str) -> str:
    path = os.path.join(DATA_ROOT, f"{tag}-{os.getpid()}")
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def node_settings(path: str, **extra) -> dict:
    """The durable node: path.data and the async translog (the ingest
    fsyncs at flush, not per op; `request` mode runs in the kill -9
    rounds)."""
    return {"node.name": "chip-smoke", "path.data": path,
            "index.translog.durability": "async", **extra}


def dir_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for f in files:
            try:
                total += os.path.getsize(os.path.join(root, f))
            except OSError:
                pass
    return total


def dev_tree_diff(a, b, path="dev") -> list[str]:
    """Paths where two device-column trees differ (torch.equal per
    tensor)."""
    import torch
    if isinstance(a, torch.Tensor):
        if not isinstance(b, torch.Tensor) or a.dtype != b.dtype \
                or not torch.equal(a, b):
            return [path]
        return []
    if isinstance(a, dict):
        out = [f"{path}.{k} (one side only)"
               for k in sorted(set(a) ^ set(b), key=str)]
        for k in a:
            if k in b:
                out += dev_tree_diff(a[k], b[k], f"{path}.{k}")
        return out
    return [] if a == b else [path]


def segment_state(node, dev, index: str = "logs") -> list:
    """Per shard, per segment: fingerprint, cache key, delta epoch, live
    mask and device columns (uploaded when not yet)."""
    from elasticsearch_tpu_torch.search import executor
    return [[{"fingerprint": seg.fingerprint(), "cache_key": seg.cache_key(),
              "delta_epoch": seg.delta_epoch, "num_docs": seg.num_docs,
              "live": eng.live[seg.seg_id].copy(),
              "dev": executor.device_arrays(seg, dev)}
             for seg in eng.segments]
            for eng in node.indices[index].shards.values()]


def recovery_parts(node, index: str = "logs") -> dict:
    """The engines' recovery seconds by part, summed over the shards."""
    out: dict = {}
    for eng in node.indices[index].shards.values():
        for k, v in eng.recovery_stats.items():
            out[k] = out.get(k, 0) + v
    return out


def restart_phase(args, node, settings: dict, dev, sync) -> tuple:
    """A full-scale restart of the durable node. Writes 2^14 new docs a
    shard, refreshes and flushes (the commit holds each base and a
    non-empty delta); then deletes, updates and 2^12 new docs a shard that
    only the translog holds, and a refresh. Records 64 requests of every
    mix, each segment's fingerprint / cache key / live mask / device
    columns, closes the node and boots a new one on the same path, which
    must equal the state before the close: equal keys, torch.equal
    columns, equal responses. Returns (the new node, report, launches of
    the serve after the restart)."""
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.node import Node
    keys = routing_keys(2)
    index_dir = os.path.join(settings["path.data"], "logs")
    n_new = min(RESTART_NEW_DOCS, max(args.docs // 4, 1))
    n_tail = min(RESTART_TAIL_DOCS, max(args.docs // 8, 1))
    n_edits = min(RESTART_EDITS, max(args.docs // 8, 1))
    start = 2 * args.docs + 2 * args.delta_docs
    new = [list(corpus.make_docs(n_new, seed=342 + s,
                                 start=start + s * n_new, long_every=1000))
           for s in range(2)]
    node_ingest(node, None, new, keys, http_docs=0)
    node.refresh("logs")
    segs = [[s.num_docs for s in eng.segments]
            for eng in node.indices["logs"].shards.values()]
    if any(len(x) != 2 for x in segs):
        raise AssertionError(f"restart: not a base + delta before the "
                             f"flush: {segs}")
    t0 = time.perf_counter()
    r = node.flush("logs")
    out = {"flush_s": time.perf_counter() - t0,
           "flushed_segments": segs}
    if r["_shards"]["failed"]:
        raise AssertionError("restart: flush failed: " + json.dumps(r))
    out["store_bytes"] = dir_bytes(index_dir)
    # the translog tail: deletes and updates of base docs, new docs
    rng = np.random.default_rng(177)
    tail_start = start + 2 * n_new
    ops = []
    for s in range(2):
        # live base docs (the node phase deleted some)
        base_ids = []
        for i in rng.permutation(args.docs):
            did = str(s * args.docs + int(i))
            try:
                node.get_doc("logs", did, routing=keys[s])
            except Exception:  # noqa: BLE001 — deleted earlier
                continue
            base_ids.append(did)
            if len(base_ids) == 2 * n_edits:
                break
        ops += [("delete", {"_index": "logs", "_id": d, "_routing": keys[s]})
                for d in base_ids[:n_edits]]
        ops += [("update", {"_index": "logs", "_id": d, "_routing": keys[s],
                            "doc": {"doc": {"size": 11}}})
                for d in base_ids[n_edits:]]
        ops += _bulk_ops(corpus.make_docs(
            n_tail, seed=442 + s, start=tail_start + s * n_tail,
            long_every=1000), keys[s])
    r = node.bulk(ops)
    if r["errors"]:
        raise AssertionError("restart: tail writes failed")
    node.refresh("logs")
    out["translog_ops"] = len(ops)
    mixes = node_mixes(min(RESTART_REQUESTS, args.batch),
                       node_readers(node), args.docs)
    want = {name: node_search(node, mixes[name], NODE_BATCH.get(name))
            for name in MIXES}
    sync()
    before = segment_state(node, dev)
    gens = [eng.base_generation()
            for eng in node.indices["logs"].shards.values()]
    out["fielddata_before"] = fielddata_bytes()
    out["bytes_before_close"] = dir_bytes(index_dir)
    node.close()
    gc.collect()
    out["fielddata_after_close"] = fielddata_bytes()
    t0 = time.perf_counter()
    node = Node(settings, device=dev)
    out["boot_s"] = time.perf_counter() - t0
    out["recovery"] = recovery_parts(node)
    engines = list(node.indices["logs"].shards.values())
    if any(e.failed is not None for e in engines):
        raise AssertionError("restart: a shard failed its recovery: "
                             + json.dumps([e.failed for e in engines]))
    if [e.base_generation() for e in engines] != gens:
        raise AssertionError("restart: base generations differ")
    _zero_counts()
    t0 = time.perf_counter()
    got = {name: node_search(node, mixes[name], NODE_BATCH.get(name))
           for name in MIXES}
    sync()
    out["first_serve_s"] = time.perf_counter() - t0
    launches = _read_counts()
    # the recovered node's host side joins the frozen heap, as the
    # ingested one's did
    gc.collect()
    gc.freeze()
    for name in MIXES:
        if _node_strip(got[name]) != _node_strip(want[name]):
            raise AssertionError(f"restart, {name}: responses differ "
                                 f"from those before the close")
    after = segment_state(node, dev)
    diffs = []
    for s, (pre, post) in enumerate(zip(before, after)):
        if len(pre) != len(post):
            raise AssertionError(f"restart: shard {s} has {len(post)} "
                                 f"segments, had {len(pre)}")
        for i, (a, b) in enumerate(zip(pre, post)):
            for k in ("fingerprint", "cache_key", "delta_epoch",
                      "num_docs"):
                if a[k] != b[k]:
                    raise AssertionError(f"restart: shard {s} segment {i} "
                                         f"{k} {b[k]!r} != {a[k]!r}")
            if not np.array_equal(a["live"], b["live"]):
                raise AssertionError(f"restart: shard {s} segment {i} "
                                     "live mask differs")
            diffs += [f"shard {s} segment {i} {p}"
                      for p in dev_tree_diff(a["dev"], b["dev"])]
    if diffs:
        raise AssertionError("restart: device columns differ: "
                             + json.dumps(diffs[:20]))
    out["fielddata_after"] = fielddata_bytes()
    if out["fielddata_after"] != out["fielddata_before"]:
        raise AssertionError("restart: fielddata " + json.dumps(out))
    out["segments"] = [[{"num_docs": x["num_docs"],
                         "delta_epoch": x["delta_epoch"]} for x in shard]
                       for shard in after]
    out["responses_equal"] = {name: len(mixes[name]) for name in MIXES}
    del before, after
    return node, out, launches


def _page_p50(node, body, reps: int, sync) -> float:
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        node.search("logs", copy.deepcopy(body))
        sync()
        lat.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(lat, 50))


def doc_positions(node, index: str = "logs") -> dict:
    """id -> (shard, segment, local doc): the scan's doc order."""
    pos = {}
    for sid, eng in node.indices[index].shards.items():
        for si, seg in enumerate(eng.segments):
            for d in range(seg.num_docs):
                pos[seg.ids[d]] = (sid, si, d)
    return pos


def scroll_phase(args, node, dev, sync, on_card: bool = True,
                 pages: int = SCROLL_PAGES,
                 page: int = SCROLL_PAGE) -> tuple:
    """Scroll, scan and dfs on the node. A `match` scrolled in `pages`
    pages of `page` must equal one request of pages * page hits (K3
    runs deep pages at ck = min(from + size, 1,024)); a `range` filter
    scanned the same way must come in doc order with the exact total;
    the `match` and `phrase` mixes as dfs_query_then_fetch must give the
    same responses with the plain versions swapped in. Returns (report,
    launches, K3's deep-page call measured against its plain version or
    None off the card)."""
    out: dict = {}
    mixes = node_mixes(min(64, args.batch), node_readers(node), args.docs)
    window = pages * page
    # the match request with the most hits of the first sixteen
    totals = [(node.search("logs", {"query": b["query"], "size": 0})
               ["hits"]["total"], i) for i, b in enumerate(mixes["match"][:16])]
    total, i = max(totals)
    if total < window:
        raise AssertionError(f"scroll: no match request has {window} hits "
                             f"({total})")
    body = {"query": mixes["match"][i]["query"], "size": page}
    _zero_counts()
    t0 = time.perf_counter()
    first = node.search("logs", copy.deepcopy(body), scroll="5m")
    got = [first] + [node.scroll(first["_scroll_id"], "5m")
                     for _ in range(pages - 1)]
    sync()
    out["scroll_s"] = time.perf_counter() - t0
    launches = _read_counts()
    node.clear_scroll([first["_scroll_id"]])
    whole = node.search("logs", {**body, "size": window})
    pairs = [(h["_id"], h["_score"]) for p in got for h in p["hits"]["hits"]]
    if pairs != [(h["_id"], h["_score"]) for h in whole["hits"]["hits"]] \
            or any(p["hits"]["total"] != total for p in got):
        raise AssertionError("scroll: the pages differ from one request of "
                             "the whole window")
    out["scroll"] = {"hits": total, "pages": pages, "page": page,
                     "launches": launches}
    if on_card and launches["bundle_topk"] <= 0:
        raise AssertionError("scroll: K3 never launched")
    k3 = None
    if on_card:
        out["page_p50_ms"] = {
            "from_0": _page_p50(node, {**body, "from": 0}, 5, sync),
            f"from_{window - page}": _page_p50(
                node, {**body, "from": window - page}, 5, sync)}
        # K3's first call of the deepest page: the base's walk
        seen, current, shims = capture_first_calls()
        current["mix"] = "deep"
        with swapped_kernels(**shims):
            node.search("logs", {**body, "from": window - page})
        a, kw = seen["deep"]["bundle_topk"]
        if kw["ck"] != min(window, 1024):
            raise AssertionError(f"scroll: K3's deep page ran ck {kw['ck']}")
        k3 = measure_bundle(a, kw, reps=10)
        k3["call"] = {"path": "scroll", "from": window - page, "size": page,
                      "B": a[4].shape[0], "ck": kw["ck"],
                      "cap": a[6].shape[0],
                      "clauses": [[r, kd] for r, kd, _f, _w in a[2]]}
        log("scroll K3 deep page: " + json.dumps(k3))
    # a batch of deep pages splits under the transient budget
    deep = [{"query": b["query"], "from": window - page, "size": page}
            for b in mixes["match"][:16]]
    batch = node_search(node, deep)
    one = [node.search("logs", copy.deepcopy(b)) for b in deep[:4]]
    if _node_strip(batch[:4]) != _node_strip(one):
        raise AssertionError("scroll: a batch of deep pages differs from "
                             "the pages one at a time")
    # scan: a range filter in doc order, the total exact
    scan_body = {"query": {"range": {"size": {"gte": 50_000}}}, "size": page}
    count = node.count("logs", {"query": scan_body["query"]})["count"]
    first = node.search("logs", copy.deepcopy(scan_body), scroll="5m",
                        search_type="scan")
    if first["hits"]["hits"] or first["hits"]["total"] != count:
        raise AssertionError("scan: the first response " + json.dumps(
            first["hits"])[:300])
    t0 = time.perf_counter()
    spages = [node.scroll(first["_scroll_id"], "5m") for _ in range(pages)]
    sync()
    out["scan_s"] = time.perf_counter() - t0
    node.clear_scroll([first["_scroll_id"]])
    ids = [h["_id"] for p in spages for h in p["hits"]["hits"]]
    pos = doc_positions(node)
    order = [pos[i] for i in ids]
    if len(ids) != min(window, count) or order != sorted(order) \
            or any(p["hits"]["total"] != count for p in spages) \
            or {h["_score"] for p in spages for h in p["hits"]["hits"]} \
            != {1.0}:
        raise AssertionError("scan: pages not in doc order, or totals off")
    out["scan"] = {"hits": count, "docs_read": len(ids)}
    # dfs: the match and phrase mixes, kernels against plain versions on
    # the first DFS_PLAIN requests (the plain K3 walk takes seconds a call
    # over a 2^21-doc base)
    for name in ("match", "phrase"):
        items = [("logs", b, "dfs_query_then_fetch") for b in mixes[name]]
        dfs = node.msearch(items)["responses"]
        with swapped_kernels(**plain_versions()):
            plain = node.msearch(items[:DFS_PLAIN])["responses"]
        if _node_strip(dfs[:DFS_PLAIN]) != _node_strip(plain) \
                or any(r.get("status") != 200 for r in dfs):
            raise AssertionError(f"dfs {name}: the plain versions differ")
        qtf = node_search(node, mixes[name])
        out[f"dfs_{name}"] = {
            "requests": len(items),
            "hits": sum(r["hits"]["total"] for r in dfs),
            "scores_changed": sum(
                [h["_score"] for h in a["hits"]["hits"]]
                != [h["_score"] for h in b["hits"]["hits"]]
                for a, b in zip(dfs, qtf))}
    return out, launches, k3


def kill_settings(path: str) -> dict:
    return {"node.name": "kill-9", "path.data": path,
            "index.number_of_shards": 2,
            "index.translog.durability": "request",
            "index.shard.check_on_startup": True}


def durability_worker(argv) -> int:
    """`--durability-worker DATA SEED START DEVICE DOCS FLUSH_EVERY
    BATCH`: a request-mode node writing batches of BATCH docs (`ACK
    <ids>` printed after each bulk returned), flushing every FLUSH_EVERY
    docs, `LOADED` printed once DOCS are acked; it runs until it is
    killed."""
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.node import Node
    data, seed, start, device = argv[0], int(argv[1]), int(argv[2]), argv[3]
    n_docs, flush_every, batch = int(argv[4]), int(argv[5]), int(argv[6])
    node = Node(kill_settings(data), device=device)
    if "soak" not in node.indices:
        node.create_index("soak", {"number_of_shards": 2}, KILL_MAPPING)
    i = start
    next_flush = (start // flush_every + 1) * flush_every
    loaded = False
    while True:
        docs = corpus.make_docs(batch, seed=seed * 100_000 + i,
                                start=i, long_every=1000)
        r = node.bulk([("index", {"_index": "soak", "_id": did,
                                  "doc": {**d, "key": did}})
                       for did, d in docs])
        if r["errors"]:
            raise AssertionError("worker bulk failed")
        print("ACK " + " ".join(did for did, _ in docs), flush=True)
        i += batch
        if i >= next_flush:
            node.flush("soak")
            next_flush += flush_every
        if not loaded and i - start >= n_docs:
            print("LOADED", flush=True)
            loaded = True


def kill_round(data: str, seed: int, start: int, fault: str | None,
               kill_after: float | None, device: str, n_docs: int,
               flush_every: int, batch: int,
               timeout_s: float = 600.0) -> dict:
    import signal
    env = dict(os.environ)
    env.pop("ES_TPU_FAULT_INJECT", None)
    if fault:
        env["ES_TPU_FAULT_INJECT"] = fault
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--durability-worker",
         data, str(seed), str(start), device, str(n_docs),
         str(flush_every), str(batch)],
        stdout=subprocess.PIPE, text=True, env=env)
    acked: list[int] = []
    kill_at = None
    loaded_s = None
    try:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if kill_at is not None and time.time() >= kill_at:
                os.kill(proc.pid, signal.SIGKILL)
                break
            line = proc.stdout.readline()
            if not line:
                break          # the injected kill=1 crash point fired
            if line.startswith("ACK "):
                acked += [int(x) for x in line.split()[1:]]
            elif line.startswith("LOADED") and kill_after is not None:
                loaded_s = time.perf_counter() - t0
                kill_at = time.time() + kill_after
    finally:
        try:
            os.kill(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        rest, _ = proc.communicate(timeout=60)
    for line in (rest or "").splitlines():
        if line.startswith("ACK "):
            acked += [int(x) for x in line.split()[1:]]
    if proc.returncode != -signal.SIGKILL:
        raise AssertionError(f"kill round: the worker exited "
                             f"{proc.returncode}, not by SIGKILL")
    if not acked:
        raise AssertionError("kill round: the worker acked nothing")
    return {"acked": acked, "s": time.perf_counter() - t0,
            "loaded_s": loaded_s}


def kill_verify(data: str, acked: set, dev, sync) -> dict:
    """Boot the node on `dev` over the killed one's data: the store
    verifies clean, every acked doc comes back through get and a term
    query, and responses with the plain versions swapped in equal the
    kernels'."""
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.node import Node
    t0 = time.perf_counter()
    node = Node(kill_settings(data), device=dev)
    try:
        boot_s = time.perf_counter() - t0
        rep = node.verify_integrity()
        if not rep["clean"]:
            raise AssertionError("kill -9: integrity " + json.dumps(rep)[:500])
        dur = node.nodes_stats()["nodes"]["kill-9"]["indices"]["durability"]
        if dur["shards_failed_corrupt"]:
            raise AssertionError("kill -9: a shard was contained")
        missing = []
        for i in sorted(acked):
            try:
                node.get_doc("soak", str(i))
            except Exception:  # noqa: BLE001 — a missing doc
                missing.append(i)
        ids = sorted(acked)
        found = 0
        for lo in range(0, len(ids), 4096):
            bodies = [{"query": {"term": {"key": str(i)}}, "size": 1,
                       "_source": False} for i in ids[lo:lo + 4096]]
            for i, r in zip(ids[lo:lo + 4096],
                            node_search(node, bodies, index="soak")):
                hits = r["hits"]["hits"]
                if r["hits"]["total"] == 1 and hits[0]["_id"] == str(i):
                    found += 1
                else:
                    missing.append(i)
        if missing:
            raise AssertionError(f"kill -9: acked docs lost: "
                                 f"{sorted(set(missing))[:20]}")
        mixes = corpus.request_mixes(16, seed=9, n_docs=1000)
        bodies = [b for m in ("match", "bool_aggs", "match_range_aggs",
                              "phrase", "stats_aggs") for b in mixes[m]]
        got = node_search(node, bodies, index="soak")
        with swapped_kernels(**plain_versions()):
            plain = node_search(node, bodies, index="soak")
        if _node_strip(got) != _node_strip(plain):
            raise AssertionError("kill -9: the plain versions differ")
        return {"boot_s": boot_s, "docs": node.indices["soak"].doc_count(),
                "acked": len(acked), "found_by_term": found,
                "recovery": recovery_parts(node, "soak"),
                "durability": dur}
    finally:
        node.close()


def kill_rounds(dev, sync, device_arg: str, seed: int = 7,
                n_docs: int = KILL_DOCS,
                flush_every: int = KILL_FLUSH_EVERY) -> list:
    """The kill -9 rounds: a request-mode node in a subprocess, killed
    once at a random instant after `n_docs` acked docs, once by a crash
    point at a translog append, once at a commit; after each, a restart
    on `dev` recovers every acked doc."""
    data = data_dir("kill")
    rng = np.random.default_rng(seed)
    acked_all: set[int] = set()
    start = 0
    out = []
    for n, (fault, kill_after) in enumerate(KILL_ROUNDS):
        delay = float(rng.uniform(0.2, 1.5)) if kill_after else None
        r = kill_round(data, 1000 + n, start, fault, delay, device_arg,
                       n_docs, flush_every,
                       KILL_FAULT_BATCH if fault else KILL_BATCH)
        acked_all.update(r["acked"])
        start = max(r["acked"]) + 1
        v = kill_verify(data, acked_all, dev, sync)
        rec = {"round": n, "fault": fault, "kill_after_s": delay,
               "worker_s": r["s"], "loaded_s": r["loaded_s"],
               "acked_this_round": len(r["acked"]), **v}
        log("kill -9: " + json.dumps(rec))
        out.append(rec)
    shutil.rmtree(data, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# checks in processes of their own, beside the main process's phases
# ---------------------------------------------------------------------------

# `--worker KIND OUT DEVICE [ARG]`: a self-contained part of the run in a
# process of its own, its result as JSON in OUT, its log lines on its
# stdout. kernels: the kernel sweeps (ARG the --ab-parent directory or
# ""); kill9: the kill -9 rounds; small_node: the small node's card-vs-CPU
# steps (ARG its docs per shard)
WORKER_KINDS = ("kernels", "kill9", "small_node")


def run_worker(kind: str, out: str, device: str, arg: str) -> int:
    import torch
    if device == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        sync = torch.cuda.synchronize
    else:
        dev, sync = "cpu", (lambda: None)
    t0 = time.perf_counter()
    if kind == "kernels":
        from elasticsearch_tpu_torch.ops import cuda_scoring as cs
        cs.build()
        old = load_parent_k3(arg) if arg else None
        sweep, worst = kernel_sweep(dev, np.random.default_rng(42), old=old)
        result = {"sweep": sweep, "worst": worst}
    elif kind == "kill9":
        result = {"rounds": kill_rounds(dev, sync, device)
                  if device == "cuda" else
                  kill_rounds(dev, sync, device, n_docs=300,
                              flush_every=200)}
    else:
        torch.set_num_threads(WINDOW_THREADS)
        result = small_node_check(int(arg), 8 if device == "cuda" else 4,
                                  dev, sync)
    result["worker_s"] = time.perf_counter() - t0
    with open(out, "w") as f:
        json.dump(result, f)
    return 0


_WORKERS: list[dict] = []     # started and not yet finished


def start_worker(kind: str, device: str, arg: str = "") -> dict:
    """`kind` started in a process of its own (`run_worker`), its stdout
    to a file beside its result's."""
    root = data_dir(f"worker-{kind}")
    out, log_path = (os.path.join(root, n) for n in ("out.json", "log.txt"))
    log_f = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", kind, out,
         device, arg], stdout=log_f, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    w = {"kind": kind, "proc": proc, "out": out, "log": log_path,
         "log_f": log_f, "root": root}
    _WORKERS.append(w)
    return w


def finish_worker(w: dict, timeout_s: float = 900.0) -> dict:
    """Wait for a worker; its log lines go to this run's log, and any
    exit but 0 fails the run with its last lines. Returns its result,
    with `wait_s`, the seconds this process waited for it."""
    t0 = time.perf_counter()
    try:
        rc = w["proc"].wait(timeout=timeout_s)
    finally:
        stop_workers([w])
    wait_s = time.perf_counter() - t0
    with open(w["log"]) as f:
        lines = f.read().splitlines()
    for line in lines:
        log(line)
    if rc != 0:
        raise AssertionError(f"worker {w['kind']} exited {rc}: "
                             + "\n".join(lines[-20:]))
    with open(w["out"]) as f:
        result = json.load(f)
    shutil.rmtree(w["root"], ignore_errors=True)
    result["wait_s"] = wait_s
    return result


def stop_workers(workers=None) -> None:
    """Kill the workers still running and what they started (all of them
    by default: a failed run leaves none behind)."""
    import signal
    for w in list(_WORKERS if workers is None else workers):
        if w["proc"].poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(w["proc"].pid, signal.SIGKILL)
            w["proc"].wait()
        w["log_f"].close()
        if w in _WORKERS:
            _WORKERS.remove(w)


# ---------------------------------------------------------------------------
# phases on the card
# ---------------------------------------------------------------------------


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def plain_run(fn):
    """(result, ms) of a plain version: the result of a first call, the
    time of a second one (a first call also pays one-off allocations)."""
    out = fn()
    return out, cuda_ms(fn, 1, warmup=0)


def dense_bound(tids, qt, share):
    """Least time of K1: the forward index and the query terms read
    once, the scores written once, over the HBM rate; and the work this
    run's data needs, over the instruction rate (_bound): a signature
    test per (row, doc) pair (four ANDs, three ORs and a compare of the
    128-bit signatures) and, for the `share` of pairs whose signatures
    meet (`dense_candidates_ref`), a compare and an add per slot and
    term and a multiply and an add per term. The other pairs are +0.0
    without the compares (csrc/dense_score.cu)."""
    cap, L = tids.shape
    B, Q = qt.shape
    nbytes = cap * L * 8 + B * Q * 8 + B * cap * 4
    return _bound(nbytes, B * cap * (8 + share * Q * (2 * L + 2)))


def scatter_bound(docs, cap):
    B, N = docs.shape
    nbytes = B * N * 8 + B * cap * 4
    ops = int(((docs >= 0) & (docs < cap)).sum())   # one add per posting
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def measure_dense(args, reps, old=None):
    """K1 vs its plain version, bit for bit, with the share of pairs its
    signature filter scores (`candidate_share`, the plain mirror
    `dense_candidates_ref`: the rest are written +0.0 without the
    compares); with the previous commit's ops (`old`), its K1 in turns
    with this one (outputs equal)."""
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    got = cs.dense_score(*args)
    want, plain_ms = plain_run(lambda: cs.dense_score_ref(*args))
    if not _same_bits(got, want):
        raise AssertionError(f"dense_score != plain at {args[2].shape}")
    err = float((got - want).abs().nan_to_num().max())
    share = float(cs.dense_candidates_ref(*args).float().mean())
    bound_ms, bound_by = dense_bound(args[0], args[2], share)
    m = {"ms": cuda_ms(lambda: cs.dense_score(*args), reps),
         "plain_ms": plain_ms,
         "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
         "max_abs_err": err, "candidate_share": share}
    if old is not None:
        if not _same_bits(old.dense_score(*args), got):
            raise AssertionError("dense_score != the previous dense_score")
        m["ab"] = ab_turns(lambda: cs.dense_score(*args),
                           lambda: old.dense_score(*args), reps)
    return m


def ab_turns(new_fn, old_fn, reps: int) -> dict:
    """This checkout's kernel against the previous commit's (--ab-parent)
    on the same inputs, timed in turns (new, previous, previous, new)."""
    turns = {"new": [], "previous": []}
    for who in ("new", "previous", "previous", "new"):
        turns[who].append(cuda_ms(new_fn if who == "new" else old_fn, reps))
    new_ms, old_ms = (float(np.mean(turns[k])) for k in ("new", "previous"))
    return {"previous_ms": old_ms, "new_ms": new_ms,
            "speedup": old_ms / new_ms, "turns": turns}


def measure_scatter(docs, vals, cap, reps, old=None):
    """K2 vs its plain version; with the previous commit's ops (`old`),
    also its K2 in turns with this one (outputs equal)."""
    import torch
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    got = cs.scatter_add(docs, vals, cap)
    want, plain_ms = plain_run(lambda: cs.scatter_add_ref(docs, vals, cap))
    if not torch.equal(got, want):
        raise AssertionError(f"scatter_add != plain at {tuple(docs.shape)}")
    err = float((got - want).abs().max())
    idx = torch.where((docs >= 0) & (docs < cap), docs, cap).long()

    def library():
        out = torch.zeros((docs.shape[0], cap + 1), dtype=torch.float32,
                          device=docs.device)
        return out.scatter_add_(1, idx, vals)

    bound_ms, bound_by = scatter_bound(docs, cap)
    m = {"ms": cuda_ms(lambda: cs.scatter_add(docs, vals, cap), reps),
         "plain_ms": plain_ms,
         "library_ms": cuda_ms(library, reps),
         "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err}
    if old is not None:
        if not torch.equal(old.scatter_add(docs, vals, cap), got):
            raise AssertionError("scatter_add != the previous scatter_add")
        m["ab"] = ab_turns(lambda: cs.scatter_add(docs, vals, cap),
                           lambda: old.scatter_add(docs, vals, cap), reps)
    return m


def scan_bound(w, perm, pos):
    """Least time of ordered_prefix: the weights, perm and positions read
    once, the prefixes written; one add per weight and per level total."""
    from elasticsearch_tpu_torch.ops.cuda_scoring import scan_scratch
    B, n = w.shape
    nbytes = (B * n * 4 + (0 if perm is None else n * 4) + pos.numel() * 4
              + B * pos.shape[-1] * 4)
    return _bound(nbytes, B * (n + scan_scratch(n)))


def perm_kind(perm) -> str:
    """The scan's permutation: none, a keyword sort (docs ascending
    within each key: nearly every step ascends) or a timestamp sort (a
    random order: the corpus draws @timestamp per doc)."""
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    if perm is None:
        return "none"
    return "timestamp sort" if cs.perm_scattered(perm) else "keyword sort"


def measure_scan(w, perm, pos, reps, old=None):
    """The scan kernel vs its plain version (XLA's cumsum order), which
    it must equal bit for bit; library: torch.cumsum over the same rows,
    gathered through perm first (another order: a yardstick only). With
    the previous commit's ops (`old`), its scan in turns with this one
    (outputs equal)."""
    import torch
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    from elasticsearch_tpu_torch.ops import ordered
    got = cs.ordered_prefix(w, perm, pos)
    want, plain_ms = plain_run(lambda: ordered.prefix_at(w, perm, pos))
    if not torch.equal(got, want):
        raise AssertionError(f"ordered_prefix != plain at {tuple(w.shape)}")
    bound_ms, bound_by = scan_bound(w, perm, pos)
    idx = None if perm is None else perm.long()
    m = {"perm": perm_kind(perm),
         "ms": cuda_ms(lambda: cs.ordered_prefix(w, perm, pos), reps),
         "plain_ms": plain_ms,
         "library_ms": cuda_ms(
             lambda: torch.cumsum(w if idx is None else w[:, idx], dim=-1),
             reps),
         "bound_ms": bound_ms, "bound_by": bound_by,
         "max_abs_err": float((got - want).abs().max())}
    if perm is not None:
        # the two routes through perm in turns, whichever this perm takes:
        # the weights copied doc-major first (eight rows a sector), and
        # the gathers straight from the rows
        routes = {k: (lambda dm=k: cs.ordered_prefix(w, perm, pos,
                                                     doc_major=dm))
                  for k in (True, False)}
        if not torch.equal(routes[not cs.perm_scattered(perm)](), got):
            raise AssertionError("ordered_prefix's other route != plain")
        t = ab_turns(routes[True], routes[False], reps)
        m["routes"] = {"rows_ms": t["previous_ms"],
                       "doc_major_ms": t["new_ms"]}
    if old is not None:
        if not torch.equal(old.ordered_prefix(w, perm, pos), got):
            raise AssertionError("ordered_prefix != the previous scan")
        m["ab"] = ab_turns(lambda: cs.ordered_prefix(w, perm, pos),
                           lambda: old.ordered_prefix(w, perm, pos), reps)
    return m


def measure_tree(x, reps, old=None):
    """The tree-sum kernel vs its plain version (XLA's reduction order),
    bit for bit; library: x.sum(-1) (another order). With `old`, the
    previous commit's tree in turns with this one; its outputs equal
    this one's where no level pads (a power-of-two length, the views'
    blocks), its own uncentred windows elsewhere."""
    import torch
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    from elasticsearch_tpu_torch.ops import ordered
    got = cs.ordered_sum(x)
    want, plain_ms = plain_run(lambda: ordered.xla_block_sum(x))
    if not torch.equal(got, want):
        raise AssertionError(f"ordered_sum != plain at {tuple(x.shape)}")
    bound_ms, bound_by = _bound(x.numel() * 4 + got.numel() * 4, x.numel())
    m = {"ms": cuda_ms(lambda: cs.ordered_sum(x), reps),
         "plain_ms": plain_ms,
         "library_ms": cuda_ms(lambda: x.sum(dim=-1), reps),
         "bound_ms": bound_ms, "bound_by": bound_by,
         "max_abs_err": float((got - want).abs().max())}
    if old is not None:
        n = x.shape[-1]
        same = torch.equal(old.ordered_sum(x), got)
        if not same and all(lo == 0 for lo, _k in ordered.sum_windows(n)):
            raise AssertionError("ordered_sum != the previous tree")
        m["ab"] = {**ab_turns(lambda: cs.ordered_sum(x),
                              lambda: old.ordered_sum(x), reps),
                   "outputs_equal": same}
    return m


@functools.lru_cache(maxsize=None)
def add_latency(dev) -> dict:
    """The f32 add's dependent latency on this card, the bucket stats'
    bound per doc of a fold: one thread's chain of 2^24 __fadd_rn
    (csrc/bucket_stats.cu `add_chain_kernel`), timed by CUDA events and
    by the SM's cycle counter. Measured once a run."""
    import torch
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    n = 1 << 24
    x = torch.tensor([1.5, -0.25], dtype=torch.float32, device=dev)
    out = torch.empty(1, dtype=torch.float32, device=dev)
    cycles = torch.empty(1, dtype=torch.int64, device=dev)
    fn = cs._fn("bucket_add_chain")

    def run():
        cs._raise_on(fn(x.data_ptr(), out.data_ptr(), cycles.data_ptr(), n,
                        cs._stream(dev)), "bucket_add_chain")

    ms = cuda_ms(run, 3)
    return {"adds": n, "ns_per_add": ms * 1e6 / n,
            "cycles_per_add": int(cycles.item()) / n}


def bucket_hottest(ids, mask, n_buckets) -> int:
    """The longest fold: the matched docs of the busiest (row, bucket)."""
    from elasticsearch_tpu_torch.ops import ordered
    return int(ordered.bucket_count(ids, mask, n_buckets).max()) \
        if n_buckets else 0


def bucket_bound(ids, mask, n_buckets, n_stats, ns_per_add):
    """Least time of ordered_bucket_stats, the larger of two: the mask,
    ids and values read once and the stats written once, over the
    memory's rate; the hottest (row, bucket)'s fold, one dependent add
    per matched doc at the measured add latency."""
    B, cap = mask.shape
    nbytes = B * cap + cap * 8 + n_stats * B * n_buckets * 4
    t_bytes = nbytes / H100_BYTES_PER_S
    t_chain = bucket_hottest(ids, mask, n_buckets) * ns_per_add * 1e-9
    return max(t_bytes, t_chain) * 1e3, ("bytes" if t_bytes >= t_chain
                                         else "operations")


def _same_bits(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def measure_bucket_stats(ids, mask, values, n_buckets, stats, reps,
                         ns_per_add, old=None, plain=None,
                         keep_plain: bool = False):
    """The bucket-stats kernel vs its plain version (XLA's scatter
    results), every stat bit for bit; library: what the main path ran
    for the count, min and max before this kernel, index_add_ and two
    scatter_reduce_ (atomics; the sums had no library call). With the
    previous commit's ops (`old`): in turns, this kernel against that
    commit's bucket sums plus those library calls (`ab`: the work it
    replaces) and against its bucket sums alone on the sums (`ab_sums`),
    the sums equal."""
    import torch
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    from elasticsearch_tpu_torch.ops import ordered
    args = (ids, mask, values, n_buckets, stats)
    got = cs.ordered_bucket_stats(*args)
    # `plain`: (result, ms) of the plain version on these inputs for a
    # superset of `stats`, taken by an earlier row
    want, plain_ms = plain if plain is not None else plain_run(
        lambda: cs.ordered_bucket_stats_ref(*args))
    for st in stats:
        if not _same_bits(got[st], want[st]):
            raise AssertionError(f"ordered_bucket_stats {st} != plain at "
                                 f"{tuple(mask.shape)}, {n_buckets} buckets")
    B = mask.shape[0]
    kept = ordered.bucket_ids_kept(ids, n_buckets)
    idx = kept[None, :].expand(B, -1)
    inf = float("inf")

    def library():
        cnt = torch.zeros((B, n_buckets + 1), device=mask.device)
        cnt.index_add_(1, kept, mask.float())
        out = [cnt]
        for fill, how in ((inf, "amin"), (-inf, "amax")):
            o = torch.full((B, n_buckets + 1), fill, device=mask.device)
            out.append(o.scatter_reduce_(
                1, idx, torch.where(mask, values[None, :], fill), reduce=how,
                include_self=True))
        return out

    bound_ms, bound_by = bucket_bound(ids, mask, n_buckets, len(stats),
                                      ns_per_add)
    m = {"stats": list(stats),
         "ms": cuda_ms(lambda: cs.ordered_bucket_stats(*args), reps),
         # the bucket layout, built once per bucket-id tensor (the main
         # path: once per doc-space sub-agg call), outside `ms`
         "layout_ms": cuda_ms(lambda: cs.bucket_layout(ids.clone(),
                                                       n_buckets), 3),
         "plain_ms": plain_ms,
         "library_ms": cuda_ms(library, max(2, reps // 4)),
         "bound_ms": bound_ms, "bound_by": bound_by,
         "hottest": bucket_hottest(ids, mask, n_buckets),
         "max_abs_err": max(float((got[st] - want[st]).abs().nan_to_num()
                                  .max()) for st in stats),
         "plain_shared": plain is not None}
    if keep_plain:
        m["_plain"] = (want, plain_ms)
    if old is not None and hasattr(old, "ordered_bucket_stats"):
        # a parent that has this kernel already: the two in turns
        prev = old.ordered_bucket_stats(*args)
        for st in stats:
            if not _same_bits(prev[st], got[st]):
                raise AssertionError(f"ordered_bucket_stats {st} != the "
                                     f"previous kernel's")
        m["ab"] = ab_turns(lambda: cs.ordered_bucket_stats(*args),
                           lambda: old.ordered_bucket_stats(*args),
                           max(2, reps // 4))
    elif old is not None:
        sums = [st for st in ("sum", "sum_sq") if st in stats]
        for st in sums:
            prev = old.ordered_bucket_sum(ids, mask, values, n_buckets,
                                          st == "sum_sq")
            if not _same_bits(prev, got[st]):
                raise AssertionError(f"ordered_bucket_stats {st} != the "
                                     f"previous bucket sum")

        def previous():
            for st in sums:
                old.ordered_bucket_sum(ids, mask, values, n_buckets,
                                       st == "sum_sq")
            library()

        m["ab"] = ab_turns(lambda: cs.ordered_bucket_stats(*args), previous,
                           max(2, reps // 4))
        if sums:
            m["ab_sums"] = ab_turns(
                lambda: cs.ordered_bucket_stats(ids, mask, values, n_buckets,
                                                tuple(sums)),
                lambda: [old.ordered_bucket_sum(ids, mask, values, n_buckets,
                                                st == "sum_sq")
                         for st in sums], reps)
    return m


def scan_sweep(dev, rng, B: int = 256, cap: int = 1 << 20,
               old=None) -> list[dict]:
    """The agg sums at B 256 over 2^20 docs, drawn like the agg mixes'
    inputs (corpus.make_docs' columns): `size` weights under a range
    mask, summed per `status` key (terms: the keyword sort's bounds), per
    day of `@timestamp` (date_histogram: searchsorted edges) and over the
    rows as they are (no perm); the tree on the agg views' 512- and
    128-doc blocks, whole rows and rows off a power of two; the bucket
    stats per `status` (terms -> extended_stats: three buckets, one of
    60% of the docs; its sum alone), over 1,000 buckets and into one.
    With `old`, the previous commit's scan, tree and bucket sums in
    turns."""
    import torch
    from elasticsearch_tpu_torch import corpus
    status = rng.integers(0, len(corpus.STATUS), size=cap)
    ords = np.array([sorted(set(corpus.STATUS)).index(corpus.STATUS[i])
                     for i in range(len(corpus.STATUS))])[status]
    size = rng.integers(100, 100_001, size=cap).astype(np.float32)
    secs = rng.integers(0, corpus.SPAN_MILLIS // 1000, size=cap)
    lo = torch.from_numpy(rng.integers(100, 60_000, size=(B, 1))
                          .astype(np.float32)).to(dev)
    sz = torch.from_numpy(size).to(dev)[None, :]
    w = torch.where((sz >= lo) & (sz <= lo + 40_000), sz, 0.0).contiguous()
    rows = []
    perm = np.argsort(ords, kind="stable").astype(np.int32)
    starts = np.searchsorted(ords[perm], np.arange(ords.max() + 2))
    tperm = np.argsort(secs, kind="stable").astype(np.int32)
    edges = np.searchsorted(secs[tperm], np.arange(31) * 86_400)
    for label, p, pos in (("terms status", perm, starts),
                          ("date_histogram day", tperm, edges),
                          ("no perm, day bounds", None, edges)):
        m = measure_scan(w, None if p is None else torch.from_numpy(p).to(dev),
                         torch.from_numpy(pos.astype(np.int32)).to(dev),
                         reps=10, old=old)
        rows.append({"kernel": "ordered_prefix", "agg": label, "B": B,
                     "cap": cap, "positions": int(len(pos)), **m})
        log("kernel_sweep " + json.dumps(rows[-1]))
    for label, x in (("view block sums", w.view(B, cap // 512, 512)),
                     ("view blocks of 128", w.view(B, cap // 128, 128)),
                     ("whole rows", w),
                     ("rows of 100,000", w[:, :100_000].contiguous()),
                     ("rows of 1,000", w.reshape(-1)[:65_536 * 1000]
                      .view(65_536, 1000))):
        m = measure_tree(x, reps=10, old=old)
        rows.append({"kernel": "ordered_sum", "agg": label,
                     "shape": list(x.shape), **m})
        log("kernel_sweep " + json.dumps(rows[-1]))
    # the bucket stats: the plain fold takes one pass per doc of the
    # longest fold, so the rows keep it in the 10^5
    sz_ok = (sz >= lo) & (sz <= lo + 40_000)
    ids = torch.from_numpy(ords.astype(np.int32)).to(dev)
    lat = add_latency(dev)
    log("add latency " + json.dumps(lat))
    ext = ("sum", "sum_sq", "count", "min", "max")
    # the sum-only row is held against the extended_stats row's plain
    # result (the same inputs, the plain fold of all five stats); the one
    # bucket row folds 2^19 docs (its plain fold is one pass per doc)
    half = cap // 2
    shared = {}
    for label, b_ids, n_b, rows_b, n, stats in (
            ("terms status -> extended_stats", ids, 3, 128, cap, ext),
            ("terms status -> sum", ids, 3, 128, cap, ("sum",)),
            ("1,000 buckets -> extended_stats", torch.from_numpy(
                rng.integers(-5, 1005, size=cap).astype(np.int32)).to(dev),
             1000, 256, cap, ext),
            ("one bucket -> extended_stats",
             torch.zeros(half, dtype=torch.int32, device=dev), 1, 1, half,
             ext)):
        m = measure_bucket_stats(
            b_ids, sz_ok[:rows_b, :n].contiguous(), sz[0, :n].contiguous(),
            n_b, stats, reps=8, ns_per_add=lat["ns_per_add"], old=old,
            plain=shared.get("terms status") if stats == ("sum",) else None,
            keep_plain=label == "terms status -> extended_stats")
        if "_plain" in m:
            shared["terms status"] = m.pop("_plain")
        rows.append({"kernel": "ordered_bucket_stats", "agg": label,
                     "B": rows_b, "cap": n, "n_buckets": n_b, **m})
        log("kernel_sweep " + json.dumps(rows[-1]))
    rows += subnormal_rows(dev, rng)
    return rows


def subnormal_rows(dev, rng, B: int = 64, cap: int = 1 << 14) -> list:
    """The agg kernels on values drawn from SUBNORMALS (subnormals, signed
    zeros, normal values whose sums cancel into the subnormal range):
    each output bit for bit its plain version's, which flushes as XLA's
    CPU runtime does (ops/ordered.ftz)."""
    import torch
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    from elasticsearch_tpu_torch.ops import ordered
    vals = torch.from_numpy(rng.choice(np.array(SUBNORMALS, np.float32),
                                       size=(B, cap))).to(dev)
    perm = torch.from_numpy(rng.permutation(cap).astype(np.int32)).to(dev)
    pos = torch.from_numpy(np.sort(rng.integers(0, cap + 1, size=300))
                           .astype(np.int32)).to(dev)
    ids = torch.from_numpy(rng.integers(-1, 4, size=cap)
                           .astype(np.int32)).to(dev)
    mask = torch.from_numpy(rng.random((B, cap)) < 0.7).to(dev)
    calls = {
        "ordered_prefix, perm": (lambda: cs.ordered_prefix(vals, perm, pos),
                                 lambda: ordered.prefix_at(vals, perm, pos)),
        "ordered_prefix, no perm": (
            lambda: cs.ordered_prefix(vals, None, pos),
            lambda: ordered.prefix_at(vals, None, pos)),
        "ordered_sum, rows": (lambda: cs.ordered_sum(vals),
                              lambda: ordered.xla_block_sum(vals)),
        "ordered_sum, rows of 1,000": (
            lambda: cs.ordered_sum(vals[:, :1000].contiguous()),
            lambda: ordered.xla_block_sum(vals[:, :1000].contiguous())),
    }
    rows = []
    for label, (kernel, plain) in calls.items():
        got, want = kernel(), plain()
        if not _same_bits(got, want):
            raise AssertionError(f"{label}: the kernel != plain on "
                                 "subnormal inputs")
        rows.append({"kernel": label.split(",")[0], "agg": "subnormal, "
                     + label.split(", ", 1)[1], "shape": list(vals.shape),
                     "max_abs_err": 0.0})
    args = (ids, mask, vals[0].contiguous(), 3, cs.BUCKET_STATS)
    got = cs.ordered_bucket_stats(*args)
    want = cs.ordered_bucket_stats_ref(*args)
    for st in cs.BUCKET_STATS:
        if not _same_bits(got[st], want[st]):
            raise AssertionError(f"ordered_bucket_stats {st} != plain on "
                                 "subnormal inputs")
    rows.append({"kernel": "ordered_bucket_stats",
                 "agg": "subnormal, 3 buckets -> extended_stats",
                 "B": B, "cap": cap, "max_abs_err": 0.0})
    for r in rows:
        log("kernel_sweep " + json.dumps(r))
    return rows


def _doc_bytes(clauses, text_cols, num_cols) -> int:
    """Bytes per doc of the doc-major columns a bundle's clauses read,
    each (field, column) once: a dense clause its slot ids and impacts,
    a range clause the values and exists flags, a positional clause per
    field the slot ids, the int16 pack and the one norm its leaf reads
    (k1ln for phrase / span, lnorm for BM25F)."""
    from elasticsearch_tpu_torch.ops.scoring import (
        DENSE_CLAUSE_KINDS, RANGE_CLAUSE_KINDS, clause_fields,
        positional_prefix)
    cols = set()
    for _r, kd, f, _w in clauses:
        head = positional_prefix(kd)
        if kd in DENSE_CLAUSE_KINDS:
            cols |= {(f, "fwd_tids"), (f, "fwd_imps")}
        elif kd in RANGE_CLAUSE_KINDS:
            cols |= {(f, "values"), (f, "exists")}
        elif head:
            norm = "lnorm" if head == "bm25f" else "k1ln"
            cols |= {(g, c) for g in clause_fields(f)
                     for c in ("fwd_tids", "fwd_pos", norm)}
    nbytes = 0
    for f, c in cols:
        t = (num_cols if c in ("values", "exists") else text_cols)[f][c]
        nbytes += t.element_size() * (t.numel() // t.shape[0])
    return nbytes


def _pos_ops(kind, field, inp, text_cols) -> int:
    """Operations per (row, doc) of a positional clause, counting only
    the decode every algorithm needs (a compare per slot to find each
    term, a compare and an add per position entry of its slot) and the
    f32 impact chain; the sweeps' own steps come on top, so the bound
    stays a lower bound."""
    from elasticsearch_tpu_torch.ops.scoring import (clause_fields,
                                                     positional_prefix)
    def lp(f):
        c = text_cols[f]
        L = c["fwd_tids"].shape[1]
        return L, c["fwd_pos"].shape[1] // L
    if positional_prefix(kind) == "bm25f":
        nt = inp[0].shape[2]
        return sum(nt * (L + 2 * P + 4) for L, P in
                   (lp(f) for f in clause_fields(field))) + 3 * nt
    L, P = lp(field)
    return inp[0].shape[1] * (L + 2 * P) + 5


def _bound(nbytes: float, ops: float):
    """(ms, "bytes" or "operations"): the larger of nbytes over the HBM
    rate and ops, each a compare, select, add or multiply, over one
    instruction a lane a clock (H100_F32_OPS_PER_S, 33.5e12; the data
    sheet's 67e12 counts an FMA as two operations)."""
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bundle_bound(args, kw):
    """Least time of one K3 walk: the larger of (a) the bytes it must
    move, the live flags and the columns of _doc_bytes for the tiles
    some row can match (each read once), the per-row inputs (a knn_vec
    clause's B x cap f32 similarity column among them), and the
    outputs, over the HBM rate,
    and (b) its work, per dense clause a compare and an add per slot
    and term plus a multiply and add per term (a field wider than
    BUNDLE_SLOTS: a table lookup per slot, shared by a batch tile's
    BUNDLE_BT rows, and an add, a multiply and an add per term), 3 ops
    per range clause, an add per knn_vec clause, a positional clause's
    decode (_pos_ops), 2 for the combine
    and 1 for the selection, for every doc of every (row, tile) that can
    match, over the instruction rate (_bound)."""
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    from elasticsearch_tpu_torch.ops.scoring import (
        DENSE_CLAUSE_KINDS, RANGE_CLAUSE_KINDS, positional_prefix)
    text_cols, num_cols, clauses, cl_inputs, msm, boost, live, can, ub = args
    ck, emit = kw["ck"], kw["emit_match"]
    B, J = can.shape
    cap = live.shape[0]
    tile = cap // J
    dense = [(inp[0].shape[1], text_cols[f]["fwd_tids"].shape[1])
             for (_r, kd, f, _w), inp in zip(clauses, cl_inputs)
             if kd in DENSE_CLAUSE_KINDS]
    n_range = sum(kd in RANGE_CLAUSE_KINDS for _r, kd, _f, _w in clauses)
    doc_bytes = 1 + _doc_bytes(clauses, text_cols, num_cols)
    # per-row inputs, a knn_vec clause's [B, cap] similarity column and
    # its exists flags included
    in_row = sum(t.numel() * t.element_size() for inp in cl_inputs
                 for t in inp) + B * 8
    n_vec = sum(kd == "knn_vec" for _r, kd, _f, _w in clauses)
    nbytes = (int(can.any(dim=0).sum()) * tile * doc_bytes + in_row
              + B * J * 5 + B * J * (8 + 8 * ck) + (B * cap if emit else 0))
    per_doc = (sum(q * (2 * L + 2) if L <= cs.BUNDLE_SLOTS
                   else L / cs.BUNDLE_BT + 3 * q for q, L in dense)
               + 3 * n_range + 2
               + n_vec
               + (1 if ck else 0)
               + sum(_pos_ops(kd, f, inp, text_cols)
                     for (_r, kd, f, _w), inp in zip(clauses, cl_inputs)
                     if positional_prefix(kd)))
    return _bound(nbytes, int(can.sum()) * tile * per_doc)


def leaf_bound(kind, field, inp, cols):
    """Least time of the unfused positional leaf: every doc's columns of
    _doc_bytes read once, the parameters, the [B, cap] score and mask
    written; the decode work of _pos_ops for every (row, doc)."""
    from elasticsearch_tpu_torch.ops.scoring import clause_fields
    B = inp[0].shape[0]
    cap = cols[clause_fields(field)[0]]["fwd_tids"].shape[0]
    nbytes = (cap * _doc_bytes((("should", kind, field, False),), cols, {})
              + sum(t.numel() * 4 for t in inp) + B * cap * 5)
    return _bound(nbytes, B * cap * _pos_ops(kind, field, inp, cols))


def leaf_decode_share(kind, field, inp, cols) -> float:
    """Share of (row, doc) pairs the unfused leaf decodes: the doc holds
    every term of the row (phrase / span; BM25F: any (field, term))."""
    import torch
    from elasticsearch_tpu_torch.ops.scoring import (clause_fields,
                                                     positional_prefix)
    bm25f = positional_prefix(kind) == "bm25f"
    qt = inp[0] if bm25f else inp[0][:, None, :]       # [B, fields, terms]
    tids = [cols[f]["fwd_tids"] for f in clause_fields(field)]
    hits = 0
    for r0 in range(0, qt.shape[0], 8):                 # 8 rows at a time
        q = qt[r0:r0 + 8]
        per = torch.stack([torch.stack([
            ((t[None, :, :] == q[:, fi, ti, None, None]).any(-1)
             & (q[:, fi, ti, None] >= 0))
            for ti in range(q.shape[2])], dim=1)
            for fi, t in enumerate(tids)], dim=1)     # [b, F, T, cap]
        hit = per.flatten(1, 2).any(1) if bm25f else per.flatten(1, 2).all(1)
        hits += int(hit.sum())
    return hits / (qt.shape[0] * tids[0].shape[0])


def _first_rows(inp: tuple, rows: int | None) -> tuple:
    """A clause's per-row inputs cut to their first `rows` rows."""
    return inp if rows is None else tuple(t[:rows] for t in inp)


def measure_leaf(args, reps, rows=None, old=None):
    """The unfused positional leaf vs its plain version; with `rows`, the
    plain version computes (and is timed on) only the first rows, which
    the kernel's rows are held against (each (row, doc) is computed on
    its own, so the cut changes no number). With the previous commit's
    ops (`old`), its leaf in turns with this one (outputs equal)."""
    import torch
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    kind, field, inp, cols = args
    got = cs.positional_leaf(*args)
    want, plain_ms = plain_run(lambda: cs.positional_leaf_ref(
        kind, field, _first_rows(inp, rows), cols))
    n = want[0].shape[0]
    if not (torch.equal(got[0][:n], want[0])
            and torch.equal(got[1][:n], want[1])):
        raise AssertionError(f"positional_leaf != plain for {kind}")
    err = float((got[0][:n] - want[0]).abs().max())
    bound_ms, bound_by = leaf_bound(*args)
    m = {"ms": cuda_ms(lambda: cs.positional_leaf(*args), reps),
         "plain_ms": plain_ms, "plain_rows": n,
         "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
         "max_abs_err": err, "decode_share": leaf_decode_share(*args)}
    if old is not None:
        prev = old.positional_leaf(*args)
        if not (torch.equal(prev[0], got[0]) and torch.equal(prev[1], got[1])):
            raise AssertionError("positional_leaf != the previous leaf")
        m["ab"] = ab_turns(lambda: cs.positional_leaf(*args),
                           lambda: old.positional_leaf(*args), reps)
    return m


def measure_bundle(args, kw, reps, rows=None):
    """K3 vs its plain version on every output, in any launch form: kw
    holds the walk's ck / update_thr / emit_match, and may hold `step`
    (the stepped walk of `bundle_walk_steps`, one launch per chunk) and
    `thr_init` (the seeded walk). With `rows` (whole batch tiles of
    BUNDLE_BT), the plain walk computes (and is timed on) only the first
    rows, at the kernel's sub-chunking for the full batch; a batch
    tile's outputs depend on its own rows only. Also counts the K3
    launches of one walk."""
    import torch
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    text, num, clauses, cl_inputs, msm, boost, live, can, ub = args
    kw = dict(kw)
    step, thr = kw.pop("step", None), kw.pop("thr_init", None)
    kw = {k: kw[k] for k in ("ck", "update_thr", "emit_match")}
    B, n_tiles = can.shape

    def run(walk, a, thr_init, **extra):
        return cs.bundle_walk_steps(walk, *a, step=step, thr_init=thr_init,
                                    **kw, **extra)

    before = cs.LAUNCHES["bundle_topk"]
    got = run(cs.bundle_walk, args, thr)
    torch.cuda.synchronize()
    launches = cs.LAUNCHES["bundle_topk"] - before
    if rows is not None and rows % cs.BUNDLE_BT:
        raise ValueError(f"rows {rows} cut a batch tile")
    sub = (text, num, clauses,
           tuple(_first_rows(inp, rows) for inp in cl_inputs),
           *_first_rows((msm, boost), rows), live,
           *_first_rows((can, ub), rows))
    n = sub[4].shape[0]
    nt = n_tiles if step is None else step[0]
    chunk = cs.bundle_chunk_tiles(B, nt, cs.bundle_positional(clauses))
    design = k3_design(text, clauses, cl_inputs, B, nt,
                       live.shape[0] // n_tiles, chunk)
    want, plain_ms = plain_run(lambda: run(
        cs.bundle_walk_ref, sub, None if thr is None else thr[:n],
        chunk_tiles=chunk))
    err = 0.0
    for name, g, w in zip(("cs", "ci", "cnt", "flags", "match", "thr",
                           "timed"), got, want):
        same = (g is None and w is None) if (g is None or w is None) \
            else (g == w if name == "timed" else torch.equal(g[:n], w))
        if not same:
            raise AssertionError(f"bundle_topk != plain on {name} at B "
                                 f"{msm.shape[0]}, kw {kw}, step "
                                 f"{step is not None}, seeded "
                                 f"{thr is not None}")
    if got[0] is not None:
        fin = torch.isfinite(want[0])
        if bool(fin.any()):
            err = float((got[0][:n][fin] - want[0][fin]).abs().max())
    bound_ms, bound_by = bundle_bound(args, kw)
    return {"hits": int(got[2].sum()), "launches_per_walk": launches,
            "design": design,
            "thresholded_tiles": float(cs.normalize_prune(got[3])[1]),
            "prune": [float(x) for x in cs.normalize_prune(got[3])],
            "ms": cuda_ms(lambda: run(cs.bundle_walk, args, thr), reps),
            "plain_ms": plain_ms, "plain_rows": n,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err}


@functools.lru_cache(maxsize=None)
def _k3_occupancy(tile: int, pw: int, chunk: int, n_pos: int, n_wide: int):
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    return cs.bundle_occupancy(tile, pw, chunk, n_pos, n_wide)


def k3_design(text_cols, clauses, cl_inputs, B: int, nt: int, tile: int,
              chunk: int) -> dict:
    """A K3 launch over nt tiles as its entry sizes it: sub-chunk tiles,
    work items (batch tiles x sub-chunks, one CTA each), candidate
    buffers, wide clauses' term tables, dynamic shared memory and the
    CTAs an SM holds."""
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    pp, offsets = cs._pos_param_rows(clauses, cl_inputs, B)
    pw = 0 if pp is None else pp.shape[1]
    n_pos = sum(o is not None for o in offsets)
    n_wide = cs.bundle_wide_tables(text_cols, clauses, cl_inputs)
    smem, per_sm = _k3_occupancy(tile, pw, chunk, n_pos, n_wide)
    return {"chunk_tiles": chunk,
            "items": -(-B // cs.BUNDLE_BT) * -(-nt // chunk),
            "cand_buffers": 1 if n_pos else 2, "wide_tables": n_wide,
            "smem": smem, "ctas_per_sm": per_sm}


def k3_ptxas() -> dict:
    """ptxas' report of K3's walk from the verbose build, per build of
    bundle_topk_kernel (dense: no positional clause; positional; each
    "+ wide" with step 7's tables): registers, stack frame and spill
    bytes."""
    import re
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    lines = cs.BUILD_LOG.get("bundle_topk", "").splitlines()
    out = {}
    for i, ln in enumerate(lines):
        m = re.search(r"bundle_topk_kernelILb([01])ELb([01])E", ln)
        if "Function properties for" not in ln or m is None:
            continue
        name = ("positional" if m.group(1) == "1" else "dense") \
            + (" + wide" if m.group(2) == "1" else "")
        rep = out.setdefault(name, {})
        rep.update({k.replace(" ", "_"): int(v) for v, k in re.findall(
            r"(\d+) bytes (stack frame|spill stores|spill loads)",
            " ".join(lines[i + 1:i + 2]))})
        m = re.search(r"Used (\d+) registers", " ".join(lines[i + 2:i + 3]))
        if m:
            rep["registers"] = int(m.group(1))
    return out


def load_parent_k3(path: str):
    """The previous K3 (its cuda_scoring.py and csrc/) from a copy of an
    earlier commit's elasticsearch_tpu_torch/ops under `path`, loaded
    beside this one as its own module (own sources, build directory and
    counts; the shared scoring and topk modules are this checkout's) and
    built with ptxas' report."""
    import importlib.util
    src = os.path.join(path, "elasticsearch_tpu_torch", "ops",
                       "cuda_scoring.py")
    spec = importlib.util.spec_from_file_location(
        "elasticsearch_tpu_torch.ops._parent_cuda_scoring", src)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build(verbose=True)
    for line in mod.BUILD_LOG.get("bundle_topk", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas parent bundle_topk: {line.strip()}")
    return mod


def _walk_kw(kw):
    kw = dict(kw)
    step, thr = kw.pop("step", None), kw.pop("thr_init", None)
    return step, thr, {k: kw[k] for k in ("ck", "update_thr",
                                          "emit_match")}


def k3_ab(args, kw, old, reps: int = 10, same_counts: bool = True,
          new=None) -> dict:
    """The previous K3 (`old`, its own schedule) against this one (or
    `new`'s, another loaded copy of the ops) on one walk in any launch
    form, timed in turns (new, old, old, new) on the same inputs: both
    count every tile's matches alike (the counts, the mask and the
    thresholded tiles are reported; candidates of thresholded tiles
    depend on each one's schedule). With same_counts False (a probe that
    reads other data) the hits of each are reported instead."""
    import torch
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    step, thr, kw = _walk_kw(kw)
    new = cs if new is None else new

    def run(mod):
        return mod.bundle_walk_steps(mod.bundle_walk, *args, step=step,
                                     thr_init=thr, **kw)

    got, want = run(new), run(old)
    if same_counts and (not torch.equal(got[2], want[2]) or (
            got[4] is not None and not torch.equal(got[4], want[4]))):
        raise AssertionError("K3 and the previous K3 count differently")
    return {**ab_turns(lambda: run(new), lambda: run(old), reps),
            "hits": {"new": int(got[2].sum()), "previous": int(want[2].sum())},
            "thresholded_tiles": {
                "new": float(cs.normalize_prune(got[3])[1]),
                "previous": float(cs.normalize_prune(want[3])[1])}}


class SweepInputs:
    """Synthetic K3 inputs at B rows over cap docs: two text fields of 8
    slots (Zipf ids, 30% padding, a P 4 positions pack) and a numeric
    column, drawn like the main path's, with per-row clause inputs drawn
    on demand (`dense`, `rng_in`, `positional`)."""

    def __init__(self, dev, rng, B: int, cap: int):
        import torch
        from elasticsearch_tpu_torch import corpus
        from elasticsearch_tpu_torch.index.segment import (build_tile_max,
                                                           build_tile_minmax)
        self.rng, self.B, self.cap, self.L, self.per = rng, B, cap, 8, 500
        L, per = self.L, self.per
        self.text, self.tids_np = {}, {}
        for f in ("f", "g"):
            base = (per * rng.random((cap, L)) ** 3).astype(np.int32)
            tids = base * L + np.arange(L, dtype=np.int32)[None, :]
            tids[rng.random((cap, L)) < 0.3] = -1
            imps = rng.random((cap, L), dtype=np.float32) * 4 + 0.1
            imps[tids < 0] = 0.0
            pos, k1ln, lnorm = corpus.synthetic_positions(rng, tids, 4)
            self.tids_np[f] = tids
            self.text[f] = {"fwd_tids": torch.from_numpy(tids).to(dev),
                            "fwd_imps": torch.from_numpy(imps).to(dev),
                            "tile_max": torch.from_numpy(build_tile_max(
                                tids, imps, per * L, cap)).to(dev),
                            "fwd_pos": torch.from_numpy(pos).to(dev),
                            "k1ln": torch.from_numpy(k1ln).to(dev),
                            "lnorm": torch.from_numpy(lnorm).to(dev)}
        vals = rng.integers(100, 100_001, size=cap).astype(np.int32)
        exists = np.ones(cap, bool)
        lo_t, hi_t = build_tile_minmax(vals, exists, cap)
        self.num = {"n": {k: torch.from_numpy(v).to(dev) for k, v in (
            ("values", vals), ("exists", exists), ("tile_lo", lo_t),
            ("tile_hi", hi_t))}}
        self.live = torch.ones(cap, dtype=torch.bool, device=dev)
        self.dev = dev

    def t(self, a):
        import torch
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

    def dense(self, q, wrapped=False):
        rng, B, L, per, t = self.rng, self.B, self.L, self.per, self.t
        qt = ((per * rng.random((B, q)) ** 3).astype(np.int32) * L
              + rng.integers(0, L, size=(B, q)).astype(np.int32))
        wq = rng.random((B, q), dtype=np.float32) * 3 + 0.1
        return (t(qt), t(wq), t(np.ones(B, np.int32)),
                t(np.full(B, 1.5 if wrapped else 1.0, np.float32)))

    def rng_in(self):
        lo = self.rng.integers(100, 60_000, size=self.B).astype(np.int32)
        return (self.t(lo), self.t((lo + 40_000).astype(np.int32)))

    def positional(self, kind, field):
        """Terms that co-occur: each row's terms are slots of one doc."""
        from elasticsearch_tpu_torch.ops.scoring import parse_positional_kind
        rng, B, L, cap, t = self.rng, self.B, self.L, self.cap, self.t
        head, n, _v = parse_positional_kind(kind)
        tail = (t(np.ones(B, np.float32)), t(np.ones(B, np.int32)),
                t(np.ones(B, np.float32)))
        if head == "bm25f":
            nt = int(kind.split(":")[2])
            qt = np.stack([self.tids_np[f][rng.integers(0, cap, size=B), :nt]
                           for f in field], axis=1)
            return (t(qt.astype(np.int32)),
                    t(rng.random((B, nt), dtype=np.float32) * 4 + 0.5),
                    t(np.ones((B, len(field)), np.float32))) + tail
        docs = self.tids_np[field][rng.integers(0, cap, size=B)]
        cols = np.stack([rng.permutation(L)[:n] for _ in range(B)])
        qt = np.take_along_axis(docs, cols, axis=1).astype(np.int32)
        return (t(qt), t(np.ones((B, n), np.float32)),
                t(rng.random(B, dtype=np.float32) * 6 + 1),
                t(rng.integers(0, 3, size=B).astype(np.int32))) + tail


def bundle_sweep(dev, rng, B: int = 256, cap: int = 1 << 20, old=None
                 ) -> tuple[list[dict], float, SweepInputs]:
    """K3 at B 256, cap 2^20 (two text fields of 8 slots and a numeric
    column drawn like the main path's), one to three clauses; each row
    carries the launch's design (sub-chunk tiles, items, CTAs per SM,
    shared memory) and ptxas' registers and spills, and, with the
    previous K3 (`old`, chip_smoke --ab-parent), its time in turns with
    this one.
    Returns the rows, the worst error and the inputs (for the launch
    forms)."""
    from elasticsearch_tpu_torch.ops.scoring import bundle_tile_bounds
    sw = SweepInputs(dev, rng, B, cap)
    text, num, live, t = sw.text, sw.num, sw.live, sw.t
    dense, rng_in, positional = sw.dense, sw.rng_in, sw.positional

    configs = [
        ("1 clause", (("should", "terms_dense", "f", False),), 10, False),
        ("1 clause", (("should", "terms_dense", "f", False),), 100, False),
        ("1 clause", (("should", "terms_dense", "f", False),), 0, True),
        ("2 clauses, range", (("must", "terms_dense", "f", True),
                              ("filter", "range_int", "n", False)), 10, True),
        ("2 clauses, range", (("must", "terms_dense", "f", True),
                              ("filter", "range_int", "n", False)), 10,
         False),
        ("2 clauses, range", (("must", "terms_dense", "f", True),
                              ("filter", "range_int", "n", False)), 0, True),
        ("2 clauses", (("should", "terms_dense", "f", False),
                       ("should", "terms_dense", "g", False)), 10, False),
        ("3 clauses, range", (("must", "terms_dense", "f", True),
                              ("filter", "range_int", "n", False),
                              ("should", "terms_dense", "g", False)), 100,
         True),
        ("3 clauses", (("must", "terms_dense", "f", False),
                       ("must_not", "terms_dense", "g", False),
                       ("should", "terms_dense", "g", False)), 10, False),
    ]
    pos_kinds = [("phrase exact n 2", "phrase_pos:2:e", "f"),
                 ("phrase exact n 3", "phrase_pos:3:e", "f"),
                 ("phrase sloppy n 2", "phrase_pos:2:s", "f"),
                 ("phrase sloppy n 3", "phrase_pos:3:s", "f"),
                 ("span ordered n 3", "span_pos:3:o", "f"),
                 ("span unordered n 3", "span_pos:3:u", "f"),
                 ("bm25f f+g, 3 terms", "bm25f:2:3", ("f", "g"))]
    configs += [(label, (("should", kind, f, False),), 10, False)
                for label, kind, f in pos_kinds]
    configs.append(("phrase sloppy n 3 + filter range", (
        ("must", "phrase_pos:3:s", "f", False),
        ("filter", "range_int", "n", False)), 10, True))
    rows, worst = [], 0.0
    ptxas = k3_ptxas()
    for label, clauses, k, emit in configs:
        cl = tuple(rng_in() if kd == "range_int"
                   else positional(kd, f) if ":" in kd else dense(3, w)
                   for _r, kd, f, w in clauses)
        n_should = sum(r == "should" for r, *_ in clauses)
        msm = t(np.full(B, 1 if n_should and not any(
            r == "must" for r, *_ in clauses) else 0, np.int32))
        boost = t(np.ones(B, np.float32))
        can, ub = bundle_tile_bounds(clauses, cl, text, num, msm, boost)
        ck = min(k, 1024)
        args = (text, num, clauses, cl, msm, boost, live, can, ub)
        kw = {"ck": ck, "update_thr": True, "emit_match": emit}
        m = measure_bundle(args, kw, reps=10, rows=(
            PLAIN_ROWS if any(":" in kd for _r, kd, _f, _w in clauses)
            else None))
        worst = max(worst, m["max_abs_err"])
        if old is not None:
            m["ab"] = k3_ab(args, kw, old)
        rows.append({"kernel": "bundle_topk", "bundle": label, "B": B,
                     "cap": cap, "k": k, "emit_match": emit,
                     "can_match_share": float(can.float().mean()),
                     "ptxas": ptxas, **m})
        log("kernel_sweep " + json.dumps(rows[-1]))
    for label, kind, f in (pos_kinds[1], pos_kinds[3], pos_kinds[4],
                           pos_kinds[6]):
        inp = positional(kind, f)
        m = measure_leaf((kind, f, inp, text), reps=5, rows=PLAIN_ROWS,
                         old=old)
        worst = max(worst, m["max_abs_err"])
        rows.append({"kernel": "positional_leaf", "clause": label, "B": B,
                     "cap": cap, **m})
        log("kernel_sweep " + json.dumps(rows[-1]))
    return rows, worst, sw


def _never_late(_c, st):
    """A step check that never reports late (an infinite deadline): the
    stepped walk's chunks go back to back."""
    return False, st


_never_late.sync = False


def form_sweep(dev, rng, base: SweepInputs, k: int = 10, old=None
               ) -> tuple[list[dict], float]:
    """K3's launch forms at B 256 over the sweep's 2^20-doc columns, on a
    `match` bundle (one dense clause) and a `phrase_pos:2:e` one, k 10,
    the match mask on:
      * stepped: FORM_CHUNKS launches, the threshold carried, equal to
        the single launch (top-k, totals, mask) and, on every output, to
        the plain stepped walk (the first 16 rows for the phrase), timed
        back to back and with the resident loop's per-chunk poll (a far
        deadline: the host waits on each chunk before the next);
      * seeded: a 2^17-doc delta (columns of its own) opened at the base
        walk's k-th best, equal to its plain version on every output,
        and the chained top-k (init_topk / idx_offset) equal to the
        plain chain;
      * a stepped walk whose check flips at chunk 4 launches K3 4 times
        and reports timed.
    With the previous K3 (`old`), each form is also timed in turns
    against it."""
    import torch
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    from elasticsearch_tpu_torch.ops.scoring import bundle_tile_bounds
    from elasticsearch_tpu_torch.search import executor
    delta = SweepInputs(dev, rng, base.B, 1 << 17)
    B, cap = base.B, base.cap
    chunk = (cap // 1024) // FORM_CHUNKS
    rows, worst = [], 0.0
    for label, clauses in (
            ("match", (("should", "terms_dense", "f", False),)),
            ("phrase_pos:2:e", (("should", "phrase_pos:2:e", "f", False),))):
        pos = ":" in clauses[0][1]
        cl = (base.positional("phrase_pos:2:e", "f") if pos
              else base.dense(3),)
        msm = base.t(np.ones(B, np.int32))
        boost = base.t(np.ones(B, np.float32))
        args = (base.text, base.num, clauses, cl, msm, boost, base.live)
        rows_cut = PLAIN_ROWS if pos else None
        step = (chunk, None, _never_late)
        one = cs.fused_topk_bundle(*args, k, emit_match=True)
        st = cs.fused_topk_bundle(*args, k, emit_match=True, step=step)
        for i, name in ((0, "top_s"), (1, "top_i"), (2, "total"),
                        (4, "match")):
            if not torch.equal(st[i], one[i]):
                raise AssertionError(f"stepped K3 != single launch on "
                                     f"{name} ({label})")
        if st[5] is not False:
            raise AssertionError("a stepped walk with no deadline timed out")
        can, ub = bundle_tile_bounds(clauses, cl, *args[:2], msm, boost)
        kw = {"ck": k, "update_thr": True, "emit_match": True}
        single = measure_bundle(args + (can, ub), kw, reps=10,
                                rows=rows_cut)
        stepped = measure_bundle(args + (can, ub), {**kw, "step": step},
                                 reps=10, rows=rows_cut)
        if stepped["launches_per_walk"] != FORM_CHUNKS:
            raise AssertionError(f"stepped walk launched "
                                 f"{stepped['launches_per_walk']} times")
        poll = executor._resident_step(time.monotonic() + 3600, chunk)
        stepped["polled_ms"] = cuda_ms(lambda: cs.bundle_walk_steps(
            cs.bundle_walk, *args, can, ub, step=poll, **kw), 10)
        # seeded: the delta's rows are the base's queries
        d_args = (delta.text, delta.num, clauses, cl, msm, boost,
                  delta.live)
        d_can, d_ub = bundle_tile_bounds(clauses, cl, *d_args[:2], msm,
                                         boost)
        seeded = measure_bundle(d_args + (d_can, d_ub),
                                {**kw, "thr_init": one[0][:, -1]}, reps=10,
                                rows=rows_cut)
        chained = cs.fused_topk_bundle(*d_args, k, init_topk=one[:2],
                                       idx_offset=cap)
        plain = cs.fused_topk_bundle_ref(*d_args, k, init_topk=one[:2],
                                         idx_offset=cap)
        for i in range(3):
            if not torch.equal(chained[i], plain[i]):
                raise AssertionError(f"chained K3 != plain chain ({label})")
        # a check that flips at chunk 4
        before = cs.LAUNCHES["bundle_topk"]
        out = cs.bundle_walk_steps(cs.bundle_walk, *args, can, ub,
                                   step=(chunk, None,
                                         lambda c, s: (c >= 4, s)), **kw)
        torch.cuda.synchronize()
        flipped = cs.LAUNCHES["bundle_topk"] - before
        if flipped != 4 or out[6] is not True:
            raise AssertionError(f"a walk timed out at chunk 4 launched K3 "
                                 f"{flipped} times, timed {out[6]}")
        if old is not None:
            single["ab"] = k3_ab(args + (can, ub), kw, old)
            stepped["ab"] = k3_ab(args + (can, ub), {**kw, "step": step},
                                  old)
            seeded["ab"] = k3_ab(d_args + (d_can, d_ub),
                                 {**kw, "thr_init": one[0][:, -1]}, old)
        for form, m, c in (("single", single, cap),
                           ("stepped", stepped, cap),
                           ("seeded", seeded, delta.cap)):
            m["ptxas"] = k3_ptxas()
            worst = max(worst, m["max_abs_err"])
            rows.append({"kernel": f"bundle_topk {form}", "bundle": label,
                         "B": B, "cap": c, "k": k, "emit_match": True,
                         **({"chunks": FORM_CHUNKS} if form == "stepped"
                            else {}),
                         **m})
            log("kernel_forms " + json.dumps(rows[-1]))
        log("kernel_forms " + json.dumps({
            "bundle": label, "flip_at_chunk_4_launches": flipped,
            "timed": out[6]}))
    return rows, worst


def synthetic_postings(rng, B, n_blocks, cap):
    """Rows of doc-sorted 128-posting blocks: a quarter of each row's
    blocks repeat an earlier block (one doc, several terms), tails padded
    with out-of-range ids."""
    n_uniq = max(1, (3 * n_blocks) // 4)
    base = np.sort(rng.integers(0, cap, size=(B, n_uniq, 128)), axis=-1)
    base = base.astype(np.int32)
    fill = rng.integers(1, 129, size=(B, n_uniq))
    lane = np.arange(128)[None, None, :]
    base = np.where(lane < fill[..., None], base, cap).astype(np.int32)
    src = np.concatenate([np.arange(n_uniq),
                          rng.integers(0, n_uniq, size=n_blocks - n_uniq)])
    docs = base[:, src].reshape(B, n_blocks * 128)
    vals = rng.random((B, n_blocks * 128), dtype=np.float32)
    return docs, vals


def term_postings(rng, B, N, cap, n_terms=10):
    """Rows like a prefix query's postings: n_terms terms' doc-sorted
    lists one after another (document frequencies falling as 1/rank,
    N postings in all), so a 128-posting block spans few docs."""
    df = 1.0 / np.arange(1, n_terms + 1)
    df = np.maximum(1, (df / df.sum() * N).astype(np.int64))
    df[0] += N - df.sum()
    docs = np.concatenate([np.sort(rng.integers(0, cap, size=(B, int(f))),
                                   axis=1) for f in df], axis=1)
    vals = rng.random((B, N), dtype=np.float32)
    return docs.astype(np.int32), vals


def kernel_sweep(dev, rng, old=None) -> tuple[list[dict], float]:
    import torch
    rows, worst = [], 0.0
    B, cap = 256, 1 << 20
    # term ids drawn from 4,000 (few pairs share a term), then from 24
    # (most pairs do: K1 scores nearly every pair)
    for L, n_terms, Qs in ((8, 4000, (1, 3, 8)), (32, 4000, (1, 3, 8)),
                           (8, 24, (4,))):
        tids = rng.integers(-1, n_terms, size=(cap, L)).astype(np.int32)
        imps = (rng.random((cap, L), dtype=np.float32) * 5)
        imps[tids < 0] = 0
        t_tids = torch.from_numpy(tids).to(dev)
        t_imps = torch.from_numpy(imps).to(dev)
        for Q in Qs:
            qt = rng.integers(-1, n_terms, size=(B, Q)).astype(np.int32)
            qt[:, 0] = tids[rng.integers(0, cap, size=B), 0]
            wq = rng.random((B, Q), dtype=np.float32) * 3
            wq[qt < 0] = 0
            m = measure_dense((t_tids, t_imps, torch.from_numpy(qt).to(dev),
                               torch.from_numpy(wq).to(dev)), reps=8,
                              old=old)
            worst = max(worst, m["max_abs_err"])
            rows.append({"kernel": "dense_score", "B": B, "Q": Q, "cap": cap,
                         "L": L, "terms": n_terms, **m})
            log("kernel_sweep " + json.dumps(rows[-1]))
        del t_tids, t_imps
    # the last: the main path's prefix call, B 128 x N 262,144
    for rows_b, n_blocks in ((B, 8), (B, 64), (B, 512), (128, 2048)):
        docs, vals = synthetic_postings(rng, rows_b, n_blocks, cap)
        m = measure_scatter(torch.from_numpy(docs).to(dev),
                            torch.from_numpy(vals).to(dev), cap, reps=10,
                            old=old)
        worst = max(worst, m["max_abs_err"])
        rows.append({"kernel": "scatter_add", "B": rows_b,
                     "N": n_blocks * 128, "cap": cap, **m})
        log("kernel_sweep " + json.dumps(rows[-1]))
        del docs, vals
    # blocks of 128 random docs above span the capacity (rare terms); a
    # prefix query's blocks span few docs
    docs, vals = term_postings(rng, 128, 2048 * 128, cap)
    m = measure_scatter(torch.from_numpy(docs).to(dev),
                        torch.from_numpy(vals).to(dev), cap, reps=10, old=old)
    worst = max(worst, m["max_abs_err"])
    rows.append({"kernel": "scatter_add", "B": 128, "N": docs.shape[1],
                 "cap": cap, "terms": 10, **m})
    log("kernel_sweep " + json.dumps(rows[-1]))
    del docs, vals
    # unsorted rows with in-chunk repeats take the kernel's serial path
    docs = rng.integers(0, 70_000, size=(33, 1000)).astype(np.int32)
    docs[:, 10:30] = docs[:, 9:10]
    vals = rng.standard_normal((33, 1000)).astype(np.float32)
    m = measure_scatter(torch.from_numpy(docs).to(dev),
                        torch.from_numpy(vals).to(dev), 65_536, reps=3,
                        old=old)
    worst = max(worst, m["max_abs_err"])
    log("kernel_sweep " + json.dumps({"kernel": "scatter_add",
                                      "unsorted": True, **m}))
    rows += scan_sweep(dev, rng, B, cap, old=old)
    torch.cuda.empty_cache()
    b_rows, b_worst, inputs = bundle_sweep(dev, rng, old=old)
    f_rows, f_worst = form_sweep(dev, rng, inputs, old=old)
    del inputs
    torch.cuda.empty_cache()
    h_rows, h_worst = hybrid_sweep(dev, rng, old=old)
    return (rows + b_rows + f_rows + h_rows,
            max(worst, b_worst, f_worst, h_worst))


def capture_first_calls():
    """Shims that remember, per mix, the first (args, kwargs) each
    kernel's wrapper sees: seen[mix][kernel], and the scan's first by
    permutation kind, seen[mix]["ordered_prefix", kind]. Set
    current["mix"]."""
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    seen: dict[str, dict] = {}
    current = {"mix": None}
    orig = {k: getattr(cs, w) for k, w in WRAPPERS.items()}

    def shim(name):
        def call(*args, **kw):
            mine = seen.setdefault(current["mix"], {})
            mine.setdefault(name, (args, kw))
            if name == "ordered_prefix":
                mine.setdefault((name, perm_kind(args[1])), (args, kw))
            return orig[name](*args, **kw)
        return call

    return seen, current, {WRAPPERS[k]: shim(k) for k in orig}


def _merged_span(spans) -> float:
    """The length of the union of (start, end) intervals."""
    busy, cur = 0.0, None
    for a, b in sorted(spans):
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    return busy + (cur[1] - cur[0] if cur is not None else 0.0)


def profile_mixes(readers, mixes, out_dir: str | None, names=MIXES,
                  search=None, tag: str = "", host_ops: bool = True
                  ) -> dict:
    """One profiled batch per mix: wall time, device busy time (sum of the
    card's kernel and copy intervals, merged where they overlap) and the
    ops that took the most device and host time. Tables go to out_dir.
    `search(bodies)` serves a batch (default: search_merged over
    `readers`); `tag` prefixes the log lines and table files. Without
    `host_ops` the profiler records the card's activity alone and its raw
    device events are read without building the host-op tree: the top
    device ops are kernels, and a batch of a million host ops (the IVF
    probe's) costs seconds, not most of a minute. The profiler's own
    seconds (start, stop, event list, averages) are reported beside the
    batch."""
    import cProfile
    import collections
    import io
    import pstats
    import torch
    from torch.profiler import ProfilerActivity, profile
    if search is None:
        search = functools.partial(search_merged, readers)
    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for name in names:
        torch.cuda.synchronize()
        prof_py = cProfile.Profile()
        t_start = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA] + (
                [ProfilerActivity.CPU] if host_ops else [])) as prof:
            t0 = time.perf_counter()
            prof_py.enable()
            search(mixes[name])
            torch.cuda.synchronize()
            prof_py.disable()
            t1 = time.perf_counter()
            wall = (t1 - t0) * 1e3
        t_stop = time.perf_counter()
        ka = None
        if host_ops:
            spans = [(e.time_range.start, e.time_range.end)
                     for e in prof.events() if e.device_type == cuda]
            t_events = time.perf_counter()
            ka = prof.key_averages()
            top = sorted(((e.key, e.self_device_time_total) for e in ka),
                         key=lambda kv: -kv[1])[:6]
            atomics = sum(
                e.self_device_time_total for e in ka
                if "scatter_reduce" in e.key or "index_add" in e.key) / 1e3
        else:
            dev = [e for e in prof.profiler.kineto_results.events()
                   if e.device_type() == cuda]
            spans = [(e.start_ns() / 1e3,
                      (e.start_ns() + e.duration_ns()) / 1e3) for e in dev]
            t_events = time.perf_counter()
            by_kernel = collections.Counter()
            for e in dev:
                by_kernel[e.name()] += e.duration_ns() / 1e3
            top = by_kernel.most_common(6)
            atomics = None                   # no host ops recorded
        t_end = time.perf_counter()
        busy_us = _merged_span(spans)
        out[name] = {
            "wall_ms": wall, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": max(0.0, 1.0 - busy_us / 1e3 / wall),
            "top_device_ops_ms": {k[:60]: v / 1e3 for k, v in top},
            # the atomics the doc-space metrics took before the bucket
            # stats kernel
            "scatter_atomics_ms": atomics,
            "profiler_s": {"start": t0 - t_start, "stop": t_stop - t1,
                           "events": t_events - t_stop,
                           "averages": t_end - t_events}}
        log(f"{tag}profile " + json.dumps({"mix": name, **out[name]}))
        if out_dir:
            buf = io.StringIO()
            pstats.Stats(prof_py, stream=buf).sort_stats(
                "cumulative").print_stats(30)
            stem = f"profile_{tag.strip().replace(' ', '_')}{name}" \
                if tag else f"profile_{name}"
            with open(os.path.join(out_dir, f"{stem}.txt"),
                      "w") as f:
                f.write(ka.table(sort_by="self_cuda_time_total",
                                 row_limit=25) if ka is not None else
                        "".join(f"{v / 1e3:12.3f} ms  {k}\n" for k, v
                                in by_kernel.most_common(25)))
                f.write("\n\nhost (cProfile, cumulative)\n")
                f.write(buf.getvalue())
    return out


# -- path (t): vectors -----------------------------------------------------

VEC_DOCS = 1 << 19        # per shard: config 5's 2^20 x 256 over 2 shards
VEC_DELTA_DOCS = 1 << 15  # per shard, the streaming delta beside each base
VEC_DIMS = 256
VEC_MIXES = ("knn", "knn_exact", "hybrid", "knn_rescore")
# requests per msearch: the hybrid mix as one base + delta pack (its
# similarity columns, [B, cap] each, fit the transient budget at 128
# rows, not at 256)
VEC_BATCH = {"hybrid": 128}
# the hybrid mix sent as one msearch of all its requests
HYBRID_WHOLE = "hybrid_one_msearch"
VEC_REPS = 3
VEC_SMALL_DOCS = 4000     # per shard of the card-vs-CPU dyadic index
VEC_SMALL_DIMS = 16
VEC_NODE_DOCS = 3000
H100_BF16_OPS_PER_S = 989e12  # dense bf16 tensor cores, H100 SXM data sheet
VEC_K3_SOURCE = ("elasticsearch_tpu_torch/ops/csrc/bundle_topk.cu",
                 "elasticsearch_tpu/ops/pallas_scoring.py:337 (K3; its "
                 "knn clause is the XLA engine's, ops/scoring.py:872)")


def _build_passage_shard(job):
    """Worker: one shard of passages, the text through the port's
    builder, the embeddings attached as the builder's vector column
    (`vector_column`: the same values, exists flags and norms); with
    `ivf`, its IVF index built here on the host (`index/ann.ensure_ann`:
    the k-means and the assignment on the CPU), timed on the segment's
    `ivf_build_s`, the assignment's part on `ivf_assign_host_s`."""
    name, n_docs, start, seed, dims, dyadic, ivf = job
    t_job = time.perf_counter()
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.index.mapping import MapperService
    from elasticsearch_tpu_torch.index.segment import (SegmentBuilder,
                                                       vector_column)
    # about 512 docs a center at full size, at least 8 centers
    texts, emb, _c = corpus.passage_columns(
        n_docs, dims, seed=seed, dyadic=dyadic, center_seed=23,
        n_centers=min(1024, max(8, n_docs // 512)))
    svc = MapperService(mapping={"properties": {"passage": {"type": "text"}}})
    builder = SegmentBuilder()
    for i, text in enumerate(texts):
        builder.add(svc.parse(str(start + i), {"passage": text}))
    seg = builder.build(name)
    vals = np.zeros((seg.capacity, dims), np.float32)
    vals[:n_docs] = emb
    exists = np.zeros(seg.capacity, bool)
    exists[:n_docs] = True
    seg.vectors["embedding"] = vector_column("embedding", vals, exists)
    if ivf:
        from elasticsearch_tpu_torch.index import ann
        assign = ann._assign_full
        seg.ivf_assign_host_s = 0.0

        def timed_assign(*a, **kw):
            t = time.perf_counter()
            try:
                return assign(*a, **kw)
            finally:
                seg.ivf_assign_host_s += time.perf_counter() - t
        ann._assign_full = timed_assign      # this worker process only
        t0 = time.perf_counter()
        try:
            ann.ensure_ann(seg, "embedding", "cosine")
        finally:
            ann._assign_full = assign
        seg.ivf_build_s = time.perf_counter() - t0
    seg.worker_s = time.perf_counter() - t_job
    return seg


def _passage_jobs(n_docs: int, n_delta: int, dims: int, dyadic: bool,
                  ivf: bool = False):
    """Two shards of passages (seeds 23, 24; ids s * n_docs + i; with
    `ivf`, their IVF indexes built with them) and a delta of n_delta docs
    beside each (seeds 123, 124)."""
    return ([(f"vec{s}", n_docs, s * n_docs, 23 + s, dims, dyadic, ivf)
             for s in range(2)]
            + [(f"vec{s}d", n_delta, 2 * n_docs + s * n_delta, 123 + s,
                dims, dyadic, False) for s in range(2)])


# thread pools of the background workers and of the main process while
# they run: the passages' IVF k-means (a BLAS product) and host assignment
# (a torch product) on PASSAGE_THREADS threads a worker, the side builds
# on one, the main process's CPU torch ops on WINDOW_THREADS during the
# node ingest and from the passages' start to path (t), the small node
# worker's too. More threads than cores stall every parallel region of a
# process whose threads the scheduler parks (the small node's CPU half
# took four times as long with the passages' k-means on every core)
PASSAGE_THREADS = 2
WINDOW_THREADS = 2


@contextlib.contextmanager
def worker_threads(n: int):
    """Worker processes started inside run their BLAS and OpenMP thread
    pools on `n` threads (the environment they start with)."""
    keys = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    saved = {k: os.environ.get(k) for k in keys}
    os.environ.update({k: str(n) for k in keys})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def start_passage_build():
    """The full-size passages and the bases' IVF indexes built in 4
    worker processes in the background, at the lowest scheduling
    priority (nice 19): (pool, pending result, start time)."""
    ctx = multiprocessing.get_context("spawn")
    with worker_threads(PASSAGE_THREADS):
        pool = ctx.Pool(4, initializer=os.nice, initargs=(19,))
    return (pool, pool.map_async(_build_passage_shard,
                                 _passage_jobs(VEC_DOCS, VEC_DELTA_DOCS,
                                               VEC_DIMS, False, ivf=True)),
            time.perf_counter())


def _pair_deltas(segs) -> tuple[list, list]:
    """(bases, deltas), each delta keyed on its base and padded as the
    streaming write path pads it."""
    from elasticsearch_tpu_torch.index.segment import pad_delta_shapes
    bases, deltas = segs[:2], segs[2:]
    for b, d in zip(bases, deltas):
        d.delta_parent = b.cache_key()
        pad_delta_shapes(d)
    return bases, deltas


def build_passage_shards(n_docs: int, n_delta: int, dims: int,
                         dyadic: bool) -> tuple[list, list]:
    """`_passage_jobs`' segments, built here."""
    return _pair_deltas([_build_passage_shard(j) for j in
                         _passage_jobs(n_docs, n_delta, dims, dyadic)])


def make_vec_readers(bases, deltas, device, dims: int):
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.index.mapping import MapperService
    from elasticsearch_tpu_torch.search.shard_searcher import ShardReader
    svc = MapperService(mapping=corpus.passage_mapping(dims))
    return [ShardReader("passages", [b, d], {}, svc, shard_id=s,
                        device=device)
            for s, (b, d) in enumerate(zip(bases, deltas))]


def exact_scan_readers(bases, deltas, device, dims: int, probe_body):
    """Readers over copies of the segments (made before any search, so
    they hold no device columns; their IVF indexes left behind) whose IVF
    build is refused once (ES_TPU_ANN_MIN_DOCS above the segment size,
    sticky), so that they serve the exact scan."""
    def copy_of(seg):
        c = copy.copy(seg)
        c.ann = {}
        return c

    readers = make_vec_readers([copy_of(b) for b in bases],
                               [copy_of(d) for d in deltas], device, dims)
    prior = os.environ.get("ES_TPU_ANN_MIN_DOCS")
    os.environ["ES_TPU_ANN_MIN_DOCS"] = str(1 << 62)
    try:
        search_merged(readers, [probe_body])
    finally:
        if prior is None:
            del os.environ["ES_TPU_ANN_MIN_DOCS"]
        else:
            os.environ["ES_TPU_ANN_MIN_DOCS"] = prior
    return readers


def capture_vec_walk():
    """A shim of `bundle_walk_steps` remembering the first walk that
    carries a knn_vec clause: seen["walk"] = (args, kw)."""
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    seen: dict = {}
    orig = cs.bundle_walk_steps

    def shim(walk, *args, **kw):
        if any(kd == "knn_vec" for _r, kd, _f, _w in args[2]):
            seen.setdefault("walk", (args, kw))
        return orig(walk, *args, **kw)

    return seen, shim


def _zero_vec_counts() -> None:
    from elasticsearch_tpu_torch.ops import ann as ann_ops
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    for counts in (cs.LAUNCHES, cs.BUNDLE_FORMS, cs.BUNDLE_VEC_FORMS,
                   ann_ops.HOST_SYNCS):
        for k in counts:
            counts[k] = 0


def run_vector_path(readers, readers_x, mixes, reps, sync) -> tuple:
    """Each vector mix timed, with the launch, K3-form and host-sync
    counts zeroed just before the path and read per mix."""
    from elasticsearch_tpu_torch.ops import ann as ann_ops
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    from elasticsearch_tpu_torch.search import executor
    stats, last = {}, {}
    _zero_vec_counts()
    # the hybrid mix also as one msearch of all its requests, the route a
    # user's msearch of that size takes (B-chunked, per segment)
    for name, mix, batch in [*((m, m, VEC_BATCH.get(m)) for m in VEC_MIXES),
                             (HYBRID_WHOLE, "hybrid", None)]:
        before = {"launches": dict(cs.LAUNCHES),
                  "vec_forms": dict(cs.BUNDLE_VEC_FORMS),
                  "syncs": ann_ops.HOST_SYNCS["ivf_slot"]}
        executor._fused_stats.reset()
        rs = readers_x if name == "knn_exact" else readers
        st, last[name] = time_mix(rs, mixes[mix], reps, sync, batch=batch)
        stats[name] = {
            **st,
            "launches": {k: cs.LAUNCHES[k] - before["launches"][k]
                         for k in cs.LAUNCHES},
            "knn_vec_forms": {k: cs.BUNDLE_VEC_FORMS[k]
                              - before["vec_forms"][k]
                              for k in cs.BUNDLE_VEC_FORMS},
            "ivf_host_syncs_per_batch": (ann_ops.HOST_SYNCS["ivf_slot"]
                                         - before["syncs"]) / reps,
            "hits": sum(r["hits"]["total"] for r in last[name]),
            "fused": executor.fused_scoring_stats(),
        }
    return stats, last


def check_vector_path(stats, last, batch: int, on_card: bool) -> None:
    """Each mix served as its route says: the IVF probe (clusters
    probed), the exact scan, the fused engine (K3 with a knn_vec clause
    on the card); every request answered with its 10 hits."""
    knn = stats["knn"]["fused"]
    if knn["admission"]["knn"].get("ivf", 0) <= 0 \
            or knn["ann"]["clusters_probed"] <= 0:
        raise AssertionError(f"knn: the IVF probe never served: {knn}")
    ex = stats["knn_exact"]["fused"]["admission"]["knn"]
    if set(ex) != {"exact"}:
        raise AssertionError(f"knn_exact: served by {ex}")
    for name in ("hybrid", HYBRID_WHOLE):
        hy = stats[name]
        if on_card and sum(hy["knn_vec_forms"].values()) <= 0:
            raise AssertionError(f"{name}: K3 never launched with a "
                                 "knn_vec clause")
        if hy["fused"]["admission"]["knn"].get("query_rewrite", 0) <= 0:
            raise AssertionError(f"{name}: {hy['fused']['admission']}")
    if _strip(last[HYBRID_WHOLE]) != _strip(last["hybrid"]):
        raise AssertionError("hybrid: one msearch and msearches of "
                             f"{VEC_BATCH['hybrid']} answer differently")
    for name in (*VEC_MIXES, HYBRID_WHOLE):
        if len(last[name]) != batch or any(
                len(r["hits"]["hits"]) != 10 for r in last[name]):
            raise AssertionError(f"{name}: a response without 10 hits")


def score_recall(got, want) -> float:
    """recall@10 by score (ids are arbitrary among equal scores): a hit
    counts when it reaches the reference list's 10th score."""
    hits = total = 0
    for g, w in zip(got, want):
        floor = w["hits"]["hits"][-1]["_score"]
        hits += sum(h["_score"] >= floor - 1e-6 for h in g["hits"]["hits"])
        total += len(w["hits"]["hits"])
    return hits / total


def oracle_recall(bases, deltas, queries, resps, dev) -> float:
    """recall@10 of the exact scan's responses against the float64 top-10
    of the similarity it computes: the dot of the bf16-rounded operands
    it multiplies (each normalised query, every segment's vectors) over
    the stored vectors' f32 norms (the reference's definition)."""
    import torch
    from elasticsearch_tpu_torch.ops import knn
    q = torch.from_numpy(queries).to(dev)
    q = (q / knn.query_norm(q).clamp_min(1e-12)).to(torch.bfloat16).to(
        torch.float64)
    best_s, best_id = [], []
    for seg in [*bases, *deltas]:
        vc = seg.vectors["embedding"]
        n = seg.num_docs
        v = torch.from_numpy(vc.values[:n]).to(dev).to(
            torch.bfloat16).to(torch.float64)
        norms = torch.from_numpy(vc.norms[:n]).to(dev, torch.float64)
        s = (q @ v.t()) / norms.clamp_min(1e-12)[None, :]
        top = torch.topk(s, 10, dim=1)
        best_s.append(top.values)
        best_id.append(torch.tensor([[int(seg.ids[j]) for j in row]
                                     for row in top.indices.tolist()],
                                    device=dev))
    s, ids = torch.cat(best_s, 1), torch.cat(best_id, 1)
    order = torch.topk(s, 10, dim=1).indices
    want = ids.gather(1, order).tolist()
    hits = sum(len({int(h["_id"]) for h in r["hits"]["hits"]} & set(w))
               for r, w in zip(resps, want))
    return hits / (10 * len(resps))


def column_bound(B: int, cap: int, dims: int):
    """Least time of the similarity column: its bf16 vectors, f32 norms,
    exists flags and queries read once and the [B, cap] f32 column
    written, over the HBM rate; 2 B cap D operations over the dense bf16
    rate."""
    nbytes = cap * (dims * 2 + 4 + 1) + B * (dims * 4 + cap * 4)
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = 2 * B * cap * dims / H100_BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def measure_column(readers, queries, dev, B: int = 128) -> dict:
    """The similarity column of the hybrid walks (ops/knn, a cuBLAS bf16
    product with f32 accumulation plus the transform's elementwise
    passes) on a base segment, and the product alone, beside the bound."""
    import torch
    from elasticsearch_tpu_torch.ops import knn
    from elasticsearch_tpu_torch.search.executor import device_arrays
    seg = readers[0].segments[0]
    v = device_arrays(seg, dev)["vec"]["embedding"]
    q = torch.from_numpy(queries[:B]).to(dev)
    cap, dims = v["values"].shape
    bound_ms, bound_by = column_bound(B, cap, dims)
    qb = q.to(torch.bfloat16)
    return {"B": B, "cap": cap, "dims": dims,
            "ms": cuda_ms(lambda: knn.knn_score_column(
                v["values"], v["norms"], v["exists"], q,
                similarity="cosine"), 10),
            "product_ms": cuda_ms(lambda: knn.bf16_dots(q, v["values"]), 10),
            # yardstick: the same product rounded to bf16
            "library_ms": cuda_ms(lambda: torch.matmul(qb, v["values"].t()),
                                  10),
            "bound_ms": bound_ms, "bound_by": bound_by}


def measure_vec_forms(seen, old=None) -> dict:
    """K3 with the hybrid path's knn_vec walk, held against its plain
    version in its three launch forms: single, stepped (8 launches, the
    threshold carried) and seeded (opened at the single walk's final
    threshold). The single form also reports the same walk at ck 0
    (`ck0_ms`: the count alone, no selection). With the previous
    commit's ops (`old`), each form is timed in turns with its K3."""
    import torch
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    args, kw = seen["walk"]
    base = {k: kw[k] for k in ("ck", "update_thr", "emit_match")}
    n_tiles = args[7].shape[1]
    thr = cs.bundle_walk(*args, **base)[5]
    torch.cuda.synchronize()
    forms = {"single": (base, 10),
             "stepped": ({**base, "step": (-(-n_tiles // FORM_CHUNKS), None,
                                           _never_late)}, 5),
             "seeded": ({**base, "thr_init": thr}, 10)}
    out = {}
    for form, (fkw, reps) in forms.items():
        out[form] = measure_bundle(args, fkw, reps=reps)
        if old is not None:
            out[form]["ab"] = k3_ab(args, fkw, old)
    out["single"]["ck0_ms"] = cuda_ms(lambda: cs.bundle_walk(
        *args, ck=0, update_thr=False, emit_match=base["emit_match"]), 10)
    out["single"]["signature_shares"] = signature_shares(args)
    return out


def signature_shares(args) -> list:
    """What K1's term signatures (`dense_candidates_ref`) would leave
    K3's dense clauses on wide fields to do in this walk: per clause, the
    share of (row, doc) pairs whose signatures meet, of (item, doc) pairs
    where some row of the item's BUNDLE_BT does (the doc's forward row
    must be read), and of (item, 32-doc chunk) pairs where some pair
    does (the warp walks the chunk)."""
    import torch
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    from elasticsearch_tpu_torch.ops.scoring import DENSE_CLAUSE_KINDS
    text, clauses, cl_inputs = args[0], args[2], args[3]
    out = []
    for (_r, kd, f, _w), inp in zip(clauses, cl_inputs):
        if kd not in DENSE_CLAUSE_KINDS or \
                text[f]["fwd_tids"].shape[1] <= cs.BUNDLE_SLOTS:
            continue
        tids, imps = text[f]["fwd_tids"], text[f]["fwd_imps"]
        hit = cs.dense_candidates_ref(tids, imps, inp[0], inp[1])
        B, cap = hit.shape
        pad = -B % cs.BUNDLE_BT
        item = torch.cat([hit, hit.new_zeros((pad, cap))]).view(
            -1, cs.BUNDLE_BT, cap).any(1)
        chunk = item[:, :cap - cap % 32].reshape(item.shape[0], -1, 32)
        out.append({"field": f, "L": tids.shape[1],
                    "pair": float(hit.float().mean()),
                    "item_doc": float(item.float().mean()),
                    "item_chunk": float(chunk.any(2).float().mean())})
    return out


def hybrid_walk(dev, rng, B: int = 128, cap: int = VEC_DOCS) -> tuple:
    """A stand-in for path (t)'s hybrid walk, made in seconds: B rows of
    should[`match` on a passage field, knn_vec] over cap docs, k 10.
    Each doc holds 20-60 tokens drawn from corpus.vocab() by
    corpus.zipf_weights, its distinct terms ascending in 64 slots (-1
    past them) with BM25 impacts (k1 1.2, b 0.75); each row 1-3 distinct
    head terms (the vocabulary's first eighth, Zipf) padded to 4, idf
    weights; the similarity column N(0, 0.06) but for 512 docs a row
    near the query (0.85-0.99), every doc with a vector. Returns the
    walk's (args, kw) as `capture_vec_walk` records them."""
    import torch
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.ops.scoring import (bundle_tile_bounds,
                                                     slack_bound)
    n_terms, L, most = len(corpus.vocab()), 64, 60
    lens = rng.integers(20, most + 1, size=cap)
    toks = rng.choice(n_terms, size=(cap, most),
                      p=corpus.zipf_weights(n_terms)).astype(np.int32)
    toks[np.arange(most)[None, :] >= lens[:, None]] = n_terms
    toks.sort(axis=1)
    first = np.ones_like(toks, dtype=bool)
    first[:, 1:] = toks[:, 1:] != toks[:, :-1]
    col = np.broadcast_to(np.arange(most), toks.shape)
    nxt = np.where(first, col, most)
    nxt = np.minimum.accumulate(nxt[:, ::-1], axis=1)[:, ::-1]
    nxt = np.concatenate([nxt[:, 1:], np.full((cap, 1), most)], axis=1)
    tf = (np.minimum(nxt, lens[:, None]) - col).astype(np.float32)
    keep = first & (toks < n_terms)
    order = np.argsort(~keep, axis=1, kind="stable")
    kept = np.take_along_axis(keep, order, axis=1)
    tids = np.full((cap, L), -1, np.int32)
    tids[:, :most] = np.where(kept, np.take_along_axis(toks, order, axis=1),
                              -1)
    tf = np.where(kept, np.take_along_axis(tf, order, axis=1), 0.0)
    norm = np.float32(1.2) * (np.float32(0.25) + np.float32(0.75) * (
        lens / lens.mean()).astype(np.float32))[:, None]
    imps = np.zeros((cap, L), np.float32)
    imps[:, :most] = np.where(kept, tf * np.float32(2.2) / (tf + norm), 0.0)
    df = np.bincount(tids[tids >= 0], minlength=n_terms)
    n_head = max(n_terms // 8, 30)
    qt = np.full((B, 4), -1, np.int32)
    for b in range(B):
        n = int(rng.integers(1, 4))
        qt[b, :n] = rng.choice(n_head, size=n, replace=False,
                               p=corpus.zipf_weights(n_head))
    idf = np.log1p((cap - df + 0.5) / (df + 0.5)).astype(np.float32)
    wq = np.where(qt >= 0, idf[np.maximum(qt, 0)], 0.0).astype(np.float32)
    sim = (rng.standard_normal((B, cap)) * 0.06).astype(np.float32)
    for b in range(B):
        sim[b, rng.choice(cap, size=512, replace=False)] = rng.uniform(
            0.85, 0.99, size=512).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    # build_tile_max's per-(term, tile) max, on the card
    tile = 1024
    t_tids, t_imps = t(tids), t(imps)
    ok = t_tids >= 0
    at = (t_tids.to(torch.int64) * (cap // tile)
          + (torch.arange(cap, device=dev) // tile)[:, None])[ok]
    tile_max = torch.zeros(n_terms * (cap // tile), device=dev)
    tile_max.scatter_reduce_(0, at, t_imps[ok], reduce="amax")
    text = {"passage": {"fwd_tids": t_tids, "fwd_imps": t_imps,
                        "tile_max": tile_max.reshape(n_terms, -1)}}
    exists = torch.ones(cap, dtype=torch.bool, device=dev)
    col_t = t(sim)
    ub = slack_bound(col_t.reshape(B, cap // tile, tile).amax(dim=2))
    clauses = (("should", "terms_dense", "passage", False),
               ("should", "knn_vec", "embedding", False))
    cl = ((t(qt), t(wq), t(np.ones(B, np.int32)),
           t(np.ones(B, np.float32))), (col_t, exists, ub))
    msm = t(np.ones(B, np.int32))
    boost = t(np.ones(B, np.float32))
    can, bound = bundle_tile_bounds(clauses, cl, text, {}, msm, boost)
    args = (text, {}, clauses, cl, msm, boost, exists, can, bound)
    return args, {"ck": 10, "update_thr": True, "emit_match": False}


def hybrid_sweep(dev, rng, old=None) -> tuple[list[dict], float]:
    """K3's three launch forms on `hybrid_walk`'s synthetic hybrid walk
    (B 128 over 2^19 docs, a passage field of 64 slots), each held
    against its plain version, with the previous K3 in turns where
    `old` is given."""
    args, kw = hybrid_walk(dev, rng)
    forms = measure_vec_forms({"walk": (args, kw)}, old=old)
    rows, worst = [], 0.0
    for form, m in forms.items():
        worst = max(worst, m["max_abs_err"])
        rows.append({"kernel": f"bundle_topk {form}",
                     "bundle": "hybrid (synthetic): match L 64 + knn_vec",
                     "B": args[4].shape[0], "cap": args[6].shape[0],
                     "k": kw["ck"], "ptxas": k3_ptxas(), **m})
        log("kernel_forms " + json.dumps(rows[-1]))
    return rows, worst


def small_vector_check(n_docs: int, dev, sync) -> dict:
    """A small dyadic passages index (every dot product exact) searched
    on the card and on the CPU: the four mixes give the same responses
    exactly. Both probe one IVF index (built on the CPU) over every
    cluster, so the probe's answer is the exact top-k on both."""
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.index import ann
    D = VEC_SMALL_DIMS
    bases, deltas = build_passage_shards(n_docs, n_docs // 8, D, True)
    cpu_b = [copy.copy(b) for b in bases]
    cpu_d = [copy.copy(d) for d in deltas]
    q = corpus.passage_queries(32, D, dyadic=True, seed=5)
    mixes = corpus.knn_mixes(q, 32)
    sides = [(bases, deltas, dev), (cpu_b, cpu_d, "cpu")]
    exact = [exact_scan_readers(bs, ds, device, D, mixes["knn"][0])
             for bs, ds, device in sides]
    tok = ann.configure(min_docs=256, nprobe=1 << 20)
    try:
        for b, cb in zip(bases, cpu_b):
            ann.ensure_ann(cb, "embedding", "cosine")
            b.ann = dict(cb.ann)
        out = []
        for (bs, ds, device), rx in zip(sides, exact):
            rs = make_vec_readers(bs, ds, device, D)
            out.append({name: _strip(search_merged(
                rx if name == "knn_exact" else rs,
                mixes["knn" if name == "knn_exact" else name]))
                for name in VEC_MIXES})
        sync()
    finally:
        ann.reset(if_current=tok)
    sides = out
    for name in VEC_MIXES:
        assert_close_responses(sides[0][name], sides[1][name], rtol=0.0)
    return {"docs_per_shard": n_docs, "requests_per_mix": 32,
            "ivf_clusters": bases[0].ann["embedding"].n_clusters}


def vector_node_check(n_docs: int, dev) -> dict:
    """A small node with path.data takes dyadic vector docs through
    _bulk (2 shards, two refreshes), searches (each segment builds its
    IVF index), flushes, closes and boots; the responses before and
    after are equal, and the IVF indexes came back from the store."""
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.node import Node
    D = VEC_SMALL_DIMS
    data = data_dir("vec_node")
    settings = node_settings(data, **{"index.ann.min_docs": 256})
    q = corpus.passage_queries(16, D, dyadic=True, seed=7)
    mixes = corpus.knn_mixes(q, 16)
    bodies = [b for name in ("knn", "hybrid", "knn_rescore")
              for b in mixes[name]]
    docs = corpus.make_passages(n_docs, D, seed=9, dyadic=True,
                                missing_every=40)
    node = Node(settings, device=dev)
    node.create_index("vec", {"number_of_shards": 2},
                      corpus.passage_mapping(D))
    half = n_docs // 2
    for part in (docs[:half], docs[half:]):
        node.bulk([("index", {"_index": "vec", "_id": did, "doc": d})
                   for did, d in part])
        node.refresh("vec")
    before = node.msearch([("vec", b) for b in bodies])["responses"]
    node.flush("vec")
    node.close()
    node = Node(settings, device=dev)
    try:
        segs = [s for e in node.indices["vec"].shards.values()
                for s in e.acquire_searcher().segments]
        after = node.msearch([("vec", b) for b in bodies])["responses"]
    finally:
        node.close()
        shutil.rmtree(data, ignore_errors=True)
    assert_close_responses(_node_strip(after), _node_strip(before), rtol=0.0)
    if not any("embedding" in s.ann for s in segs):
        raise AssertionError("vector node: no IVF index came back")
    if not all(len(r["hits"]["hits"]) == 10 for r in before):
        raise AssertionError("vector node: a response without 10 hits")
    return {"docs": n_docs, "requests": len(bodies),
            "segments": len(segs),
            "ivf_segments": sum("embedding" in s.ann for s in segs)}


def card_assignment(bases, dev) -> dict:
    """The IVF build's assignment (index/ann._assign_full, the step a
    node's build runs on its card) at the bases' full size, on the
    centroids the build workers' host k-means found: seconds a base
    beside the workers' host build and host assignment, and the rows the
    card assigns to another cluster than the host did (near-ties within
    the f32 rounding of the product)."""
    from elasticsearch_tpu_torch.index import ann
    out = []
    for b in bases:
        ai, vc = b.ann["embedding"], b.vectors["embedding"]
        ords = np.nonzero(vc.exists)[0]
        host = np.full(b.capacity, -1, np.int64)
        keep = ai.members >= 0
        host[ai.members[keep]] = np.nonzero(keep)[0]
        x = ann._working_space(vc.values[ords], "cosine")
        t0 = time.perf_counter()
        assign, _radii = ann._assign_full(x, ai.centroids, dev)
        card_s = time.perf_counter() - t0
        out.append({"docs": int(ords.size), "clusters": ai.n_clusters,
                    "host_build_s": b.ivf_build_s,
                    "host_assign_s": b.ivf_assign_host_s,
                    "card_assign_s": card_s,
                    "rows_assigned_otherwise": int(
                        (assign != host[ords]).sum())})
    return {"bases": out}


def vector_small_checks(args, dev, sync, on_card=True,
                        n: int = VEC_DOCS) -> dict:
    """Path (t)'s small dyadic index (the card against the CPU) and its
    small node, which need no passages."""
    out = {"small": small_vector_check(
        min(args.small_docs, VEC_SMALL_DOCS) if on_card else n, dev, sync)}
    log("vector small index: " + json.dumps(out["small"]))
    out["node"] = vector_node_check(VEC_NODE_DOCS if on_card else n, dev)
    log("vector node: " + json.dumps(out["node"]))
    return out


def vector_phase(args, dev, sync, out_dir=None, on_card=True,
                 build=None, n: int = VEC_DOCS, nd: int = VEC_DELTA_DOCS,
                 D: int = VEC_DIMS, small=None, old=None) -> tuple:
    """Path (t): dense vectors, hybrid bundles and rescore over 2 shards
    of n passages (D dims) with a delta of nd each. `build` is
    `start_passage_build`'s handle (None: build here); `small` is
    `vector_small_checks`' result where they ran before (None: they run
    first here, while the passages build); `old` the previous commit's
    ops (--ab-parent), whose K3 the knn_vec forms are timed against. Returns (the report, the
    kernels line's knn_vec entry or None off the card)."""
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.index import ann
    t_phase = time.perf_counter()
    laps = {}
    mark = time.perf_counter()

    def lap(name):
        nonlocal mark
        now = time.perf_counter()
        laps[name] = now - mark
        mark = now
    report = dict(small or vector_small_checks(args, dev, sync, on_card, n))
    lap("small_checks")
    if build is None:
        t0 = time.perf_counter()
        bases, deltas = build_passage_shards(n, nd, D, False)
        build_s = time.perf_counter() - t0
    else:
        pool, pending, t0 = build
        segs = pending.get()
        build_s = time.perf_counter() - t0
        pool.close()
        pool.join()
        bases, deltas = _pair_deltas(segs)
    lap("build_wait")
    queries = corpus.passage_queries(
        args.batch, D, seed=29, near=bases[0].vectors["embedding"].values[:n])
    mixes = corpus.knn_mixes(queries, args.batch)
    mixes["knn_exact"] = copy.deepcopy(mixes["knn"])
    readers_x = exact_scan_readers(bases, deltas, dev, D, mixes["knn"][0])
    readers = make_vec_readers(bases, deltas, dev, D)
    # the IVF build (in the build workers where they built it), timed
    # apart from the first batch, and its upload
    t0 = time.perf_counter()
    for b in bases:
        if ann.ensure_ann_device(b, "embedding", "cosine", dev) is None:
            raise AssertionError("vectors: no IVF index was built")
    sync()
    ivf_s = [getattr(b, "ivf_build_s", None) for b in bases]
    if None in ivf_s:
        ivf_s = time.perf_counter() - t0
    lap("ivf_build")
    ai = bases[0].ann["embedding"]
    setup = {"docs_per_shard": n, "delta_docs_per_shard": nd, "dims": D,
             "build_s": build_s,
             "worker_s": [getattr(b, "worker_s", None) for b in bases],
             "ivf_build_s": ivf_s,
             "clusters": ai.n_clusters, "cluster_cap": ai.cluster_cap,
             "nprobe": ann.default_nprobe(ai.n_clusters),
             "text_L": bases[0].text["passage"].fwd_tids.shape[1]}
    if on_card:
        setup["ivf_assignment"] = card_assignment(bases, dev)
        lap("card_assignment")
    log("vectors setup: " + json.dumps(setup))
    seen, shim = capture_vec_walk()
    with swapped_kernels(bundle_walk_steps=shim):
        for name in VEC_MIXES:                    # warm-up: uploads
            time_mix(readers_x if name == "knn_exact" else readers,
                     mixes[name], 1, sync, batch=VEC_BATCH.get(name))
        time_mix(readers, mixes["hybrid"], 1, sync)
    sync()
    lap("warm_up")
    stats, last = run_vector_path(readers, readers_x, mixes,
                                  VEC_REPS if on_card else 1, sync)
    lap("timed_mixes")
    for name in stats:
        log("vector mix " + json.dumps({"mix": name, **stats[name]}))
    check_vector_path(stats, last, len(mixes["knn"]), on_card)
    recall = {"ivf_vs_exact": score_recall(last["knn"], last["knn_exact"]),
              "exact_vs_f64_oracle": oracle_recall(
                  bases, deltas, queries, last["knn_exact"], dev)}
    log("vector recall@10: " + json.dumps(recall))
    if recall["ivf_vs_exact"] < ann.DEFAULT_RECALL:
        raise AssertionError(f"IVF recall@10 {recall['ivf_vs_exact']}")
    if recall["exact_vs_f64_oracle"] < 0.99:
        raise AssertionError(f"exact recall@10 {recall}")
    n_swap = min(64, len(mixes["hybrid"]))
    with swapped_kernels(**plain_versions()):
        plain = search_merged(readers, mixes["hybrid"][:n_swap])
    if _strip(plain) != _strip(last["hybrid"][:n_swap]):
        raise AssertionError("hybrid: responses with the plain versions "
                             "swapped in differ")
    log(f"vector plain swap: {n_swap} hybrid responses identical")
    lap("checks")
    report.update({"setup": setup, "mixes": stats, "recall": recall,
                   "laps": laps})
    entry = None
    if on_card:
        report["profiles"] = {}
        for name in VEC_MIXES:
            rs = readers_x if name == "knn_exact" else readers
            step = VEC_BATCH.get(name) or len(mixes[name])
            report["profiles"].update(profile_mixes(
                None, mixes, out_dir, (name,),
                lambda bodies, rs=rs, step=step: [
                    r for i in range(0, len(bodies), step)
                    for r in search_merged(rs, bodies[i:i + step])],
                "vector ", host_ops=False))
        lap("profiles")
        report["column"] = measure_column(readers, queries, dev)
        log("similarity column: " + json.dumps(
            {**report["column"], "gpu": gpu_line()}))
        forms = measure_vec_forms(seen, old=old)
        report["knn_vec_forms"] = forms
        args_w, kw_w = seen["walk"]
        call = {"mix": "hybrid", "B": args_w[4].shape[0], "ck": kw_w["ck"],
                "cap": args_w[6].shape[0],
                "clauses": [[r, kd] for r, kd, _f, _w in args_w[2]]}
        for form, m in forms.items():
            log(f"knn_vec {form}: " + json.dumps({**call, **m}))
        path_forms = {f: sum(stats[h]["knn_vec_forms"][f]
                             for h in ("hybrid", HYBRID_WHOLE))
                      for f in forms}
        m = forms["single"]
        entry = {"name": "bundle_topk_knn_vec", "route": "cuda",
                 "source": VEC_K3_SOURCE[0], "replaces": VEC_K3_SOURCE[1],
                 "launches": sum(path_forms.values()),
                 "max_abs_err": max(f["max_abs_err"] for f in forms.values()),
                 "ms": m["ms"], "plain_ms": m["plain_ms"],
                 "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                 "library_ms": None, "call": call,
                 "forms": {f: {k: v[k] for k in ("ms", "plain_ms",
                                                 "bound_ms",
                                                 "launches_per_walk")}
                           for f, v in forms.items()},
                 "path_forms": path_forms}
        lap("column_and_forms")
    report["seconds"] = time.perf_counter() - t_phase
    report["gpu"] = gpu_line() if on_card else "cpu"
    return report, entry


# -- path (u): the query DSL ------------------------------------------------

# path (u) budgets 60 s of the run: a warm-up batch a mix, then ONE timed
# batch a mix, each recorded in a profiler session of its own (the card's
# activity alone) for its device busy time
# requests per msearch of a mix: bucket_aggs' requests spawn 10
# auxiliary requests each (one a bucket), sent back through msearch
DSL_BATCH = {"bucket_aggs": 64}
DSL_SWAP = 32             # requests a mix with the plain versions swapped in
DSL_SMALL = 16            # requests a mix on the card-vs-CPU small index
DSL_NODE_DOCS = 3000      # per shard of the HTTP node
DSL_NODE_MIXES = ("query_string", "function_score", "bucket_aggs")
DSL_NODE_REQUESTS = 8
DSL_Q = ("message:images AND message:french", "message:news OR message:sport",
         "message:torch NOT message:images", "venues")
# mixes whose plans the fused engine admits (K3), and the kernels path
# (u) must launch on the card
DSL_FUSED = ("query_string", "more_like_this")
DSL_KERNELS = ("bundle_topk", "dense_score", "scatter_add", "ordered_prefix")


def dsl_search(readers, name):
    """search_merged over `readers`, DSL_BATCH requests at a time."""
    step = DSL_BATCH.get(name)

    def run(bodies):
        n = step or len(bodies)
        return [r for i in range(0, len(bodies), n)
                for r in search_merged(readers, bodies[i:i + n])]
    return run


def _device_spans(prof) -> list[tuple]:
    """The (start, end) microseconds of the card's kernels and copies in
    a profiler session."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def run_dsl_path(readers, mixes, sync, on_card: bool) -> tuple:
    """One timed batch of each mix (after the warm-up), with the launch
    counts zeroed just before the path and read per mix and after it. On
    the card each batch runs inside a profiler session of its own that
    records the card's activity alone: its device busy time is the union
    of the session's kernel and copy intervals (a session a batch: one
    session for all the batches lost events once its buffer filled)."""
    import torch
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    from elasticsearch_tpu_torch.search import executor
    stats, last = {}, {}
    _zero_counts()
    for name in mixes:
        sync()
        before = dict(cs.LAUNCHES)
        executor._fused_stats.reset()
        ctx = contextlib.nullcontext()
        if on_card:
            from torch.profiler import ProfilerActivity, profile
            ctx = profile(activities=[ProfilerActivity.CUDA])
        with ctx as prof:
            st, last[name] = time_mix(readers, mixes[name], 1, sync,
                                      batch=DSL_BATCH.get(name))
        stats[name] = {
            **st, "batch": DSL_BATCH.get(name) or len(mixes[name]),
            "launches": {k: cs.LAUNCHES[k] - before[k]
                         for k in cs.LAUNCHES},
            "hits": sum(r["hits"]["total"] for r in last[name]),
            "fused": executor.fused_scoring_stats()}
        if on_card:
            busy = _merged_span(_device_spans(prof)) / 1e3
            stats[name]["device_busy_ms"] = busy
            stats[name]["device_idle_share"] = max(
                0.0, 1.0 - busy / stats[name]["p50_ms"])
    launches = _read_counts()
    if on_card:
        torch.cuda.synchronize()
    return stats, last, launches


def check_dsl_path(stats, last, on_card: bool) -> None:
    """Admission as each mix's plans say: K3 for query_string and
    more_like_this, function_score rejected as `clause:fnscore`; every
    response well formed, and hits in every mix."""
    for name in DSL_FUSED:
        adm = stats[name]["fused"]["admission"]
        if adm["admitted"] <= 0 or (on_card and stats[name]["launches"][
                "bundle_topk"] <= 0):
            raise AssertionError(f"{name}: not on K3: {adm}")
    adm = stats["function_score"]["fused"]["admission"]
    if adm["admitted"] or adm["rejected"].get("clause:fnscore", 0) <= 0:
        raise AssertionError(f"function_score: admission {adm}")
    for name, resps in last.items():
        if sum(r["hits"]["total"] for r in resps) <= 0:
            raise AssertionError(f"{name}: no hits in the mix")
        for r in resps:
            if not all(np.isfinite(h["_score"]) for h in r["hits"]["hits"]
                       if h["_score"] is not None):
                raise AssertionError(f"{name}: a score is not finite")
    for r in last["bucket_aggs"]:
        a = r["aggregations"]
        if sorted(a) != ["all", "by_status", "days", "no_body", "sizes"] \
                or len(a["sizes"]["buckets"]) != 3 \
                or a["all"]["doc_count"] < r["hits"]["total"]:
            raise AssertionError("bucket_aggs: " + json.dumps(a)[:300])
    for r in last["top_hits_sig"]:
        a = r["aggregations"]
        if len(a["top"]["hits"]["hits"]) != min(3, r["hits"]["total"]) \
                or a["sig"]["doc_count"] != r["hits"]["total"]:
            raise AssertionError("top_hits_sig: " + json.dumps(a)[:300])


def dsl_small_check(on_gpu, on_cpu, n_ids: int) -> dict:
    """Every DSL mix on a small index: the card gives the CPU's responses
    exactly (function_score included: XLA's exp / log are computed op by
    op on both, ops/xla_math)."""
    from elasticsearch_tpu_torch import corpus
    mixes = corpus.dsl_mixes(DSL_SMALL, seed=13, n_ids=n_ids)
    hits = {}
    for name, bodies in mixes.items():
        got = _strip(dsl_search(on_gpu, name)(bodies))
        want = _strip(dsl_search(on_cpu, name)(bodies))
        if json.dumps(got, sort_keys=True) != json.dumps(want,
                                                         sort_keys=True):
            raise AssertionError(f"dsl small index, {name}: the card != "
                                 "the CPU")
        hits[name] = sum(r["hits"]["total"] for r in want)
    return {"requests_per_mix": DSL_SMALL, "hits": hits}


def dsl_node_check(n_docs: int, dev) -> dict:
    """A 2-shard node on `dev` behind a loopback RestServer: mixes
    DSL_NODE_MIXES over HTTP POST /_msearch and `GET
    /logs/_search?q=...` (the URI query_string) answer as the engines'
    readers do (took aside)."""
    import urllib.parse
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.rest.server import RestServer
    node = Node({"node.name": "dsl-node"}, device=dev)
    server = RestServer(node, "127.0.0.1", 0).start()
    url = f"http://127.0.0.1:{server.port}"
    try:
        node.create_index("logs", {"number_of_shards": 2}, corpus.MAPPING)
        keys = routing_keys(2)
        for s in range(2):
            r = node.bulk(_bulk_ops(corpus.make_docs(
                n_docs, seed=52 + s, start=s * n_docs, long_every=300),
                keys[s]))
            if r["errors"]:
                raise AssertionError("dsl node: bulk failed")
        node.refresh("logs")
        readers = node_readers(node)
        mixes = corpus.dsl_mixes(DSL_NODE_REQUESTS, seed=17,
                                 n_ids=2 * n_docs)
        out = {}
        for name in DSL_NODE_MIXES:
            bodies = mixes[name]
            lines = [x for b in bodies for x in ({"index": "logs"}, b)]
            over_http = http_call(url, "POST", "/_msearch",
                                  lines=lines)["responses"]
            if _node_strip(over_http) != _strip(
                    dsl_search(readers, name)(bodies)):
                raise AssertionError(f"dsl node, {name}: HTTP _msearch != "
                                     "the engines' readers")
            out[name] = sum(r["hits"]["total"] for r in over_http)
        for q in DSL_Q:
            got = http_call(url, "GET", "/logs/_search?q="
                            + urllib.parse.quote(q))
            want = search_merged(readers, [{"query": {"query_string": {
                "query": q}}}])[0]
            if {k: v for k, v in got.items() if k != "took"} \
                    != _strip([want])[0]:
                raise AssertionError(f"dsl node: GET _search?q={q} != the "
                                     "engines' readers")
            out[f"q={q}"] = got["hits"]["total"]
    finally:
        server.stop()
        node.close()
    return {"docs_per_shard": n_docs, "hits": out}


def dsl_phase(args, readers, on_gpu, on_cpu, dev, sync,
              on_card: bool = True) -> tuple:
    """Path (u): the query DSL's eight mixes on the main path's readers
    (args.batch requests each), then their checks: admission, the plain
    swap, the card against the CPU on the small index, a node over HTTP.
    Returns (the report, the path's launch counts)."""
    from elasticsearch_tpu_torch import corpus
    t_phase = time.perf_counter()
    laps = {}
    mark = time.perf_counter()

    def lap(name):
        nonlocal mark
        now = time.perf_counter()
        laps[name] = now - mark
        mark = now
    mixes = corpus.dsl_mixes(args.batch, n_ids=2 * args.docs)
    for name in corpus.DSL_MIXES:                # warm-up: uploads, layouts
        dsl_search(readers, name)(mixes[name])
    sync()
    lap("warm_up")
    stats, last, launches = run_dsl_path(readers, mixes, sync, on_card)
    lap("timed_mixes")
    if on_card:
        missing = [k for k in DSL_KERNELS if launches[k] <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on path (u): "
                                 f"{missing}")
    check_dsl_path(stats, last, on_card)
    with swapped_kernels(**plain_versions()):
        for name, bodies in mixes.items():
            if _strip(dsl_search(readers, name)(bodies[:DSL_SWAP])) \
                    != _strip(last[name][:DSL_SWAP]):
                raise AssertionError(f"dsl {name}: responses with the "
                                     "plain versions swapped in differ")
    lap("plain_swap")
    for name in corpus.DSL_MIXES:
        log("dsl mix " + json.dumps({
            "mix": name, "requests": stats[name]["requests"],
            "batch": stats[name]["batch"], "qps": stats[name]["qps"],
            "p50_ms": stats[name]["p50_ms"], "hits": stats[name]["hits"],
            "device_busy_ms": stats[name].get("device_busy_ms"),
            "device_idle_share": stats[name].get("device_idle_share"),
            "launches": {k: v for k, v in stats[name]["launches"].items()
                         if v},
            "admission": stats[name]["fused"]["admission"],
            "gpu": gpu_line() if on_card else "cpu"}))
    small = dsl_small_check(on_gpu, on_cpu, 2 * args.small_docs)
    log("dsl small index: " + json.dumps(small))
    lap("small_index")
    node = dsl_node_check(DSL_NODE_DOCS if on_card else 400, dev)
    log("dsl node: " + json.dumps(node))
    lap("node")
    report = {"mixes": stats, "small": small,
              "node": node, "launches": launches, "laps": laps,
              "seconds": time.perf_counter() - t_phase,
              "gpu": gpu_line() if on_card else "cpu"}
    log("dsl: " + json.dumps({k: report[k] for k in (
        "launches", "laps", "seconds", "gpu")}))
    return report, launches


# -- path (v): scripts and the device metric aggs --------------------------

# path (v) runs right after path (u) on the same bases: a warm-up of
# SCRIPT_WARMUP requests a mix (uploads: the script columns, the sorted
# layouts), then ONE timed batch of each mix in a profiler session, as
# path (u); its HTTP node (stored script, scripted update, restart) runs
# after the scroll, beside the kill -9 and small node workers
SCRIPT_WARMUP = 32
SCRIPT_SWAP = 32          # requests a mix with the plain versions swapped in
SCRIPT_SMALL = 16         # requests a mix on the card-vs-CPU small index
SCRIPT_HLL_ROWS = 8       # pctl_card requests whose HLL registers are held
SCRIPT_NODE_DOCS = 2000   # per shard of the HTTP node
# the kernels path (v) must launch on the card: K1 scores the matches of
# the unfused script plans, the bucket stats fold the HLL registers, the
# scan and the tree reduce the percentiles' sorted bins and the stats
SCRIPT_KERNELS = ("dense_score", "ordered_bucket_stats", "ordered_prefix",
                  "ordered_sum")


def check_script_path(stats, last) -> None:
    """Every script plan stays off K3 (script clauses are rejected as
    `clause:script_q`, function_score as `clause:fnscore`, sorts by
    `sort`), every mix has hits, and the aggregations are well formed."""
    adm = stats["script_filter"]["fused"]["admission"]
    if adm["admitted"] or adm["rejected"].get("clause:script_q", 0) <= 0:
        raise AssertionError(f"script_filter: admission {adm}")
    adm = stats["script_score"]["fused"]["admission"]
    if adm["admitted"] or adm["rejected"].get("clause:fnscore", 0) <= 0:
        raise AssertionError(f"script_score: admission {adm}")
    for name, resps in last.items():
        if sum(r["hits"]["total"] for r in resps) <= 0:
            raise AssertionError(f"{name}: no hits in the mix")
        for r in resps:
            if not all(np.isfinite(h["_score"]) for h in r["hits"]["hits"]
                       if h["_score"] is not None):
                raise AssertionError(f"{name}: a score is not finite")
    for r in last["script_sort"]:
        keys = [h["sort"][0] for h in r["hits"]["hits"]]
        if keys != sorted(keys, reverse=True):
            raise AssertionError(f"script_sort: keys out of order {keys}")
    for r in last["script_aggs"]:
        a = r["aggregations"]
        if a["kb"]["count"] != r["hits"]["total"] \
                or not np.isfinite(a["total_kb"]["value"]):
            raise AssertionError("script_aggs: " + json.dumps(a)[:300])
    for r in last["pctl_card"]:
        a = r["aggregations"]
        if r["hits"]["total"] and (a["status_n"]["value"] != 3
                                   or a["status_hll"]["value"] != 3
                                   or a["size_p"]["values"]["50.0"] is None):
            raise AssertionError("pctl_card: " + json.dumps(a)[:300])


def hll_registers(readers, bodies) -> list:
    """Each shard's HLL registers of the `status_hll` aggs of `bodies`."""
    import torch
    return [torch.from_numpy(np.asarray(
        r.get("_agg_partials", {})["status_hll"]["hll"]))
        for reader in readers
        for r in reader.msearch(copy.deepcopy(bodies), with_partials=True)]


def script_phase(args, readers, on_gpu, on_cpu, sync,
                 on_card: bool = True) -> tuple:
    """Path (v): the five script / device-agg mixes on the main path's
    readers (args.batch requests each), then their checks: admission, the
    plain swap (and the HLL registers `torch.equal` to the plain
    version's), the card against the CPU on the small index. Returns (the
    report, the path's launch counts)."""
    import torch
    from elasticsearch_tpu_torch import corpus
    t_phase = time.perf_counter()
    laps = {}
    mark = time.perf_counter()

    def lap(name):
        nonlocal mark
        now = time.perf_counter()
        laps[name] = now - mark
        mark = now
    mixes = corpus.script_mixes(args.batch)
    for name in corpus.SCRIPT_MIXES:           # warm-up: uploads, layouts
        search_merged(readers, mixes[name][:SCRIPT_WARMUP])
    sync()
    lap("warm_up")
    stats, last, launches = run_dsl_path(readers, mixes, sync, on_card)
    lap("timed_mixes")
    if on_card:
        missing = [k for k in SCRIPT_KERNELS if launches[k] <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on path (v): "
                                 f"{missing}")
    check_script_path(stats, last)
    hll_bodies = mixes["pctl_card"][:SCRIPT_HLL_ROWS]
    regs = hll_registers(readers, hll_bodies)
    with swapped_kernels(**plain_versions()):
        for name, bodies in mixes.items():
            if _strip(search_merged(readers, bodies[:SCRIPT_SWAP])) \
                    != _strip(last[name][:SCRIPT_SWAP]):
                raise AssertionError(f"script {name}: responses with the "
                                     "plain versions swapped in differ")
        plain_regs = hll_registers(readers, hll_bodies)
    if not all(torch.equal(a, b) for a, b in zip(regs, plain_regs)):
        raise AssertionError("HLL registers != the plain version's")
    lap("plain_swap")
    for name in corpus.SCRIPT_MIXES:
        log("script mix " + json.dumps({
            "mix": name, "requests": stats[name]["requests"],
            "batch": stats[name]["batch"], "qps": stats[name]["qps"],
            "p50_ms": stats[name]["p50_ms"], "hits": stats[name]["hits"],
            "device_busy_ms": stats[name].get("device_busy_ms"),
            "device_idle_share": stats[name].get("device_idle_share"),
            "launches": {k: v for k, v in stats[name]["launches"].items()
                         if v},
            "admission": stats[name]["fused"]["admission"],
            "gpu": gpu_line() if on_card else "cpu"}))
    small = script_small_check(on_gpu, on_cpu)
    log("script small index: " + json.dumps(small))
    lap("small_index")
    report = {"mixes": stats, "small": small, "launches": launches,
              "hll_rows": len(regs), "laps": laps,
              "seconds": time.perf_counter() - t_phase,
              "gpu": gpu_line() if on_card else "cpu"}
    log("script: " + json.dumps({k: report[k] for k in (
        "launches", "hll_rows", "laps", "seconds", "gpu")}))
    return report, launches


def script_small_check(on_gpu, on_cpu) -> dict:
    """Every script mix on a small index: the card gives the CPU's
    responses exactly (the script math is XLA's, computed op by op, or
    the library's functions taken in f64 and rounded once: the mixes use
    only the former, tanh among them)."""
    from elasticsearch_tpu_torch import corpus
    mixes = corpus.script_mixes(SCRIPT_SMALL, seed=19)
    hits = {}
    for name, bodies in mixes.items():
        got = _strip(search_merged(on_gpu, bodies))
        want = _strip(search_merged(on_cpu, bodies))
        if json.dumps(got, sort_keys=True) != json.dumps(want,
                                                         sort_keys=True):
            raise AssertionError(f"script small index, {name}: the card "
                                 "!= the CPU")
        hits[name] = sum(r["hits"]["total"] for r in want)
    return {"requests_per_mix": SCRIPT_SMALL, "hits": hits}


def script_node_check(n_docs: int, dev) -> dict:
    """A durable 2-shard node on `dev` behind a loopback RestServer: a
    stored script PUT over HTTP serves a search (equal to the engines'
    readers), an `_update` with a script changes the doc, and after a
    restart (the process's script registry emptied first) the stored
    script is back from scripts.json and the search answers as before."""
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.rest.server import RestServer
    from elasticsearch_tpu_torch.script import ScriptService
    t0 = time.perf_counter()
    data = data_dir("scripts")
    settings = node_settings(data, **{"node.name": "script-node"})
    body = {"query": {"bool": {
        "must": [{"match": {"message": "images"}}],
        "filter": [{"script": {"script": {
            "id": "size_kb", "params": {"d": 1024, "lo": 20}}}}]}},
        "size": 20, "sort": [{"_script": {"script": {
            "id": "size_kb", "params": {"d": 1024, "lo": 0}},
            "type": "number", "order": "desc"}}]}
    out = {}
    node = Node(settings, device=dev)
    server = RestServer(node, "127.0.0.1", 0).start()
    url = f"http://127.0.0.1:{server.port}"
    try:
        node.create_index("logs", {"number_of_shards": 2}, corpus.MAPPING)
        keys = routing_keys(2)
        for s in range(2):
            r = node.bulk(_bulk_ops(corpus.make_docs(
                n_docs, seed=72 + s, start=s * n_docs, long_every=300),
                keys[s]))
            if r["errors"]:
                raise AssertionError("script node: bulk failed")
        node.refresh("logs")
        http_call(url, "PUT", "/_scripts/size_kb", lines=[{"script": {
            "source": "doc['size'].value / params.d - params.lo"}}])
        got = http_call(url, "POST", "/logs/_search", lines=[body])
        want = search_merged(node_readers(node), [body])[0]
        if {k: v for k, v in got.items() if k != "took"} \
                != _strip([want])[0]:
            raise AssertionError("script node: the stored-script search "
                                 "over HTTP != the engines' readers")
        hit = got["hits"]["hits"][0]
        key = keys[int(hit["_id"]) // n_docs]
        doc = f"/logs/_doc/{hit['_id']}?routing={key}"
        before = http_call(url, "GET", doc)["_source"]["size"]
        http_call(url, "POST", f"/logs/_update/{hit['_id']}?refresh=true"
                  f"&routing={key}", lines=[{"script": {
                      "source": "ctx._source.size += params.n",
                      "params": {"n": 4096}}}])
        after = http_call(url, "GET", doc)["_source"]["size"]
        if after != before + 4096:
            raise AssertionError(f"script node: update {before} -> {after}")
        pre = http_call(url, "POST", "/logs/_search", lines=[body])
        out = {"hits": got["hits"]["total"], "updated": hit["_id"]}
    finally:
        server.stop()
        node.close()
    ScriptService.instance().stored.clear()
    ScriptService.instance().meta.clear()
    node = Node(settings, device=dev)
    server = RestServer(node, "127.0.0.1", 0).start()
    url = f"http://127.0.0.1:{server.port}"
    try:
        src = http_call(url, "GET", "/_scripts/size_kb")["script"]["source"]
        if src != "doc['size'].value / params.d - params.lo":
            raise AssertionError(f"script node: stored script {src!r}")
        post = http_call(url, "POST", "/logs/_search", lines=[body])

        def sorted_hits(r):
            # hits, keys and sources; the BM25 scores beside a script sort
            # follow the segments' statistics, which the restart's
            # translog replay lays out anew
            return r["hits"]["total"], [(h["_id"], h["sort"], h["_source"])
                                        for h in r["hits"]["hits"]]
        if sorted_hits(post) != sorted_hits(pre):
            raise AssertionError("script node: the search after the "
                                 "restart differs")
    finally:
        server.stop()
        node.close()
        shutil.rmtree(data, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    return out


# -- path (w): joins ----------------------------------------------------------

# the nested index: per shard JOIN_QUESTIONS StackOverflow questions with
# 0-8 answers each as nested objects (corpus.qa_nested_docs, Rally's
# `nested` track) and JOIN_HOT questions with thousands: about 2^20 rows
# a shard once the nested rows are counted, the longest chains of the
# to-parent fold over 4,096 rows
JOIN_QUESTIONS = 200_000
JOIN_HOT = ((0, 5000), (100_000, 4200), (150_000, 2600))
# the parent / child index (corpus.qa_join_docs, the ES 2.0 children
# agg's question / answer types): this many questions in all with their
# answers, each doc on the shard its routing gives (a question's own id,
# an answer's question), as a node's _bulk places them, but built with
# the SegmentBuilder in a worker (the node's _bulk with routing runs on
# the small nodes); the hot questions have a quarter of JOIN_HOT's
# answers. A size for a smoke check of the join paths, from no published
# source
JOIN_QA_QUESTIONS = 1 << 16
JOIN_WARMUP = 32          # requests a mix before the timed batch
JOIN_SWAP = 32            # requests a mix with the plain versions swapped in
JOIN_HTTP = 8             # requests a mix over HTTP _msearch (small node)
JOIN_SMALL_QUESTIONS = 150   # per shard of the small card / CPU nodes
JOIN_SMALL_REQUESTS = 6      # requests a mix on the small nodes
JOIN_SWEEP_B = 128        # rows of the to-parent fold's sweep row
# the kernels path (w) must launch on the card: the to-parent fold of the
# nested queries (and of reverse_nested's), K1 the body / title matches
JOIN_KERNELS = ("to_parent_fold", "dense_score")
JOIN_SOURCE = ("elasticsearch_tpu_torch/ops/csrc/block_join.cu",
               "elasticsearch_tpu/search/executor.py:1759 (.at[:, target]"
               ".add / .max / .min in XLA, not a TPU kernel)")


def _build_join_shard(job):
    """Worker: one shard of the nested index with the port's builder."""
    name, n, start, seed, hot = job
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.index.mapping import MapperService
    from elasticsearch_tpu_torch.index.segment import SegmentBuilder
    svc = MapperService(mapping=corpus.QA_NESTED_MAPPING)
    builder = SegmentBuilder()
    for did, doc in corpus.qa_nested_docs(n, seed=seed, start=start,
                                          hot=hot):
        builder.add(svc.parse(did, doc))
    return builder.build(name)


def _join_jobs(n: int, hot) -> list:
    return [(f"qa{s}", n, s * n, 51 + s, hot) for s in range(2)]


def _build_qa_join_shard(job):
    """Worker: the parent / child docs that the routing (DjbHash of a
    doc's routing value, `cluster/routing.shard_id`, as the node's _bulk
    routes them) places on shard `s`, with the port's builder."""
    s, n, hot = job
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.cluster.routing import shard_id
    from elasticsearch_tpu_torch.index.mapping import MapperService
    from elasticsearch_tpu_torch.index.segment import SegmentBuilder
    svc = MapperService(mapping=corpus.QA_JOIN_MAPPING)
    builder = SegmentBuilder()
    for did, doc, key in corpus.qa_join_docs(n, seed=52, hot=hot):
        if shard_id(did, 2, key) == s:
            builder.add(svc.parse(did, doc))
    return builder.build(f"qa_join{s}")


def _qa_join_jobs(n: int, hot) -> list:
    return [(s, n, tuple((i, k // 4) for i, k in hot)) for s in range(2)]


def fold_layout_stats(layout) -> dict:
    """The longest index list of a to-parent layout (its hottest parent's
    nested rows plus itself) and the parents with nested rows."""
    n = layout["starts"][1:] - layout["starts"][:-1]
    return {"hottest": int(n.max()), "parents_with_rows": int((n > 1).sum())}


def parent_fold_bound(score, ok, layout, mode):
    """Least time of to_parent_fold: the flags read once, the scores
    once where the mode has a value, the lists' starts once, the counts
    (and the mode's values) written once, over the memory's rate."""
    B, cap = ok.shape
    value = mode != "none"
    nbytes = B * cap * (1 + 4 + (8 if value else 0)) + cap * 4
    return nbytes / H100_BYTES_PER_S * 1e3, "bytes"


def measure_parent_fold(score, ok, layout, mode, reps, old=None):
    """The to-parent fold kernel vs its plain version, bit for bit (the
    count and the mode's value); library: index_add_ of the flags and of
    the masked scores and two scatter_reduce_ (amax, amin) on the same
    inputs (atomics: the same function, in no fixed order). With the
    previous commit's ops (`old`), its fold in turns with this one
    (outputs equal)."""
    import torch
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    got = cs.to_parent_fold(score, ok, layout, mode)
    want, plain_ms = plain_run(
        lambda: cs.to_parent_fold_ref(score, ok, layout, mode))
    for g, w in zip(got, want):
        if (g is None) != (w is None) or (g is not None
                                          and not _same_bits(g, w)):
            raise AssertionError(f"to_parent_fold ({mode}) != plain at "
                                 f"{tuple(ok.shape)}")
    B, cap = ok.shape
    tgt = layout["target"].to(torch.int64)
    idx = tgt[None, :].expand(B, -1)

    def library():
        cnt = torch.zeros((B, cap), device=ok.device)
        cnt.index_add_(1, tgt, ok.float())
        tot = torch.zeros((B, cap), device=ok.device)
        tot.index_add_(1, tgt, torch.where(ok, score, 0.0))
        out = [cnt, tot]
        for fill, how in ((-float("inf"), "amax"), (float("inf"), "amin")):
            o = torch.full((B, cap), fill, device=ok.device)
            out.append(o.scatter_reduce_(1, idx, torch.where(ok, score, fill),
                                         reduce=how, include_self=True))
        return out

    bound_ms, bound_by = parent_fold_bound(score, ok, layout, mode)
    ab = {}
    if old is not None:
        # the previous commit's fold on its own layout of the same target
        old_layout = old.block_join_layout(layout["target"])
        prev = old.to_parent_fold(score, ok, old_layout, mode)
        if not all((g is None and p is None) or _same_bits(g, p)
                   for g, p in zip(got, prev)):
            raise AssertionError(f"to_parent_fold ({mode}) != the previous "
                                 f"fold at {tuple(ok.shape)}")
        ab["ab"] = ab_turns(
            lambda: cs.to_parent_fold(score, ok, layout, mode),
            lambda: old.to_parent_fold(score, ok, old_layout, mode), reps)
    return {"mode": mode, "B": B, "cap": cap, **ab,
            "ms": cuda_ms(lambda: cs.to_parent_fold(score, ok, layout, mode),
                          reps),
            "plain_ms": plain_ms,
            "library_ms": cuda_ms(library, max(2, reps // 4)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "matched": int(ok.sum()), **fold_layout_stats(layout),
            "max_abs_err": max(float((g - w).abs().nan_to_num().max())
                               for g, w in zip(got, want) if g is not None)}


def capture_fold_calls():
    """A shim that remembers the first (score, ok, layout, mode) the
    to-parent fold's wrapper sees in each mode."""
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    seen: dict[str, tuple] = {}
    orig = cs.to_parent_fold

    def call(score, ok, layout, mode):
        if mode not in seen:
            seen[mode] = (score.clone(), ok.clone(), layout, mode)
        return orig(score, ok, layout, mode)
    return seen, call


def join_plain_versions() -> dict:
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    return {**plain_versions(), "to_parent_fold": cs.to_parent_fold_ref}


def check_join_path(stats, last) -> None:
    """Every nested plan stays off K3 (`clause:nested`), every mix has
    hits, scores are finite, and each response is the join's shape:
    has_child gives questions, has_parent and parent_id answers (parent_id
    its question's), the nested agg counts answers of the matching
    questions with reverse_nested back on at most those questions."""
    adm = stats["nested_match"]["fused"]["admission"]
    if adm["admitted"] or adm["rejected"].get("clause:nested", 0) <= 0:
        raise AssertionError(f"nested_match: admission {adm}")
    for name, resps in last.items():
        if sum(r["hits"]["total"] for r in resps) <= 0 and name not in (
                "nested_aggs", "children_agg"):
            raise AssertionError(f"{name}: no hits in the mix")
        for r in resps:
            if not all(np.isfinite(h["_score"]) for h in r["hits"]["hits"]
                       if h["_score"] is not None):
                raise AssertionError(f"{name}: a score is not finite")
    for r in last["has_child"]:
        if any(not h["_id"].startswith("q") for h in r["hits"]["hits"]):
            raise AssertionError("has_child: a hit is not a question")
    for name in ("has_parent", "parent_id"):
        for r in last[name]:
            if any(not h["_id"].startswith("a") for h in r["hits"]["hits"]):
                raise AssertionError(f"{name}: a hit is not an answer")
    aggs = [r["aggregations"]["answers"] for r in last["nested_aggs"]]
    if sum(a["doc_count"] for a in aggs) <= 0 or any(
            a["questions"]["doc_count"] > r["hits"]["total"]
            or (a["doc_count"] > 0) != (a["questions"]["doc_count"] > 0)
            for a, r in zip(aggs, last["nested_aggs"])):
        raise AssertionError("nested_aggs: " + json.dumps(aggs[0])[:300])
    if sum(r["aggregations"]["answers"]["doc_count"]
           for r in last["children_agg"]) <= 0:
        raise AssertionError("children_agg: no answers under any request")


def _join_small_docs(n: int, start: int) -> tuple:
    from elasticsearch_tpu_torch import corpus
    return (corpus.qa_nested_docs(n, seed=61, start=start,
                                  hot=((0, 60),)),
            corpus.qa_join_docs(n, seed=62, start=start, hot=((0, 30),)))


def join_small_check(dev, n_questions: int = JOIN_SMALL_QUESTIONS,
                     n_req: int = JOIN_SMALL_REQUESTS) -> dict:
    """A durable 2-shard node on the card behind a loopback RestServer and
    one on the CPU take the same writes: the nested index, and the parent
    / child index with each answer routed by its question's id (over
    HTTP _bulk on the card's node, through node.bulk on the CPU's); both
    give the same responses to every join mix exactly after the ingest, a
    parent of each index deleted, a force merge (the compaction) and a
    restart, and after the ingest JOIN_HTTP requests of each parent /
    child mix over HTTP _msearch equal the card node's engines' readers."""
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.node import Node
    from elasticsearch_tpu_torch.rest.server import RestServer
    mixes = {**corpus.qa_nested_mixes(n_req, seed=63),
             **corpus.qa_join_mixes(n_req, seed=64,
                                    n_questions=n_questions)}
    index_of = {**{m: "nested" for m in corpus.QA_NESTED_MIXES},
                **{m: "qa" for m in corpus.QA_JOIN_MIXES}}
    paths = {k: data_dir(f"join-small-{k}") for k in ("gpu", "cpu")}
    devs = {"gpu": dev, "cpu": "cpu"}

    def boot():
        return {k: Node(node_settings(paths[k], **{
            "node.name": f"join-{k}", "index.number_of_shards": 2}),
            device=devs[k]) for k in paths}
    nodes = boot()
    server = RestServer(nodes["gpu"], "127.0.0.1", 0).start()
    url = f"http://127.0.0.1:{server.port}"
    steps, http = {}, {}

    def compare(step):
        got = {}
        for k, n in nodes.items():
            got[k] = json.dumps({m: _node_strip(node_search(
                n, copy.deepcopy(b), index=index_of[m]))
                for m, b in mixes.items()}, sort_keys=True)
        if got["gpu"] != got["cpu"]:
            raise AssertionError(f"join small nodes, {step}: the card != "
                                 "the CPU")
        steps[step] = sum(r["hits"]["total"]
                          for resps in json.loads(got["cpu"]).values()
                          for r in resps)
    try:
        nested, joined = _join_small_docs(2 * n_questions, 0)
        for k, n in nodes.items():
            n.create_index("nested", {"number_of_shards": 2},
                           corpus.QA_NESTED_MAPPING)
            n.create_index("qa", {"number_of_shards": 2},
                           corpus.QA_JOIN_MAPPING)
            r = n.bulk([("index", {"_index": "nested", "_id": d, "doc": s})
                        for d, s in nested])
            if k == "gpu":
                lines = []
                for did, d, key in joined:
                    lines += [{"index": {"_index": "qa", "_id": did,
                                         "routing": key}}, d]
                rq = http_call(url, "POST", "/_bulk", lines=lines)
            else:
                rq = n.bulk([("index", {"_index": "qa", "_id": d,
                                        "_routing": key, "doc": s})
                             for d, s, key in joined])
            if r["errors"] or rq["errors"]:
                raise AssertionError("join small nodes: bulk failed")
            n.refresh(None)
        compare("ingest")
        readers = node_readers(nodes["gpu"], "qa")
        for name in corpus.QA_JOIN_MIXES:
            bodies = mixes[name][:JOIN_HTTP]
            lines = [x for b in bodies for x in ({"index": "qa"}, b)]
            over_http = http_call(url, "POST", "/_msearch",
                                  lines=lines)["responses"]
            if _node_strip(over_http) != _strip(search_merged(readers,
                                                              bodies)):
                raise AssertionError(f"join small node, {name}: HTTP "
                                     "_msearch != the engines' readers")
            http[name] = sum(r["hits"]["total"] for r in over_http)
        del readers
        for n in nodes.values():
            # the hot parents: their nested rows and children go with them
            n.delete_doc("nested", "0")
            n.delete_doc("qa", "q0", routing="q0")
            n.refresh(None)
        compare("parent deleted")
        for n in nodes.values():
            n.force_merge(None)
        compare("force merge")
        server.stop()
        for n in nodes.values():
            n.flush(None)
            n.close()
        nodes = boot()
        compare("restart")
    finally:
        server.stop()
        for n in nodes.values():
            n.close()
        for p in paths.values():
            shutil.rmtree(p, ignore_errors=True)
    return {"questions_per_shard": n_questions, "requests_per_mix": n_req,
            "hits": steps, "http_msearch_hits": http}


def join_phase(args, dev, sync, side: dict, waits: dict,
               on_card: bool = True) -> tuple:
    """Path (w) on the shards `side` built: the parent / child mixes on the
    `qa` shards, then the nested mixes on the nested shards, args.batch
    requests a mix (a warm-up of JOIN_WARMUP, `nested_match` whole: the
    fold's calls it captures are the timed batch's; then one timed batch
    each in a profiler session of its own, the counts zeroed just before
    each part); then the checks: launches, admission, the responses'
    shape, the plain swap, and the small durable nodes (HTTP _bulk and
    _msearch, the card equal to the CPU through a parent's delete, a
    force merge and a restart). Returns (the report, the path's launch
    counts, `join_kernels`' inputs: the fold's captured calls and a
    nested shard)."""
    from elasticsearch_tpu_torch import corpus
    t_phase = time.perf_counter()
    laps = {}
    mark = time.perf_counter()

    def lap(name):
        nonlocal mark
        now = time.perf_counter()
        laps[name] = now - mark
        mark = now
    qa_segs = side_result(side, "qa", waits)
    segs = side_result(side, "nested", waits)
    setup = {"built_s": time.perf_counter() - side["start"],
             "nested_rows": [s.num_docs for s in segs],
             "nested_capacity": [s.capacity for s in segs],
             "qa_docs": [s.num_docs for s in qa_segs]}
    readers_j = make_readers(qa_segs, dev, corpus.QA_JOIN_MAPPING, "qa")
    readers_n = make_readers(segs, dev, corpus.QA_NESTED_MAPPING, "nested")
    lap("build_wait")
    join_mixes = corpus.qa_join_mixes(args.batch,
                                      n_questions=side["qa_questions"])
    nested_mixes = corpus.qa_nested_mixes(args.batch)
    seen, shim = capture_fold_calls()
    for bodies in join_mixes.values():          # warm-up: uploads, layouts
        search_merged(readers_j, bodies[:JOIN_WARMUP])
    with swapped_kernels(to_parent_fold=shim):
        search_merged(readers_n, nested_mixes["nested_match"])
        search_merged(readers_n, nested_mixes["nested_aggs"][:JOIN_WARMUP])
    sync()
    lap("warm_up")
    stats, last, launches = run_dsl_path(readers_j, join_mixes, sync,
                                         on_card)
    n_stats, n_last, n_launches = run_dsl_path(readers_n, nested_mixes,
                                               sync, on_card)
    stats.update(n_stats)
    last.update(n_last)
    launches = {k: launches[k] + n_launches[k] for k in launches}
    lap("timed_mixes")
    if on_card:
        missing = [k for k in JOIN_KERNELS if launches[k] <= 0]
        if missing:
            raise AssertionError(f"kernels never launched on path (w): "
                                 f"{missing}")
    check_join_path(stats, last)
    with swapped_kernels(**join_plain_versions()):
        for readers, mixes in ((readers_j, join_mixes),
                               (readers_n, nested_mixes)):
            for name, bodies in mixes.items():
                if _strip(search_merged(readers, bodies[:JOIN_SWAP])) \
                        != _strip(last[name][:JOIN_SWAP]):
                    raise AssertionError(f"join {name}: responses with the "
                                         "plain versions swapped in differ")
    del readers_j, readers_n, qa_segs
    lap("plain_swap")
    for name in (*corpus.QA_JOIN_MIXES, *corpus.QA_NESTED_MIXES):
        log("join mix " + json.dumps({
            "mix": name, "requests": stats[name]["requests"],
            "qps": stats[name]["qps"], "p50_ms": stats[name]["p50_ms"],
            "hits": stats[name]["hits"],
            "device_busy_ms": stats[name].get("device_busy_ms"),
            "device_idle_share": stats[name].get("device_idle_share"),
            "launches": {k: v for k, v in stats[name]["launches"].items()
                         if v},
            "admission": stats[name]["fused"]["admission"],
            "gpu": gpu_line() if on_card else "cpu"}))
    small = join_small_check(dev if on_card else "cpu")
    log("join small nodes: " + json.dumps(small))
    lap("small_nodes")
    report = {"setup": setup, "mixes": stats, "small": small,
              "launches": launches, "laps": laps,
              "seconds": time.perf_counter() - t_phase,
              "gpu": gpu_line() if on_card else "cpu"}
    log("joins: " + json.dumps({k: report[k] for k in (
        "setup", "small", "launches", "laps", "seconds", "gpu")}))
    return report, launches, (seen, segs[0])


def join_kernels(report: dict, launches: dict, kern_in, dev,
                 old=None) -> dict:
    """The to-parent fold on path (w)'s own first call of each score mode
    (`join_phase`'s captures), then a sweep row: JOIN_SWEEP_B rows over
    the nested shard's layout (its hottest parent over 4,096 rows), random
    scores of both signs, 70% of the nested rows matched; each
    `torch.equal` to its plain version, timed beside its bound and the
    library's scatters; with the previous commit's ops (`old`), each in
    turns with its fold. Adds `folds` and `sweep` to the path's report;
    returns the kernels line's entry."""
    import torch
    from elasticsearch_tpu_torch.search import executor
    seen, seg = kern_in
    folds = {mode: measure_parent_fold(score, ok, layout, mode, reps=20,
                                       old=old)
             for mode, (score, ok, layout, _m) in sorted(seen.items())}
    seen.clear()
    nest = executor.device_arrays(seg, dev)["nested"]
    g = torch.Generator(device=dev).manual_seed(5)
    score = torch.randn((JOIN_SWEEP_B, seg.capacity), device=dev,
                        generator=g)
    ok = (torch.rand((JOIN_SWEEP_B, seg.capacity), device=dev, generator=g)
          < 0.7) & nest["is_child"][None, :]
    sweep = {m: measure_parent_fold(score, ok, nest, m, reps=10, old=old)
             for m in ("none", "sum", "max", "min")}
    if sweep["sum"]["hottest"] <= 4096:
        raise AssertionError(f"join sweep: hottest list "
                             f"{sweep['sum']['hottest']} <= 4096")
    del score, ok
    for mode, m in folds.items():
        log(f"main-path inputs to_parent_fold ({mode}): " + json.dumps(m))
    for mode, m in sweep.items():
        log(f"sweep to_parent_fold ({mode}): " + json.dumps(m))
    report.update(folds=folds, sweep=sweep)
    m = folds.get("sum") or next(iter(folds.values()))
    return {"name": "to_parent_fold", "route": "cuda",
            "source": JOIN_SOURCE[0], "replaces": JOIN_SOURCE[1],
            "launches": launches["to_parent_fold"],
            "max_abs_err": max([f["max_abs_err"] for f in folds.values()]
                               + [f["max_abs_err"] for f in sweep.values()]),
            "ms": m["ms"], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"],
            "call": {"mix": "nested_match", "mode": m["mode"], "B": m["B"],
                     "cap": m["cap"], "hottest": m["hottest"]},
            "sweep_call": {k: sweep["sum"][k] for k in (
                "B", "cap", "hottest", "ms", "plain_ms", "library_ms",
                "bound_ms")}}


def gpu_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()
        return out[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable ({e})"


def on_card(args) -> int:
    import torch
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    t_run = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"gpu: {gpu_line()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(dev)}")

    # phase 2: build. In a whole run the node ingest's documents are made
    # meanwhile (nvcc runs in processes of its own)
    whole = not (args.vectors_only or args.dsl_only or args.joins_only
                 or args.kernels_only)
    built = {}

    def build():
        try:
            built["s"] = cs.build(verbose=True)
        except BaseException as e:  # noqa: BLE001 — raised below
            built["error"] = e
    builder = threading.Thread(target=build)
    builder.start()
    from elasticsearch_tpu_torch import corpus
    if whole:
        t0 = time.perf_counter()
        shard_docs = [corpus.make_docs(args.docs, seed=42 + s,
                                       start=s * args.docs, long_every=1000)
                      for s in range(2)]
        gen_s = time.perf_counter() - t0
    builder.join()
    if "error" in built:
        raise built["error"]
    build_s = built["s"]
    log(f"build: {build_s:.2f} s")
    for name, out in cs.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    log("ptxas bundle_topk_kernel: " + json.dumps(k3_ptxas()))
    old = load_parent_k3(args.ab_parent) if args.ab_parent else None
    if args.vectors_only:
        vectors, vec_entry = vector_phase(
            args, dev, torch.cuda.synchronize, args.out_dir,
            build=start_passage_build(), old=old)
        log("vectors: " + json.dumps({k: vectors[k] for k in (
            "setup", "recall", "small", "node", "laps", "seconds",
            "gpu")}))
        log("knn_vec kernel: " + json.dumps(vec_entry))
        log(f"vectors only: {time.perf_counter() - t_run:.1f} s")
        return 0
    if args.dsl_only:
        t0 = time.perf_counter()
        segs = build_shards(args.docs, 2, 1000, workers=2)
        small = build_shards(args.small_docs, 2, 300, workers=2)
        log(f"dsl only: shards built in {time.perf_counter() - t0:.1f} s")
        gc.collect()
        gc.freeze()
        readers = make_readers(segs, dev)
        on_gpu = make_readers(small, dev)
        on_cpu = make_readers([copy.copy(s) for s in small], "cpu")
        dsl_phase(args, readers, on_gpu, on_cpu, dev, torch.cuda.synchronize)
        script_phase(args, readers, on_gpu, on_cpu, torch.cuda.synchronize)
        log("script node: " + json.dumps(script_node_check(
            SCRIPT_NODE_DOCS, dev)))
        log(f"dsl only: {time.perf_counter() - t_run:.1f} s")
        return 0
    if args.joins_only:
        side = start_side_builds(args)
        joins, launches, kern_in = join_phase(args, dev,
                                              torch.cuda.synchronize, side,
                                              {})
        entry = join_kernels(joins, launches, kern_in, dev, old=old)
        side["pool"].terminate()
        side["pool"].join()
        log("to_parent_fold kernel: " + json.dumps(entry))
        log(f"joins only: {time.perf_counter() - t_run:.1f} s")
        return 0
    if args.kernels_only:
        rng = np.random.default_rng(42)
        _sweep, worst = kernel_sweep(dev, rng, old=old)
        log(f"kernels only: worst error {worst}, "
            f"{time.perf_counter() - t_run:.1f} s")
        return 0

    phase_s = {"build": time.perf_counter() - t_run}
    mark = time.perf_counter()

    def lap(name):
        nonlocal mark
        now = time.perf_counter()
        phase_s[name] = now - mark
        mark = now
        log(f"phase {name}: {phase_s[name]:.1f} s")

    # phase 4a: the node path's ingest. A Node on the card behind a
    # loopback RestServer takes index `logs` (2 shards, the streaming
    # delta mode): shard s gets corpus.make_docs(docs, seed 42 + s, start
    # s * docs), routed there, through node.bulk (one batch over HTTP
    # _bulk); one refresh compacts each shard's delta into its base. The
    # earlier paths search these bases: a compacted single delta is the
    # SegmentBuilder's segment of the same docs, every array equal
    # (tests/test_torch_engine.py). Beside it, where the host's other
    # cores are idle: the kernel sweeps (phase 3) in a process of their
    # own on the card, and the side builds (the deltas, the small index,
    # path (w)'s shards) in 4 workers at nice 19
    from elasticsearch_tpu_torch.node import Node
    sweeper = start_worker("kernels", "cuda", args.ab_parent or "")
    side = start_side_builds(args)
    side_wait: dict = {}
    main_threads = torch.get_num_threads()
    torch.set_num_threads(WINDOW_THREADS)
    from elasticsearch_tpu_torch.rest.server import RestServer
    data = data_dir("node")
    settings = node_settings(data)
    node = Node(settings, device=dev)
    server = RestServer(node, "127.0.0.1", 0).start()
    url = f"http://127.0.0.1:{server.port}"
    node.create_index("logs", {"number_of_shards": 2,
                               "number_of_replicas": 0,
                               "index.streaming.delta": True},
                      corpus.MAPPING)
    keys = routing_keys(2)
    ingest = node_ingest(node, url, shard_docs, keys)
    del shard_docs
    t0 = time.perf_counter()
    node.refresh("logs")
    ingest["refresh_s"] = time.perf_counter() - t0
    engines = list(node.indices["logs"].shards.values())
    if any(len(e.segments) != 1 or e.segment_stats()["streaming"][
            "compactions"] != 1 for e in engines):
        raise AssertionError("node ingest: the refresh did not compact "
                             "each shard into one base")
    segs = [e.segments[0] for e in engines]
    if [s.num_docs for s in segs] != [args.docs, args.docs]:
        raise AssertionError(f"node ingest: {[s.num_docs for s in segs]}")
    ingest.update({"docs_per_s": ingest["docs"] / ingest["s"],
                   "translog": settings["index.translog.durability"],
                   "docs_per_s_without_translog":
                       NO_TRANSLOG_INGEST_DOCS_PER_S,
                   "translog_bytes": dir_bytes(data),
                   "generate_s": gen_s, "generated_beside_build": True,
                   "gpu": gpu_line()})
    log("node ingest: " + json.dumps(ingest))
    log(f"index: 2 shards x {args.docs} docs from the node; capacity "
        f"{[s.capacity for s in segs]}; message L "
        f"{[s.text['message'].fwd_tids.shape[1] for s in segs]}, P "
        f"{[s.text['message'].pos_width for s in segs]}; body "
        f"forward index {[s.text['body'].fwd_tids is not None for s in segs]}")
    if any(s.text["body"].fwd_tids is not None for s in segs):
        raise AssertionError("body must have no forward index")
    if any(s.text["message"].fwd_pos is None for s in segs):
        raise AssertionError("message must carry a positions pack")
    # the index's host side (ids, sources, id maps: millions of Python
    # objects) lives as long as the run; freezing it keeps the cyclic
    # collector from re-walking it on every batch, as a long-lived server
    # would
    gc.collect()
    gc.freeze()

    torch.set_num_threads(main_threads)
    lap("node_ingest")
    # phase 3: kernels at the slice's shapes, swept beside the ingest
    kern = finish_worker(sweeper)
    sweep, worst = kern["sweep"], kern["worst"]
    log("kernel sweep (beside the ingest): " + json.dumps(
        {"worker_s": kern["worker_s"], "wait_s": kern["wait_s"]}))
    lap("kernel_sweep")

    # phase 4: main paths
    readers = make_readers(segs, dev)
    mixes = request_mixes(args.batch, readers, args.docs)
    log("mixes: " + json.dumps({k: len(v) for k, v in mixes.items()}))
    seen, current, shims = capture_first_calls()
    with swapped_kernels(**shims):
        for name in MIXES:                       # warm-up: uploads, layouts
            current["mix"] = name
            search_merged(readers, mixes[name])
    torch.cuda.synchronize()
    sync = torch.cuda.synchronize
    stats, last, path_launches = run_main_path(readers, mixes, args.reps,
                                               sync)
    log("launches: " + json.dumps(path_launches))
    for name in MIXES:
        log("mix " + json.dumps({"mix": name, **stats[name]}))
    launches = check_launches(path_launches)
    check_responses(last)
    check_admission(stats)
    check_plain_swap(readers, mixes, last)
    log("plain swap: identical responses on every mix")

    # the match mix on the fused engine and on the unfused path, in turns
    # (fused, unfused, unfused, fused); the responses must be identical
    match_ab = {"fused": [], "unfused": []}
    for turn in ("fused", "unfused", "unfused", "fused"):
        os.environ["ES_TPU_FUSED"] = "1" if turn == "fused" else "0"
        try:
            if turn == "unfused" and not match_ab["unfused"]:
                assert_close_responses(
                    _strip(search_merged(readers, mixes["match"])),
                    _strip(last["match"]))
            match_ab[turn].append(time_mix(readers, mixes["match"],
                                           args.reps, sync)[0])
        finally:
            del os.environ["ES_TPU_FUSED"]
    match_ab = {k: {"qps": float(np.mean([r["qps"] for r in v])),
                    "p50_ms": float(np.mean([r["p50_ms"] for r in v])),
                    "turns": v} for k, v in match_ab.items()}
    log("match fused vs unfused: " + json.dumps(match_ab))
    # POSITIONAL_AB positional requests on the host oracle
    # (ES_TPU_POSITIONAL=0): the sloppy phrase and span_near ones it can
    # afford, exact phrases and cross_fields for the rest; every sloppy /
    # span_near request of the small index below as well
    pos_ab = {"main": positional_ab(
        readers, positional_ab_subset(readers, mixes, POSITIONAL_AB), sync)}
    log("positional fused vs host oracle: " + json.dumps(pos_ab))
    out_dir = args.out_dir
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    profiles = profile_mixes(readers, mixes, out_dir)
    if profiles["stats_aggs"]["scatter_atomics_ms"] > 0:
        raise AssertionError("stats_aggs: scatter_reduce_ / index_add_ on "
                             "the card: " + json.dumps(profiles["stats_aggs"]))

    lap("main_paths")
    # the card agrees with the CPU on a small index
    small = side_result(side, "small", side_wait)
    # separate segment objects: each caches its own device columns
    on_gpu = make_readers(small, dev)
    on_cpu = make_readers([copy.copy(s) for s in small], "cpu")
    small_mix = request_mixes(24, on_cpu, args.small_docs)
    # every agg sum of the mixes (sorted layouts and views: terms and
    # date_histogram counts, sum and avg; the doc-space bucket sums of
    # terms -> stats / extended_stats; a stats agg's row sums) is taken in
    # XLA's order on both (ops/ordered.py; the scan, tree and bucket-sum
    # kernels on the card), so the card must give the CPU's bits:
    # compared exactly (rtol 0), also for terms -> stats / extended_stats
    # and stats aggs on match queries (doc-space masks)
    for name in MIXES:
        assert_close_responses(
            _strip(search_merged(on_gpu, small_mix[name])),
            _strip(search_merged(on_cpu, small_mix[name])), rtol=0.0)
    stats_bodies = [{"query": b["query"], "size": 0, "aggs": {
        "by_status": {"terms": {"field": "status"},
                      "aggs": {"st": {"stats": {"field": "size"}},
                               "ext": {"extended_stats": {
                                   "field": "size"}}}},
        "all": {"stats": {"field": "size"}}}}
        for b in small_mix["match"][:16]]
    assert_close_responses(_strip(search_merged(on_gpu, stats_bodies)),
                           _strip(search_merged(on_cpu, stats_bodies)),
                           rtol=0.0)
    log(f"cpu check: {args.small_docs}-doc shards agree on the card and "
        "the CPU, every agg sum exactly (stats and extended_stats "
        "included)")
    pos_ab["small"] = positional_ab(
        on_gpu, {name: host_affordable(on_gpu, small_mix[name], 24)
                 for name in ("phrase_slop_aggs", "span_near")}, sync)
    log("positional fused vs host oracle, small index: "
        + json.dumps(pos_ab["small"]))

    lap("small_index")
    # phase 5: the delta path (a 2^17-doc delta beside each shard)
    deltas = pair_deltas(segs, side_result(side, "deltas", side_wait))
    log(f"delta: 2 deltas x {args.delta_docs} docs built; capacity "
        f"{[d.capacity for d in deltas]}, delta_parent "
        f"{[d.delta_parent for d in deltas]}")
    readers_d = make_pack_readers(segs, deltas, dev)
    dmix = delta_mixes(args.batch, readers_d, args.docs)
    log("delta mixes: " + json.dumps({k: len(v) for k, v in dmix.items()}))
    form_seen, form_shim = capture_forms(deltas[0].capacity)
    with swapped_kernels(bundle_walk_steps=form_shim):
        for name in DELTA_MIXES:                 # warm-up: uploads
            time_mix(readers_d, dmix[name], 1, sync,
                     batch=DELTA_BATCH.get(name))
    sync()
    d_stats, d_last, d_launches = run_delta_path(readers_d, dmix, args.reps,
                                                 sync)
    log("delta launches: " + json.dumps(d_launches))
    for name in DELTA_MIXES:
        log("delta mix " + json.dumps({"mix": name, **d_stats[name]}))
    if d_launches["bundle_topk_seeded"] <= 0:
        raise AssertionError("delta path: K3's seeded form never launched")
    check_responses(d_last)
    d_ab = delta_ab(readers_d, dmix, d_last, min(args.reps, 2), sync)
    log("delta pack vs per-segment: " + json.dumps(d_ab))

    lap("delta_path")
    # phase 6: the resident path on the main index
    os.environ["ES_TPU_RESIDENT_LOOP"] = "1"
    try:
        with swapped_kernels(bundle_walk_steps=form_shim):
            search_merged(readers, mixes["match"],
                          time.monotonic() + 3600)
        sync()
    finally:
        del os.environ["ES_TPU_RESIDENT_LOOP"]
    res = run_resident_path(readers, mixes, last, args.reps, sync)
    log("resident: " + json.dumps(res))

    lap("resident_path")
    # kernels on the main path's own inputs: K1 and K2 on the first call
    # of the run, K3 on the first call of each fused mix (the kernels
    # line takes the first positional one), the unfused leaf on its first
    first = {}
    for name in MIXES:
        for kern, call in seen.get(name, {}).items():
            if not isinstance(kern, tuple):     # by perm kind: below
                first.setdefault(kern, (name, call))
    # every kernel of the main paths (the to-parent fold is path (w)'s)
    if set(first) != set(cs.LAUNCHES) - {"to_parent_fold"}:
        raise AssertionError(f"captured {sorted(first)}")
    meas = {"dense_score": measure_dense(first["dense_score"][1][0],
                                         reps=20, old=old),
            "scatter_add": measure_scatter(*first["scatter_add"][1][0],
                                           reps=20, old=old),
            "positional_leaf": measure_leaf(first["positional_leaf"][1][0],
                                            reps=10, old=old),
            "ordered_sum": measure_tree(*first["ordered_sum"][1][0],
                                        reps=20, old=old),
            "ordered_bucket_stats": measure_bucket_stats(
                *seen["stats_aggs"]["ordered_bucket_stats"][0], reps=20,
                ns_per_add=add_latency(dev)["ns_per_add"], old=old)}
    # the scan kernel on every agg mix's first call of each permutation
    # kind (B, cap of the main path), equal to its plain version; the
    # kernels line takes the first; the tree also on stats_aggs' rows
    scan_err = 0.0
    for name in AGG_MIXES:
        for key, (a, _kw) in seen[name].items():
            if not isinstance(key, tuple):
                continue
            m = measure_scan(*a, reps=20, old=old)
            scan_err = max(scan_err, m["max_abs_err"])
            log(f"main-path inputs ordered_prefix ({name}, {key[1]}): "
                + json.dumps({"shapes": [list(v.shape) for v in a
                                         if hasattr(v, "shape")], **m}))
            meas.setdefault("ordered_prefix", m)
    meas["ordered_prefix"]["max_abs_err"] = scan_err
    a, _kw = seen["stats_aggs"]["ordered_sum"]
    m = measure_tree(*a, reps=20, old=old)
    log("main-path inputs ordered_sum (stats_aggs): " + json.dumps(
        {"shape": list(a[0].shape), **m}))
    meas["ordered_sum"]["max_abs_err"] = max(
        meas["ordered_sum"]["max_abs_err"], m["max_abs_err"])
    k3_err = 0.0
    for name in FUSED_MIXES:
        a, kw = seen[name]["bundle_topk"]
        m = measure_bundle(a, kw, reps=20)
        if old is not None:
            m["ab"] = k3_ab(a, kw, old)
        k3_err = max(k3_err, m["max_abs_err"])
        log(f"main-path inputs bundle_topk ({name}): " + json.dumps({
            "B": a[4].shape[0], "cap": a[6].shape[0],
            "clauses": [list(c) for c in a[2]], **kw, **m}))
        if name == POSITIONAL_MIXES[0]:
            meas["bundle_topk"] = dict(m)
            first["bundle_topk"] = (name, (a, kw))
    meas["bundle_topk"]["max_abs_err"] = k3_err
    # K3's stepped form on the resident path's first walk, its seeded
    # form on the delta path's first delta walk
    for form, path, path_launches in (("stepped", "resident",
                                       res["launches"]),
                                      ("seeded", "delta", d_launches)):
        a, kw = form_seen[form]
        pos = any(":" in kd for _r, kd, _f, _w in a[2])
        m = measure_bundle(a, kw, reps=10, rows=PLAIN_ROWS if pos else None)
        if old is not None:
            m["ab"] = k3_ab(a, kw, old)
        name = f"bundle_topk_{form}"
        meas[name] = m
        first[name] = (path, (a, kw))
        launches[name] = path_launches[name]
    kernels = []
    for name, (source, replaces) in {**KERNEL_SOURCES,
                                     **FORM_SOURCES}.items():
        m = meas[name]
        mix, (a, kw) = first[name]
        # the main-path call that ms, plain_ms and bound_ms were taken on
        if name in ("dense_score", "scatter_add", "ordered_prefix",
                    "ordered_sum", "ordered_bucket_stats"):
            call = {"mix": mix, "shapes": [list(v.shape) for v in a
                                           if hasattr(v, "shape")]}
        elif name.startswith("bundle_topk"):
            call = {"mix": mix, "B": a[4].shape[0], "ck": kw["ck"],
                    "cap": a[6].shape[0],
                    "clauses": [[r, kd] for r, kd, _f, _w in a[2]]}
            if kw.get("step") is not None:
                call["chunk_tiles"] = kw["step"][0]
        else:
            call = {"mix": mix, "kind": a[0], "B": a[2][0].shape[0]}
        log(f"main-path inputs {name}: " + json.dumps({**call, **m}))
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": max(worst, m["max_abs_err"]),
                        "ms": m["ms"], "plain_ms": m["plain_ms"],
                        "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                        "library_ms": m["library_ms"], "call": call})
    lap("main_path_kernels")
    # path (u): the query DSL on the main path's bases, the small index of
    # phase 4 and a node over HTTP; its launches join the kernels line
    dsl, dsl_launches = dsl_phase(args, readers, on_gpu, on_cpu, dev, sync)
    for k in kernels:
        k["launches"] += dsl_launches.get(k["name"], 0)
    lap("dsl")
    # path (v): scripts and the device metric aggs on the same bases and
    # small index; its launches join the kernels line
    scripts, script_launches = script_phase(args, readers, on_gpu, on_cpu,
                                            sync)
    for k in kernels:
        k["launches"] += script_launches.get(k["name"], 0)
    del on_gpu, on_cpu, small
    lap("scripts")
    # phase 7: the node path. The earlier paths' readers go first, so
    # that compaction can release the replaced segments' holds; then a
    # delta per shard, every mix through node.msearch / HTTP _msearch /
    # the engines' readers, deletes and updates, compaction
    del readers, readers_d, segs, deltas, engines
    gc.collect()
    # path (t)'s passages build in the background from here on (4 workers
    # at nice 19), beside the node path, the restart and the scroll, which
    # leave most of the host's cores idle; the main process's CPU torch
    # ops on WINDOW_THREADS meanwhile
    vec_build = start_passage_build()
    torch.set_num_threads(WINDOW_THREADS)
    node_out, node_launches = node_phase(
        args, node, url, sync,
        profile=lambda search, m: profile_mixes(
            None, m, out_dir, NODE_PROFILE_MIXES, search, "node "))
    missing = [k for k in NODE_KERNELS if node_launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the node path: "
                             f"{missing}")
    log("node launches: " + json.dumps(node_launches))
    for k in kernels:
        k["launches"] += node_launches[k["name"]]
    server.stop()
    lap("node_path")
    # the durable node: a full-scale restart, then scroll / scan / dfs on
    # the recovered node
    node, durable, restart_launches = restart_phase(args, node, settings,
                                                    dev, sync)
    durable["gpu"] = gpu_line()
    log("durable: " + json.dumps(durable))
    lap("restart")
    scroll_out, scroll_launches, k3_deep = scroll_phase(args, node, dev,
                                                        sync)
    scroll_out["gpu"] = gpu_line()
    log("scroll: " + json.dumps(scroll_out))
    node.close()
    shutil.rmtree(data, ignore_errors=True)
    missing = [k for k in ("bundle_topk",) if scroll_launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the scroll path: "
                             f"{missing}")
    for k in kernels:
        k["launches"] += (restart_launches[k["name"]]
                          + scroll_launches[k["name"]])
        if k["name"] == "bundle_topk":
            k["scroll_call"] = {key: k3_deep[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                "call")}
            k["max_abs_err"] = max(k["max_abs_err"], k3_deep["max_abs_err"])
    lap("scroll")
    # the kill -9 rounds and the small node (the card against the CPU
    # after every write step, Part A's subnormal docs and bodies included)
    # in processes of their own, beside path (v)'s HTTP node and path (w)
    # in this one
    window = [start_worker("kill9", "cuda"),
              start_worker("small_node", "cuda",
                           str(min(args.small_docs, SMALL_NODE_DOCS)))]
    # path (v)'s HTTP node (stored script, scripted update, restart)
    scripts["node"] = script_node_check(SCRIPT_NODE_DOCS, dev)
    log("script node (beside the kill -9 and small node workers): "
        + json.dumps(scripts["node"]))
    lap("script_node")
    # path (w): joins on the shards built beside the ingest; its launches
    # join the kernels line
    joins, join_launches, join_in = join_phase(args, dev, sync, side,
                                               side_wait)
    side["pool"].close()
    side["pool"].join()
    log("side builds (beside the ingest), seconds waited: "
        + json.dumps(side_wait))
    for k in kernels:
        k["launches"] += join_launches.get(k["name"], 0)
    lap("joins")
    # path (t)'s small dyadic index and small node need no passages
    vec_small = vector_small_checks(args, dev, sync)
    lap("vector_small_checks")
    kills = finish_worker(window[0])
    node_out["small"] = finish_worker(window[1])
    log("small node: " + json.dumps(node_out["small"]))
    log("window workers: " + json.dumps(
        {"kill9_s": kills["worker_s"], "small_node_s":
         node_out["small"]["worker_s"], "waited_s": kills["wait_s"]
         + node_out["small"]["wait_s"]}))
    lap("window_workers")
    # the to-parent fold timed on the card alone, once the workers that
    # shared it have ended; it has an entry of its own in the kernels line
    kernels.append(join_kernels(joins, join_launches, join_in, dev,
                                old=old))
    lap("join_kernels")
    torch.set_num_threads(main_threads)
    # path (t): vectors, hybrid bundles and rescore
    vectors, vec_entry = vector_phase(args, dev, sync, out_dir,
                                      build=vec_build, small=vec_small,
                                      old=old)
    kernels.append(vec_entry)
    lap("vectors")
    log("vectors: " + json.dumps({k: vectors[k] for k in (
        "setup", "recall", "small", "node", "laps", "seconds", "gpu")}))
    log("phase seconds: " + json.dumps(phase_s))
    node_out["ingest"] = ingest
    free, total = torch.cuda.mem_get_info(dev)
    log("node summary: " + json.dumps({
        "gpu": gpu_line(),
        "ingest_docs_per_s": ingest["docs_per_s"],
        "ingest_refresh_compaction_s": ingest["refresh_s"],
        "delta_refresh_s": node_out["delta_refresh_s"],
        "edits_refresh_s": node_out["edits_refresh_s"],
        "compaction_s": node_out["compaction_s"],
        "mixes": {name: {path: {"qps": v[path]["qps"],
                                "p50_ms": v[path]["p50_ms"]}
                         for path in ("node", "rest", "direct")}
                  for name, v in node_out["mixes"].items()},
        "device_idle_share": {name: v["device_idle_share"]
                              for name, v in node_out["profiles"].items()},
        "fielddata": node_out["fielddata"],
        "durable": {k: durable[k] for k in (
            "flush_s", "store_bytes", "boot_s", "recovery",
            "first_serve_s", "fielddata_before", "fielddata_after")},
        "scroll_page_p50_ms": scroll_out["page_p50_ms"],
        "kill9_acked": [k["acked"] for k in kills["rounds"]],
        "mem_get_info": {"free": free, "total": total}}))
    report = {"gpu": gpu_line(), "build_s": build_s, "sweep": sweep,
              "mixes": stats, "match_fused_vs_unfused": match_ab,
              "positional_fused_vs_host": pos_ab,
              "delta": {"mixes": d_stats, "launches": d_launches,
                        "pack_vs_segments": d_ab},
              "resident": res, "node": node_out, "durable": durable,
              "scroll": scroll_out, "kill9": kills["rounds"],
              "vectors": vectors,
              "dsl": dsl, "joins": joins,
              "profiles": profiles, "kernels": kernels,
              "seconds": time.perf_counter() - t_run}
    if out_dir:
        with open(os.path.join(out_dir, "chip_smoke_report.json"), "w") as f:
            json.dump(report, f, indent=1)
    log(f"total: {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--docs", type=int, default=1 << 20,
                   help="docs per shard on the main path")
    p.add_argument("--batch", type=int, default=256,
                   help="requests per mix")
    p.add_argument("--reps", type=int, default=3,
                   help="timed repetitions of each mix")
    p.add_argument("--small-docs", type=int, default=20_000,
                   help="docs per shard of the card-vs-CPU check")
    p.add_argument("--delta-docs", type=int, default=DELTA_DOCS,
                   help="docs per shard's delta segment on the delta path")
    p.add_argument("--out-dir", default=None,
                   help="directory for the JSON report and profile tables")
    p.add_argument("--rehearse", action="store_true",
                   help="run the main path's checks on the CPU, tiny")
    p.add_argument("--ab-parent", default=None,
                   help="a copy of an earlier commit (its "
                        "elasticsearch_tpu_torch/ops at least) whose K3 "
                        "is timed in turns against this one")
    p.add_argument("--kernels-only", action="store_true",
                   help="stop after the kernel sweeps (no result line)")
    p.add_argument("--vectors-only", action="store_true",
                   help="build, then the vectors path alone (no result "
                        "line)")
    p.add_argument("--joins-only", action="store_true",
                   help="build, then path (w), the joins, alone (no "
                        "result line)")
    p.add_argument("--dsl-only", action="store_true",
                   help="build, then path (u), the query DSL, alone on "
                        "shards built in workers (no result line)")
    p.add_argument("--durability-worker", nargs=7, default=None,
                   metavar=("DATA", "SEED", "START", "DEVICE", "DOCS",
                            "FLUSH_EVERY", "BATCH"),
                   help="run the kill -9 rounds' writer (internal)")
    p.add_argument("--worker", nargs=4, default=None,
                   metavar=("KIND", "OUT", "DEVICE", "ARG"),
                   help="run a part of the run in its own process "
                        "(internal)")
    args = p.parse_args(argv)
    if args.durability_worker:
        return durability_worker(args.durability_worker)
    if args.worker:
        if args.worker[0] not in WORKER_KINDS:
            p.error(f"--worker: unknown kind {args.worker[0]}")
        try:
            return run_worker(*args.worker)
        finally:
            remove_data()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    try:
        import elasticsearch_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 1
    if args.rehearse:
        try:
            return rehearse(min(args.docs, 1500), min(args.batch, 8))
        finally:
            stop_workers()
            remove_data()
    if args.out_dir:
        global _log_file
        os.makedirs(args.out_dir, exist_ok=True)
        _log_file = open(os.path.join(args.out_dir, "chip_smoke.log"), "w")
    if not torch.cuda.is_available():
        print("chip_smoke: needs a CUDA device "
              "(torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    try:
        return on_card(args)
    finally:
        stop_workers()
        remove_data()


if __name__ == "__main__":
    sys.exit(main())
