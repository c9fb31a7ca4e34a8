#!/usr/bin/env python3
"""Drive the PyTorch port of the search engine on one NVIDIA GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. It needs one
CUDA device and exits non-zero, printing no result, without one. Phases,
each of which fails the run on any error:

1. device: the card's name and power limit as nvidia-smi reports them;
2. build: the hand-written CUDA kernels of `elasticsearch_tpu_torch/ops`
   compiled from their sources with nvcc for sm_90a;
3. kernels: each kernel held bit-exact (`torch.equal`) against its plain
   PyTorch version at the slice's shapes, with kernel / plain / library
   times (CUDA events) and the card's least time for the same work (K3,
   the fused bundle walk: one to three clauses, with and without a range
   filter, k 10 and 100, the match mask on and off, the mask-only grid);
4. main path: two shards of 2^20 http_logs-like docs (seed 42) built with
   the port's SegmentBuilder, seven request mixes of 256 requests through
   `ShardReader.msearch` + `merge_shard_results`; the kernel launch counts
   of that run must be non-zero for every kernel, the fused engine must
   admit exactly the plans of the `match`, `match_range_aggs` and
   `count_match` mixes, the same requests with the plain versions swapped
   in must give identical responses, a small index searched on the card
   must agree with the same search on the CPU, and each kernel must equal
   its plain version on the inputs the main path handed it; the `match`
   mix is also timed on the unfused path (`ES_TPU_FUSED=0`);
5. a `kernels` JSON line, then the result line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

`--rehearse` runs phases 4's checks on the CPU at a toy size (no build,
no timings, no result line), to exercise this script without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import json
import multiprocessing
import os
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12    # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12    # float32 outside the tensor cores
MIXES = ("match", "bool_aggs", "prefix", "term_body", "aggs_only",
         "match_range_aggs", "count_match")
FUSED_MIXES = ("match", "match_range_aggs", "count_match")
KERNEL_SOURCES = {
    "dense_score": ("elasticsearch_tpu_torch/ops/csrc/dense_score.cu",
                    "elasticsearch_tpu/ops/pallas_scoring.py:60"),
    "scatter_add": ("elasticsearch_tpu_torch/ops/csrc/scatter_add.cu",
                    "elasticsearch_tpu/ops/pallas_scoring.py:142"),
    "bundle_topk": ("elasticsearch_tpu_torch/ops/csrc/bundle_topk.cu",
                    "elasticsearch_tpu/ops/pallas_scoring.py:337"),
}
# the wrapper of each kernel that counts its launches
WRAPPERS = {"dense_score": "dense_score", "scatter_add": "scatter_add",
            "bundle_topk": "bundle_walk"}


def log(msg: str) -> None:
    print(msg, flush=True)


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


def make_readers(segments, device):
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.index.mapping import MapperService
    from elasticsearch_tpu_torch.search.shard_searcher import ShardReader
    svc = MapperService(mapping=corpus.MAPPING)
    return [ShardReader("logs", [seg], {}, svc, shard_id=s, device=device)
            for s, seg in enumerate(segments)]


def search_merged(readers, bodies) -> list[dict]:
    """Every shard answers the batch, then the cross-shard reduce merges
    each request's shard responses."""
    from elasticsearch_tpu_torch.search.aggregations import parse_aggs
    from elasticsearch_tpu_torch.search.controller import merge_shard_results
    per_shard = [r.msearch(bodies, with_partials=True) for r in readers]
    out = []
    for i, body in enumerate(bodies):
        resps = [shard[i] for shard in per_shard]
        out.append(merge_shard_results(
            resps, agg_specs=parse_aggs(body.get("aggs")),
            shard_partials=[r.get("_agg_partials", {}) for r in resps],
            frm=body.get("from", 0), size=body.get("size", 10)))
    return out


def _strip(resps: list[dict]) -> list[dict]:
    return [{k: v for k, v in r.items() if k != "took"} for r in resps]


def assert_close_responses(got, want, path="resp", rtol=1e-6) -> None:
    """Exact, except float agg `value`s (sum/avg: f32 partial sums may
    be added in another order) at `rtol`."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or sorted(got) != sorted(want):
            raise AssertionError(f"{path}: keys differ")
        for k, v in want.items():
            if k == "took":
                continue
            if k == "value" and isinstance(v, float) and "aggregations" in path:
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


def request_mixes(n: int, readers) -> dict[str, list[dict]]:
    """The corpus module's mixes, with prefixes that expand on every shard
    (a prefix with no term binds to match-nothing)."""
    from elasticsearch_tpu_torch import corpus
    mixes = corpus.request_mixes(4 * n, seed=7)
    vocab = [set(r.segments[0].text["message"].terms) for r in readers]
    mixes["prefix"] = [b for b in mixes["prefix"] if all(
        any(t.startswith(b["query"]["prefix"]["message"]) for t in v)
        for v in vocab)]
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
    return {"dense_score": cs.dense_score_ref,
            "scatter_add": cs.scatter_add_ref,
            "fused_topk_bundle": cs.fused_topk_bundle_ref,
            "match_mask_bundle": cs.match_mask_bundle_ref}


def check_plain_swap(readers, mixes, last) -> None:
    with swapped_kernels(**plain_versions()):
        for name in MIXES:
            if _strip(search_merged(readers, mixes[name])) \
                    != _strip(last[name]):
                raise AssertionError(f"{name}: responses with the plain "
                                     f"versions swapped in differ")


def check_admission(stats) -> None:
    """The fused engine admits the plans of the fused mixes and no other
    (bool_aggs' keyword terms filter, prefix / term_body's posting
    scatter and aggs_only's range-only query have no bundle form)."""
    for name, st in stats.items():
        adm = st["fused"]["admission"]
        if name in FUSED_MIXES and (adm["admitted"] == 0 or adm["rejected"]):
            raise AssertionError(f"{name}: fused admission {adm}")
        if name not in FUSED_MIXES and adm["admitted"]:
            raise AssertionError(f"{name}: admitted to the fused engine")


def time_mix(readers, bodies, reps, sync) -> tuple[dict, list[dict]]:
    """`reps` timed batches of `bodies` -> (stats, last responses)."""
    lat = []
    t_all = time.perf_counter()
    for _ in range(reps):
        t0 = time.perf_counter()
        resps = search_merged(readers, bodies)
        sync()
        lat.append((time.perf_counter() - t0) * 1e3)
    wall = time.perf_counter() - t_all
    return {"requests": len(bodies), "reps": reps,
            "qps": len(bodies) * reps / wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99))}, resps


def run_main_path(readers, mixes, reps, sync):
    """Phase 4 core: returns per-mix stats (fused engine admission and
    prune counters included), the last responses per mix and the kernel
    launch counts of the run (counts zeroed just before)."""
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    from elasticsearch_tpu_torch.search import executor
    for k in cs.LAUNCHES:
        cs.LAUNCHES[k] = 0
    stats, last = {}, {}
    for name in MIXES:
        bodies = mixes[name]
        before = dict(cs.LAUNCHES)
        executor._fused_stats.reset()
        st, last[name] = time_mix(readers, bodies, reps, sync)
        stats[name] = {
            **st,
            "launches": {k: cs.LAUNCHES[k] - before[k] for k in cs.LAUNCHES},
            "hits": sum(r["hits"]["total"] for r in last[name]),
            "fused": executor.fused_scoring_stats(),
        }
    return stats, last, dict(cs.LAUNCHES)


def check_responses(last) -> None:
    for name, resps in last.items():
        scores = [h["_score"] for r in resps for h in r["hits"]["hits"]
                  if h["_score"] is not None]
        if not np.isfinite(scores).all():
            raise AssertionError(f"{name}: non-finite scores")
        if not any(r["hits"]["total"] > 0 for r in resps):
            raise AssertionError(f"{name}: no request matched anything")


def rehearse(n_docs: int, batch: int) -> int:
    """The main path's checks on the CPU at a toy size."""
    import torch
    torch.set_num_threads(2)
    segs = build_shards(n_docs, 2, 200, workers=1)
    readers = make_readers(segs, "cpu")
    mixes = request_mixes(batch, readers)
    stats, last, launches = run_main_path(readers, mixes, 1, lambda: None)
    check_responses(last)
    check_admission(stats)
    check_plain_swap(readers, mixes, last)
    log("rehearse: " + json.dumps({k: {"requests": v["requests"],
                                        "hits": v["hits"],
                                        "fused_admitted": v["fused"][
                                            "admission"]["admitted"]}
                                    for k, v in stats.items()}))
    return 0


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


def dense_bound(tids, qt):
    cap, L = tids.shape
    B, Q = qt.shape
    nbytes = cap * L * 8 + B * Q * 8 + B * cap * 4
    ops = B * cap * Q * (2 * L + 2)      # per slot compare+add; per term mul+add
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def scatter_bound(docs, cap):
    B, N = docs.shape
    nbytes = B * N * 8 + B * cap * 4
    ops = int(((docs >= 0) & (docs < cap)).sum())   # one add per posting
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def measure_dense(args, reps, plain_reps=1):
    import torch
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    got = cs.dense_score(*args)
    want = cs.dense_score_ref(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"dense_score != plain at {args[2].shape}")
    err = float((got - want).abs().max())
    bound_ms, bound_by = dense_bound(args[0], args[2])
    return {"ms": cuda_ms(lambda: cs.dense_score(*args), reps),
            "plain_ms": cuda_ms(lambda: cs.dense_score_ref(*args),
                                plain_reps, warmup=0),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err}


def measure_scatter(docs, vals, cap, reps, plain_reps=1):
    import torch
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    got = cs.scatter_add(docs, vals, cap)
    want = cs.scatter_add_ref(docs, vals, cap)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"scatter_add != plain at {tuple(docs.shape)}")
    err = float((got - want).abs().max())
    idx = torch.where((docs >= 0) & (docs < cap), docs, cap).long()

    def library():
        out = torch.zeros((docs.shape[0], cap + 1), dtype=torch.float32,
                          device=docs.device)
        return out.scatter_add_(1, idx, vals)

    bound_ms, bound_by = scatter_bound(docs, cap)
    return {"ms": cuda_ms(lambda: cs.scatter_add(docs, vals, cap), reps),
            "plain_ms": cuda_ms(lambda: cs.scatter_add_ref(docs, vals, cap),
                                plain_reps, warmup=0),
            "library_ms": cuda_ms(library, reps),
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err}


def bundle_bound(args, kw):
    """Least time of one K3 walk: the larger of (a) the bytes it must
    move, the forward rows and columns of the tiles some row can match
    (each read once), the per-row inputs, and the outputs, over the HBM
    rate, and (b) its work, a compare and an add per slot and term plus
    a multiply and add per term of each dense clause, 3 ops per range
    clause, 2 for the combine and 1 for the selection, for every doc of
    every (row, tile) that can match, over the f32 rate."""
    text_cols, num_cols, clauses, cl_inputs, msm, boost, live, can, ub = args
    ck, emit = kw["ck"], kw["emit_match"]
    B, J = can.shape
    cap = live.shape[0]
    tile = cap // J
    dense = [(inp[0].shape[1], text_cols[f]["fwd_tids"].shape[1])
             for (_r, kd, f, _w), inp in zip(clauses, cl_inputs)
             if kd in ("terms_dense", "term_text")]
    n_range = len(clauses) - len(dense)
    doc_bytes = 1 + sum(text_cols[f]["fwd_tids"].shape[1] * 8
                        for f in {f for _r, kd, f, _w in clauses
                                  if kd in ("terms_dense", "term_text")})
    doc_bytes += 5 * len({f for _r, kd, f, _w in clauses
                          if kd in ("range_int", "range_f32")})
    in_row = sum(t.numel() * 4 for inp in cl_inputs for t in inp) + B * 8
    nbytes = (int(can.any(dim=0).sum()) * tile * doc_bytes + in_row
              + B * J * 5 + B * J * (8 + 8 * ck) + (B * cap if emit else 0))
    per_doc = (sum(q * (2 * L + 2) for q, L in dense) + 3 * n_range + 2
               + (1 if ck else 0))
    ops = int(can.sum()) * tile * per_doc
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / H100_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def measure_bundle(args, kw, reps, plain_reps=1):
    """K3 (`bundle_walk`) vs its plain version on every output."""
    import torch
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    got = cs.bundle_walk(*args, **kw)
    want = cs.bundle_walk_ref(*args, **kw)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, w in zip(("cs", "ci", "cnt", "flags", "match"), got, want):
        if (g is None) != (w is None) or (g is not None
                                          and not torch.equal(g, w)):
            raise AssertionError(f"bundle_topk != plain on {name} at B "
                                 f"{args[4].shape[0]}, kw {kw}")
    if got[0] is not None:
        fin = torch.isfinite(want[0])
        if bool(fin.any()):
            err = float((got[0][fin] - want[0][fin]).abs().max())
    bound_ms, bound_by = bundle_bound(args, kw)
    return {"ms": cuda_ms(lambda: cs.bundle_walk(*args, **kw), reps),
            "plain_ms": cuda_ms(lambda: cs.bundle_walk_ref(*args, **kw),
                                plain_reps, warmup=0),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err}


def bundle_sweep(dev, rng) -> tuple[list[dict], float]:
    """K3 at B 256, cap 2^20 (two text fields of 8 slots and a numeric
    column drawn like the main path's), one to three clauses."""
    import torch
    from elasticsearch_tpu_torch.index.segment import (build_tile_max,
                                                       build_tile_minmax)
    from elasticsearch_tpu_torch.ops.scoring import bundle_tile_bounds
    B, cap, L, per = 256, 1 << 20, 8, 500
    text = {}
    for f in ("f", "g"):
        base = (per * rng.random((cap, L)) ** 3).astype(np.int32)
        tids = base * L + np.arange(L, dtype=np.int32)[None, :]
        tids[rng.random((cap, L)) < 0.3] = -1
        imps = rng.random((cap, L), dtype=np.float32) * 4 + 0.1
        imps[tids < 0] = 0.0
        text[f] = {"fwd_tids": torch.from_numpy(tids).to(dev),
                   "fwd_imps": torch.from_numpy(imps).to(dev),
                   "tile_max": torch.from_numpy(build_tile_max(
                       tids, imps, per * L, cap)).to(dev)}
    vals = rng.integers(100, 100_001, size=cap).astype(np.int32)
    exists = np.ones(cap, bool)
    lo_t, hi_t = build_tile_minmax(vals, exists, cap)
    num = {"n": {k: torch.from_numpy(v).to(dev) for k, v in (
        ("values", vals), ("exists", exists), ("tile_lo", lo_t),
        ("tile_hi", hi_t))}}
    live = torch.ones(cap, dtype=torch.bool, device=dev)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa

    def dense(q, wrapped=False):
        qt = ((per * rng.random((B, q)) ** 3).astype(np.int32) * L
              + rng.integers(0, L, size=(B, q)).astype(np.int32))
        wq = rng.random((B, q), dtype=np.float32) * 3 + 0.1
        return (t(qt), t(wq), t(np.ones(B, np.int32)),
                t(np.full(B, 1.5 if wrapped else 1.0, np.float32)))

    def rng_in():
        lo = rng.integers(100, 60_000, size=B).astype(np.int32)
        return (t(lo), t((lo + 40_000).astype(np.int32)))

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
    rows, worst = [], 0.0
    for label, clauses, k, emit in configs:
        cl = tuple(rng_in() if kd == "range_int" else dense(3, w)
                   for _r, kd, _f, w in clauses)
        n_should = sum(r == "should" for r, *_ in clauses)
        msm = t(np.full(B, 1 if n_should and not any(
            r == "must" for r, *_ in clauses) else 0, np.int32))
        boost = t(np.ones(B, np.float32))
        can, ub = bundle_tile_bounds(clauses, cl, text, num, msm, boost)
        ck = min(k, 1024)
        args = (text, num, clauses, cl, msm, boost, live, can, ub)
        kw = {"ck": ck, "update_thr": True, "emit_match": emit}
        m = measure_bundle(args, kw, reps=10)
        worst = max(worst, m["max_abs_err"])
        rows.append({"kernel": "bundle_topk", "bundle": label, "B": B,
                     "cap": cap, "k": k, "emit_match": emit,
                     "can_match_share": float(can.float().mean()), **m})
        log("kernel_sweep " + json.dumps(rows[-1]))
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


def kernel_sweep(dev, rng) -> tuple[list[dict], float]:
    import torch
    rows, worst = [], 0.0
    B, cap = 256, 1 << 20
    for L in (8, 32):
        tids = rng.integers(-1, 4000, size=(cap, L)).astype(np.int32)
        imps = (rng.random((cap, L), dtype=np.float32) * 5)
        imps[tids < 0] = 0
        t_tids = torch.from_numpy(tids).to(dev)
        t_imps = torch.from_numpy(imps).to(dev)
        for Q in (1, 3, 8):
            qt = rng.integers(-1, 4000, size=(B, Q)).astype(np.int32)
            qt[:, 0] = tids[rng.integers(0, cap, size=B), 0]
            wq = rng.random((B, Q), dtype=np.float32) * 3
            wq[qt < 0] = 0
            m = measure_dense((t_tids, t_imps, torch.from_numpy(qt).to(dev),
                               torch.from_numpy(wq).to(dev)), reps=10)
            worst = max(worst, m["max_abs_err"])
            rows.append({"kernel": "dense_score", "B": B, "Q": Q, "cap": cap,
                         "L": L, **m})
            log("kernel_sweep " + json.dumps(rows[-1]))
        del t_tids, t_imps
    for n_blocks in (8, 64, 512):
        docs, vals = synthetic_postings(rng, B, n_blocks, cap)
        m = measure_scatter(torch.from_numpy(docs).to(dev),
                            torch.from_numpy(vals).to(dev), cap, reps=10)
        worst = max(worst, m["max_abs_err"])
        rows.append({"kernel": "scatter_add", "B": B, "N": n_blocks * 128,
                     "cap": cap, **m})
        log("kernel_sweep " + json.dumps(rows[-1]))
    # unsorted rows with in-chunk repeats take the kernel's serial path
    docs = rng.integers(0, 70_000, size=(33, 1000)).astype(np.int32)
    docs[:, 10:30] = docs[:, 9:10]
    vals = rng.standard_normal((33, 1000)).astype(np.float32)
    m = measure_scatter(torch.from_numpy(docs).to(dev),
                        torch.from_numpy(vals).to(dev), 65_536, reps=3)
    worst = max(worst, m["max_abs_err"])
    log("kernel_sweep " + json.dumps({"kernel": "scatter_add",
                                      "unsorted": True, **m}))
    b_rows, b_worst = bundle_sweep(dev, rng)
    return rows + b_rows, max(worst, b_worst)


def capture_first_calls():
    """Shims that remember, per mix, the first (args, kwargs) each
    kernel's wrapper sees: seen[mix][kernel]. Set current["mix"]."""
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    seen: dict[str, dict] = {}
    current = {"mix": None}
    orig = {k: getattr(cs, w) for k, w in WRAPPERS.items()}

    def shim(name):
        def call(*args, **kw):
            seen.setdefault(current["mix"], {}).setdefault(name, (args, kw))
            return orig[name](*args, **kw)
        return call

    return seen, current, {WRAPPERS[k]: shim(k) for k in orig}


def profile_mixes(readers, mixes, out_dir: str | None) -> dict:
    """One profiled batch per mix: wall time, device busy time (sum of the
    card's kernel and copy intervals, merged where they overlap) and the
    ops that took the most device and host time. Tables go to out_dir."""
    import cProfile
    import io
    import pstats
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for name in MIXES:
        torch.cuda.synchronize()
        prof_py = cProfile.Profile()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prof_py.enable()
            search_merged(readers, mixes[name])
            torch.cuda.synchronize()
            prof_py.disable()
            wall = (time.perf_counter() - t0) * 1e3
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        busy_us, cur = 0.0, None
        for a, b in spans:
            if cur is None or a > cur[1]:
                if cur is not None:
                    busy_us += cur[1] - cur[0]
                cur = [a, b]
            else:
                cur[1] = max(cur[1], b)
        if cur is not None:
            busy_us += cur[1] - cur[0]
        ka = prof.key_averages()
        top_dev = sorted(ka, key=lambda e: -e.self_device_time_total)[:6]
        out[name] = {
            "wall_ms": wall, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": max(0.0, 1.0 - busy_us / 1e3 / wall),
            "top_device_ops_ms": {e.key[:60]: e.self_device_time_total / 1e3
                                  for e in top_dev}}
        log("profile " + json.dumps({"mix": name, **out[name]}))
        if out_dir:
            buf = io.StringIO()
            pstats.Stats(prof_py, stream=buf).sort_stats(
                "cumulative").print_stats(30)
            with open(os.path.join(out_dir, f"profile_{name}.txt"),
                      "w") as f:
                f.write(ka.table(sort_by="self_cuda_time_total",
                                 row_limit=25))
                f.write("\n\nhost (cProfile, cumulative)\n")
                f.write(buf.getvalue())
    return out


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

    # phase 2: build
    build_s = cs.build(verbose=True)
    log(f"build: {build_s:.2f} s")
    for name, out in cs.BUILD_LOG.items():
        for line in out.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    # phase 4a: build the index (started before the kernel sweep finishes
    # would compete for host cores; it is cheap to keep them apart)
    t0 = time.perf_counter()
    segs = build_shards(args.docs, 2, 1000, workers=2)
    log(f"index: 2 shards x {args.docs} docs built in "
        f"{time.perf_counter() - t0:.1f} s; capacity "
        f"{[s.capacity for s in segs]}; message L "
        f"{[s.text['message'].fwd_tids.shape[1] for s in segs]}; body "
        f"forward index {[s.text['body'].fwd_tids is not None for s in segs]}")
    if any(s.text["body"].fwd_tids is not None for s in segs):
        raise AssertionError("body must have no forward index")
    # the index's host side (ids, sources, id maps: millions of Python
    # objects) lives as long as the run; freezing it keeps the cyclic
    # collector from re-walking it on every batch, as a long-lived server
    # would
    gc.collect()
    gc.freeze()

    # phase 3: kernels at the slice's shapes
    rng = np.random.default_rng(42)
    sweep, worst = kernel_sweep(dev, rng)

    # phase 4: main path
    readers = make_readers(segs, dev)
    mixes = request_mixes(args.batch, readers)
    log("mixes: " + json.dumps({k: len(v) for k, v in mixes.items()}))
    seen, current, shims = capture_first_calls()
    with swapped_kernels(**shims):
        for name in MIXES:                       # warm-up: uploads, layouts
            current["mix"] = name
            search_merged(readers, mixes[name])
    torch.cuda.synchronize()
    sync = torch.cuda.synchronize
    stats, last, launches = run_main_path(readers, mixes, args.reps, sync)
    log("launches: " + json.dumps(launches))
    for name in MIXES:
        log("mix " + json.dumps({"mix": name, **stats[name]}))
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
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
    out_dir = args.out_dir
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    profiles = profile_mixes(readers, mixes, out_dir)

    # the card agrees with the CPU on a small index
    small = build_shards(args.small_docs, 2, 300, workers=2)
    # separate segment objects: each caches its own device columns
    on_gpu = make_readers(small, dev)
    on_cpu = make_readers([copy.copy(s) for s in small], "cpu")
    small_mix = request_mixes(48, on_cpu)
    # agg sums are differences of f32 prefix sums over the whole row
    # (ops/aggs.sorted_group_reduce); the card's parallel scan and the
    # CPU's sequential one round those prefixes differently, by an error
    # that scales with the row's total rather than the bucket's value
    # (1.0e-6 of a bucket seen on match_range_aggs), hence rtol 1e-5 here
    for name in MIXES:
        assert_close_responses(
            _strip(search_merged(on_gpu, small_mix[name])),
            _strip(search_merged(on_cpu, small_mix[name])), rtol=1e-5)
    log(f"cpu check: {args.small_docs}-doc shards agree on the card and "
        f"the CPU")

    # kernels on the main path's own inputs: K1 and K2 on the first call
    # of the run, K3 on the first call of each fused mix
    first = {}
    for name in MIXES:
        for kern, call in seen.get(name, {}).items():
            first.setdefault(kern, (name, call))
    if set(first) != set(cs.LAUNCHES):
        raise AssertionError(f"captured {sorted(first)}")
    meas = {"dense_score": measure_dense(first["dense_score"][1][0],
                                         reps=20),
            "scatter_add": measure_scatter(*first["scatter_add"][1][0],
                                           reps=20)}
    k3_err = 0.0
    for name in FUSED_MIXES:
        a, kw = seen[name]["bundle_topk"]
        m = measure_bundle(a, kw, reps=20)
        k3_err = max(k3_err, m["max_abs_err"])
        log(f"main-path inputs bundle_topk ({name}): " + json.dumps({
            "B": a[4].shape[0], "cap": a[6].shape[0],
            "clauses": [list(c) for c in a[2]], **kw, **m}))
        if name == "match":
            meas["bundle_topk"] = dict(m)
    meas["bundle_topk"]["max_abs_err"] = k3_err
    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        m = meas[name]
        mix, (a, _kw) = first[name]
        if name != "bundle_topk":
            shape = {k: list(v.shape) for k, v in zip(
                ("a0", "a1", "a2", "a3"), a) if hasattr(v, "shape")}
            log(f"main-path inputs {name} ({mix}): " + json.dumps(shape))
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": max(worst, m["max_abs_err"]),
                        "ms": m["ms"], "plain_ms": m["plain_ms"],
                        "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                        "library_ms": m["library_ms"]})
    report = {"gpu": gpu_line(), "build_s": build_s, "sweep": sweep,
              "mixes": stats, "match_fused_vs_unfused": match_ab,
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
    p.add_argument("--reps", type=int, default=5,
                   help="timed repetitions of each mix")
    p.add_argument("--small-docs", type=int, default=20_000,
                   help="docs per shard of the card-vs-CPU check")
    p.add_argument("--out-dir", default=None,
                   help="directory for the JSON report and profile tables")
    p.add_argument("--rehearse", action="store_true",
                   help="run the main path's checks on the CPU, tiny")
    args = p.parse_args(argv)
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
        return rehearse(min(args.docs, 1500), min(args.batch, 8))
    if not torch.cuda.is_available():
        print("chip_smoke: needs a CUDA device "
              "(torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    return on_card(args)


if __name__ == "__main__":
    sys.exit(main())
