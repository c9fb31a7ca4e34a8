"""Hand-written Hopper kernels for the BM25 scoring hot loop.

Counterpart of `elasticsearch_tpu/ops/pallas_scoring.py`, one kernel per
Pallas kernel:

* K1 `dense_score` (csrc/dense_score.cu) replaces `_dense_kernel` /
  `score_terms_dense_pallas`: the forward-index compare+FMA
  out[b, d] = sum_q wq[b, q] * sum_l [tids[d, l] == qt[b, q]] * imps[d, l],
  the compares only for the pairs whose term signatures meet
  (`dense_candidates_ref`).
* K2 `scatter_add` (csrc/scatter_add.cu) replaces `_scatter_kernel` /
  `scatter_add_pallas`: out[b, docs[b, n]] += vals[b, n], docs outside
  [0, cap) dropped, each doc summed in ascending n (postings partitioned
  by doc bucket, each bucket summed in shared memory by one warp).
* K3 `bundle_topk` (csrc/bundle_topk.cu) replaces `_make_bundle_kernel`
  / `fused_topk_bundle_pallas` / `match_mask_bundle_pallas`: the fused
  block-max walk over a bool clause bundle (dense text clauses, numeric
  range masks, positional phrase / span / BM25F clauses, and `knn_vec`
  clauses that read a precomputed [B, cap] similarity column), per doc
  tile
  the exact match count, a prune flag, the ck best candidates (ck > 0)
  and the match mask (emit_match). Its entries are `fused_topk_bundle`,
  `match_mask_bundle` (the ck == 0 grid) and `fused_topk_dense`. A
  launch walks a span of tiles from a seeded threshold and returns its
  final one, which gives the walk's other two forms: the stepped walk
  (`bundle_walk_steps`, one launch per chunk with a host check between
  chunks, for the resident loop) and the chained walk (`init_topk` /
  `idx_offset`, a delta segment's walk seeded from its base's top-k).
* `positional_leaf` (csrc/bundle_topk.cu, leaf in
  csrc/positional_leaf.cuh): K3's positional leaf as its own entry, one
  positional clause over the whole capacity for the unfused path (the
  reference runs `ops/scoring.positional_tile_scores` there in XLA).
* `ordered_prefix` / `ordered_sum` (csrc/ordered_scan.cu) and
  `ordered_bucket_stats` (csrc/bucket_stats.cu) are no TPU kernel's
  port: the agg reduces the reference takes with XLA's `cumsum`,
  `.sum(-1)` and `.at[ids].add / .min / .max`, with XLA's exact f32
  results (plain versions in `ops/ordered.py`), for ops/aggs.
* `to_parent_fold` (csrc/block_join.cu) is no TPU kernel's port either:
  the nested query's to-parent projection, XLA's scatters
  `.at[:, target].add / .max / .min` over the [B, cap] child scores,
  each parent's indices folded in ascending order (plain version
  `ordered.parent_fold`).

Each kernel sits beside its plain PyTorch version (`*_ref`), which
repeats the kernel's arithmetic op for op. A wrapper takes the plain
version only for tensors on the CPU; for CUDA tensors it checks device,
dtype, shape and contiguity and launches the kernel or raises. `LAUNCHES`
counts kernel launches, one per launch, so a run can show that its path
went through the kernels (`BUNDLE_FORMS` splits K3's by launch form,
`SCAN_ROUTES` the scan's by route).

The kernels build at first use from the `.cu` sources beside this file
with `nvcc` for `sm_90a` (one compiler process per source, all started
together) into `_build/`, and load through ctypes with a plain C
interface; nothing is compiled or imported from a GPU toolchain when the
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from . import ordered

LAUNCHES = {"dense_score": 0, "scatter_add": 0, "bundle_topk": 0,
            "positional_leaf": 0, "ordered_prefix": 0, "ordered_sum": 0,
            "ordered_bucket_stats": 0, "to_parent_fold": 0}
# K3's launches by launch form: one chunk of a stepped walk (a span short
# of the whole grid), a seeded single launch (thr_init given: a delta
# walk chained onto its base), the plain single launch
BUNDLE_FORMS = {"single": 0, "stepped": 0, "seeded": 0}
# K3's launches that carry a knn_vec clause (a hybrid BM25+vector plan),
# by the same launch forms
BUNDLE_VEC_FORMS = {"single": 0, "stepped": 0, "seeded": 0}
# the scan's launches by route: no perm, gathers straight from the rows
# (a key sort), the doc-major copy first (a scattered perm)
SCAN_ROUTES = {"none": 0, "rows": 0, "doc_major": 0}

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent / "_build"
_SOURCES = {"dense_score": "dense_score.cu", "scatter_add": "scatter_add.cu",
            "bundle_topk": "bundle_topk.cu", "ordered_scan": "ordered_scan.cu",
            "bucket_stats": "bucket_stats.cu", "block_join": "block_join.cu"}
# entry point -> the library (source) that defines it
_ENTRIES = {"dense_score": "dense_score", "scatter_add": "scatter_add",
            "scatter_add_scratch": "scatter_add",
            "bundle_topk": "bundle_topk", "positional_leaf": "bundle_topk",
            "bundle_topk_occupancy": "bundle_topk",
            "positional_leaf_plan": "bundle_topk",
            "ordered_prefix": "ordered_scan", "ordered_sum": "ordered_scan",
            "ordered_prefix_scratch": "ordered_scan",
            "ordered_sum_scratch": "ordered_scan",
            "ordered_prefix_doc_major_scratch": "ordered_scan",
            "ordered_bucket_stats": "bucket_stats",
            "ordered_bucket_stats_scratch": "bucket_stats",
            "bucket_add_chain": "bucket_stats",
            "to_parent_fold": "block_join"}
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")
# the agg reduces and the to-parent fold flush subnormals as XLA's CPU
# runtime does
_SOURCE_FLAGS = {"ordered_scan": ("-ftz=true",),
                 "bucket_stats": ("-ftz=true",),
                 "block_join": ("-ftz=true",)}

_LIBS: dict[str, ctypes.CDLL] = {}
_BUILD_LOCK = threading.Lock()
BUILD_LOG: dict[str, str] = {}   # kernel -> compiler output of its build


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are compiled with "
                       "the CUDA toolkit's nvcc on the machine with the card")


def _lib_path(name: str) -> Path:
    """Build output of a source, keyed by the source, every header of
    csrc/ and the flags."""
    src = (_CSRC / _SOURCES[name]).read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))
    flags = (*_NVCC_FLAGS, *_SOURCE_FLAGS.get(name, ()))
    digest = hashlib.sha256(src + headers
                            + " ".join(flags).encode()).hexdigest()
    return _BUILD / f"{name}-{digest[:16]}.so"


def _bind(name: str, path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    P, I = ctypes.c_void_p, ctypes.c_int
    if name == "ordered_scan":
        lib.ordered_prefix.argtypes = [ctypes.POINTER(_ScanArgs), P]
        lib.ordered_sum.argtypes = [P, P, I, P, I, I, P]
        lib.ordered_prefix_scratch.argtypes = [I]
        lib.ordered_sum_scratch.argtypes = [I]
        for fn in (lib.ordered_prefix, lib.ordered_sum,
                   lib.ordered_prefix_scratch, lib.ordered_sum_scratch):
            fn.restype = ctypes.c_int
        dm = lib.ordered_prefix_doc_major_scratch
        dm.argtypes = [I, I]
        dm.restype = ctypes.c_longlong
        return lib
    if name == "bucket_stats":
        lib.ordered_bucket_stats.argtypes = [
            ctypes.POINTER(_BucketStatsArgs), P]
        lib.ordered_bucket_stats.restype = ctypes.c_int
        lib.ordered_bucket_stats_scratch.argtypes = [I, I, I]
        lib.ordered_bucket_stats_scratch.restype = ctypes.c_longlong
        lib.bucket_add_chain.argtypes = [P, P, P, I, P]
        lib.bucket_add_chain.restype = ctypes.c_int
        return lib
    if name == "block_join":
        lib.to_parent_fold.argtypes = [P, P, I, I, P, P, P, P, I, I, I, P]
        lib.to_parent_fold.restype = ctypes.c_int
        return lib
    fn = getattr(lib, name)
    if name == "dense_score":
        fn.argtypes = [P, P, P, P, P, I, I, I, I, P]
    elif name == "scatter_add":
        fn.argtypes = [P, P, P, ctypes.c_longlong, P, I, I, I, I, P]
        lib.scatter_add_scratch.argtypes = [I, I, I, I]
        lib.scatter_add_scratch.restype = ctypes.c_longlong
    elif name == "bundle_topk":
        fn.argtypes = [ctypes.POINTER(_BundleArgs), P]
        leaf = lib.positional_leaf
        leaf.argtypes = [ctypes.POINTER(_PosLeafArgs), P]
        leaf.restype = ctypes.c_int
        occ = lib.bundle_topk_occupancy
        occ.argtypes = [I, I, I, I, I, ctypes.POINTER(I),
                        ctypes.POINTER(I)]
        occ.restype = ctypes.c_int
        plan = lib.positional_leaf_plan
        plan.argtypes = [ctypes.POINTER(_PosLeafArgs), ctypes.POINTER(I),
                         ctypes.POINTER(I), ctypes.POINTER(I)]
        plan.restype = ctypes.c_int
    fn.restype = ctypes.c_int
    return lib


def build(verbose: bool = False) -> float:
    """Compile (where not yet built) and load every kernel; returns the
    seconds spent. One nvcc per source, all started together. With
    `verbose`, ptxas register/shared-memory reports land in BUILD_LOG."""
    with _BUILD_LOCK:
        todo = [n for n in _SOURCES if n not in _LIBS]
        if not todo:
            return 0.0
        t0 = time.perf_counter()
        _BUILD.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in todo:
            path = _lib_path(name)
            if path.exists() and not verbose:
                continue
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *_NVCC_FLAGS, *_SOURCE_FLAGS.get(name, ()),
                   *(("-Xptxas", "-v") if verbose else ()),
                   "-I", str(_CSRC), "-o", str(tmp),
                   str(_CSRC / _SOURCES[name])]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, path)
        failed = []
        for name, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            BUILD_LOG[name] = out
            if proc.returncode != 0:
                failed.append(f"{name}:\n{out}")
                continue
            os.replace(tmp, path)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for name in todo:
            _LIBS[name] = _bind(name, _lib_path(name))
        return time.perf_counter() - t0


def _fn(name: str):
    """The C entry point `name`, building its library at first use."""
    lib = _ENTRIES[name]
    if lib not in _LIBS:
        build()
    return getattr(_LIBS[lib], name)


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


# ---------------------------------------------------------------------------
# K1: forward-index (dense) scoring
# ---------------------------------------------------------------------------


def dense_score_ref(fwd_tids: torch.Tensor, fwd_imps: torch.Tensor,
                    qt: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Plain version of `dense_score`, in the kernel's (and the Pallas
    body's) op order: acc = 0; per q: hit = 0, hit += select(...) for l
    ascending, acc = acc + hit * wq. Mul and add stay separate ops."""
    B, Q = qt.shape
    cap, L = fwd_tids.shape
    zero = torch.zeros((), dtype=torch.float32, device=fwd_imps.device)
    acc = torch.zeros((B, cap), dtype=torch.float32, device=fwd_imps.device)
    for q in range(Q):
        tq = qt[:, q:q + 1]
        hit = torch.zeros((B, cap), dtype=torch.float32,
                          device=fwd_imps.device)
        for l in range(L):
            hit = hit + torch.where(fwd_tids[:, l][None, :] == tq,
                                    fwd_imps[:, l][None, :], zero)
        acc = acc + hit * wq[:, q:q + 1]
    return acc


def _sig_words(ids: torch.Tensor, on: torch.Tensor) -> list:
    """K1's 128-bit term signatures as two int64 words (bits 0-63,
    64-127) over the last axis of `ids`, from the entries where `on`:
    negative ids on bit 127, the others on the high bits of 127 times
    their 32-bit Fibonacci hash (csrc/dense_score.cu `sig_bit`)."""
    t = ids.to(torch.int64)
    h = ((t & 0xFFFFFFFF) * 0x9E3779B1) & 0xFFFFFFFF
    bit = torch.where(t < 0, 127, (h * 127) >> 32)
    words = []
    for lo in (0, 64):
        inw = on & (bit >= lo) & (bit < lo + 64)
        w = torch.where(inw, torch.ones_like(bit) << (bit - lo).clamp(0, 63),
                        0)
        acc = torch.zeros(ids.shape[:-1], dtype=torch.int64,
                          device=ids.device)
        for i in range(ids.shape[-1]):
            acc = acc | w[..., i]
        words.append(acc)
    return words


def dense_candidates_ref(fwd_tids: torch.Tensor, fwd_imps: torch.Tensor,
                         qt: torch.Tensor, wq: torch.Tensor,
                         rows: int = 16) -> torch.Tensor:
    """K1's signature filter as plain torch: bool [B, cap], True where
    the kernel scores the pair, False where it writes +0.0 without the
    compares: the doc's signature (slots whose impact is not +-0.0) and
    the row's (every query term) share no bit, in a row whose weights
    are all finite. Taken `rows` rows at a time."""
    doc_w = _sig_words(fwd_tids, fwd_imps != 0)
    row_w = _sig_words(qt, torch.ones_like(qt, dtype=torch.bool))
    wild = ~torch.isfinite(wq).all(dim=1)
    out = []
    for r in range(0, qt.shape[0], rows):
        hit = wild[r:r + rows, None].expand(-1, fwd_tids.shape[0]).clone()
        for dw, rw in zip(doc_w, row_w):
            hit |= (dw[None, :] & rw[r:r + rows, None]) != 0
        out.append(hit)
    if not out:
        return torch.zeros((0, fwd_tids.shape[0]), dtype=torch.bool,
                           device=fwd_tids.device)
    return torch.cat(out)


def dense_score(fwd_tids: torch.Tensor, fwd_imps: torch.Tensor,
                qt: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """[cap, L] forward index x [B, Q] query terms -> [B, cap] scores.
    Query term ids use -1 for padding, with weight 0."""
    if fwd_tids.device.type == "cpu":
        return dense_score_ref(fwd_tids, fwd_imps, qt, wq)
    dev = fwd_tids.device
    _check(fwd_tids, "fwd_tids", torch.int32, 2, dev)
    _check(fwd_imps, "fwd_imps", torch.float32, 2, dev)
    _check(qt, "qt", torch.int32, 2, dev)
    _check(wq, "wq", torch.float32, 2, dev)
    cap, L = fwd_tids.shape
    B, Q = qt.shape
    if fwd_imps.shape != (cap, L) or wq.shape != (B, Q):
        raise ValueError(f"shape mismatch: tids {tuple(fwd_tids.shape)}, "
                         f"imps {tuple(fwd_imps.shape)}, qt {tuple(qt.shape)},"
                         f" wq {tuple(wq.shape)}")
    out = torch.empty((B, cap), dtype=torch.float32, device=dev)
    fn = _fn("dense_score")
    err = fn(fwd_tids.data_ptr(), fwd_imps.data_ptr(), qt.data_ptr(),
             wq.data_ptr(), out.data_ptr(), B, Q, cap, L, _stream(dev))
    _raise_on(err, "dense_score")
    LAUNCHES["dense_score"] += 1
    return out


# ---------------------------------------------------------------------------
# K2: posting scatter-add
# ---------------------------------------------------------------------------


def scatter_add_ref(docs: torch.Tensor, vals: torch.Tensor,
                    cap: int) -> torch.Tensor:
    """Plain version of `scatter_add`: each doc's sum in ascending n, on
    any device. `scatter_add_` is order-free only where a pass's targets
    are unique, so postings go in passes by their occurrence rank within
    (row, doc) — pass r adds every doc's r-th posting — and out-of-range
    ids land in a sentinel column `cap` that is sliced off."""
    B, N = docs.shape
    dev = vals.device
    out = torch.zeros((B, cap + 1), dtype=torch.float32, device=dev)
    if B == 0 or N == 0:
        return out[:, :cap]
    valid = (docs >= 0) & (docs < cap)
    tgt = torch.where(valid, docs, cap).to(torch.int64)
    flat = (tgt + torch.arange(B, device=dev)[:, None] * (cap + 1)).reshape(-1)
    order = torch.sort(flat, stable=True).indices
    s = flat[order]
    pos = torch.arange(s.numel(), device=dev)
    starts = torch.where(torch.cat([torch.ones(1, dtype=torch.bool,
                                               device=dev),
                                    s[1:] != s[:-1]]), pos, 0)
    rank_sorted = pos - torch.cummax(starts, dim=0).values
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    rank = torch.where(valid.reshape(-1), rank, -1)
    flat_vals = vals.reshape(-1)
    out_flat = out.view(-1)
    for r in range(int(rank.max()) + 1):
        m = rank == r
        out_flat.scatter_add_(0, flat[m], flat_vals[m])
    return out[:, :cap]


SCATTER_BUCKET = 2048     # docs a K2 warp owns (a CTA holds 4 buckets)


def scatter_span(cap: int) -> int:
    """Docs of one K2 bucket, one warp's: SCATTER_BUCKET, fewer (a
    multiple of 4) where a row holds fewer than 4 such buckets."""
    return min(SCATTER_BUCKET, -(-cap // 16) * 4)


def scatter_add(docs: torch.Tensor, vals: torch.Tensor,
                cap: int) -> torch.Tensor:
    """scores[b, docs[b, n]] += vals[b, n] in ascending n; docs outside
    [0, cap) drop. docs int32 [B, N], vals f32 [B, N] -> f32 [B, cap]."""
    if docs.device.type == "cpu":
        return scatter_add_ref(docs, vals, cap)
    dev = docs.device
    _check(docs, "docs", torch.int32, 2, dev)
    _check(vals, "vals", torch.float32, 2, dev)
    B, N = docs.shape
    if vals.shape != (B, N):
        raise ValueError(f"vals {tuple(vals.shape)} != docs {(B, N)}")
    if B > 65535:
        raise ValueError(f"scatter_add takes at most 65535 rows, got {B}")
    span = scatter_span(cap)
    # scratch, sized by the kernel's entry: the per-(block, bucket)
    # counts, the slots they give, the postings partitioned by bucket
    nbytes = _fn("scatter_add_scratch")(B, N, cap, span)
    if nbytes < 0:
        raise ValueError(f"scatter_add cannot take B {B}, N {N}, cap {cap}")
    scratch = torch.empty((max(nbytes, 1),), dtype=torch.uint8, device=dev)
    out = torch.empty((B, cap), dtype=torch.float32, device=dev)
    err = _fn("scatter_add")(docs.data_ptr(), vals.data_ptr(),
                             scratch.data_ptr(), nbytes, out.data_ptr(), B,
                             N, cap, span, _stream(dev))
    _raise_on(err, "scatter_add")
    LAUNCHES["scatter_add"] += 1
    return out


# ---------------------------------------------------------------------------
# agg sums in XLA's order (no TPU kernel: the reference's cumsum / sum)
# ---------------------------------------------------------------------------


class _ScanArgs(ctypes.Structure):
    """Mirror of `struct ScanArgs` in csrc/ordered_scan.cu."""
    _P, _I = ctypes.c_void_p, ctypes.c_int
    _fields_ = [("w", _P), ("perm", _P), ("pos", _P), ("lev", _P),
                ("out", _P), ("B", _I), ("n", _I), ("P", _I),
                ("pos_per_row", _I), ("lev_len", _I), ("wt", _P),
                ("wt_len", ctypes.c_longlong)]


def perm_scattered(perm: torch.Tensor) -> bool:
    """Whether fewer than 90% of perm's steps ascend: a scattered order
    (a sort by a key drawn apart from the doc order, as the corpus's
    timestamps are), whose gathers each pull a 32-byte sector for one
    weight, where a key sort's runs of ascending docs share sectors.
    Found once per perm tensor (one device sync) and kept on it."""
    hit = getattr(perm, "_scattered", None)
    if hit is None:
        hit = perm.numel() > 1 and float(
            (perm[1:] > perm[:-1]).float().mean()) < 0.9
        perm._scattered = hit
    return hit


def scan_scratch(n: int) -> int:
    """Floats a row of n needs for the scan's level totals, as the scan's
    entry sizes them. On the card."""
    return _fn("ordered_prefix_scratch")(n)


def ordered_prefix(w: torch.Tensor, perm: torch.Tensor | None,
                   pos: torch.Tensor, doc_major: bool | None = None
                   ) -> torch.Tensor:
    """cs0[:, pos] of cs0 = [0, cumsum(w[:, perm])] with the cumsum in
    XLA's order (`ops/ordered.prefix_at`): w f32 [B, n], perm int32 [n]
    or None, pos int32 [P] or [B, P] in [0, n] -> f32 [B, P]. Only the
    positions are evaluated. `doc_major` (with a perm; by default where
    `perm_scattered`) first copies the weights doc-major, eight rows a
    group, so that each gather through perm reads one sector for eight
    rows."""
    if w.device.type == "cpu":
        return ordered.prefix_at(w, perm, pos)
    dev = w.device
    _check(w, "w", torch.float32, 2, dev)
    B, n = w.shape
    if perm is not None:
        _check(perm, "perm", torch.int32, 1, dev)
        if perm.shape[0] != n:
            raise ValueError(f"perm {tuple(perm.shape)} != row {n}")
    _check(pos, "pos", torch.int32, pos.dim(), dev)
    if pos.dim() not in (1, 2) or (pos.dim() == 2 and pos.shape[0] != B):
        raise ValueError(f"pos {tuple(pos.shape)} for {B} rows")
    if B > 65535:
        raise ValueError(f"ordered_prefix takes at most 65535 rows, got {B}")
    P = pos.shape[-1]
    lev_len = scan_scratch(n)
    lev = torch.empty((B, max(lev_len, 1)), dtype=torch.float32, device=dev)
    out = torch.empty((B, P), dtype=torch.float32, device=dev)
    if doc_major is None:
        doc_major = perm is not None and perm_scattered(perm)
    wt, wt_len = None, 0
    if doc_major and perm is not None:
        wt_len = _fn("ordered_prefix_doc_major_scratch")(B, n)
        wt = torch.empty((wt_len,), dtype=torch.float32, device=dev)
    a = _ScanArgs(w.data_ptr(), 0 if perm is None else perm.data_ptr(),
                  pos.data_ptr(), lev.data_ptr(), out.data_ptr(), B, n, P,
                  int(pos.dim() == 2), lev_len,
                  0 if wt is None else wt.data_ptr(), wt_len)
    err = _fn("ordered_prefix")(ctypes.byref(a), _stream(dev))
    _raise_on(err, "ordered_prefix")
    LAUNCHES["ordered_prefix"] += 1
    SCAN_ROUTES["none" if perm is None else
                "doc_major" if doc_major else "rows"] += 1
    return out


def ordered_sum(x: torch.Tensor) -> torch.Tensor:
    """x.sum(-1) of f32 rows in XLA's window-tree order
    (`ops/ordered.xla_block_sum`): x [..., n] -> [...]."""
    if x.device.type == "cpu":
        return ordered.xla_block_sum(x)
    dev = x.device
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n = x.shape[-1]
    R = x.numel() // max(n, 1)
    if n < 1:
        raise ValueError("ordered_sum needs rows of at least one value")
    scratch_len = _fn("ordered_sum_scratch")(n)
    scratch = torch.empty((max(R * scratch_len, 1),), dtype=torch.float32,
                          device=dev)
    out = torch.empty(x.shape[:-1], dtype=torch.float32, device=dev)
    err = _fn("ordered_sum")(x.data_ptr(), scratch.data_ptr(), scratch_len,
                             out.data_ptr(), R, n, _stream(dev))
    _raise_on(err, "ordered_sum")
    LAUNCHES["ordered_sum"] += 1
    return out


class _BucketStatsArgs(ctypes.Structure):
    """Mirror of `struct BucketStatsArgs` in csrc/bucket_stats.cu."""
    _P, _I = ctypes.c_void_p, ctypes.c_int
    _fields_ = [("order", _P), ("sorted_b", _P), ("starts", _P),
                ("chunk_first", _P), ("mask", _P), ("values", _P),
                ("sum", _P), ("sum_sq", _P), ("count", _P), ("min", _P),
                ("max", _P), ("scratch", _P),
                ("scratch_len", ctypes.c_longlong), ("B", _I), ("cap", _I),
                ("n_buckets", _I)]


BUCKET_STATS = ("sum", "sum_sq", "count", "min", "max")
BUCKET_TILE = 2048       # sorted positions a tile: kTile of bucket_stats.cu


def bucket_layout(bucket_ids: torch.Tensor, n_buckets: int) -> tuple:
    """The docs in bucket order for `ordered_bucket_stats`: (order, the
    bucket of each sorted position, each bucket's first position, each
    bucket's first chunk), int32. A stable sort of the wrapped ids
    (`ordered.bucket_ids_kept`: dropped ids sort last, past
    starts[n_buckets]); a chunk is a BUCKET_TILE tile's part of one
    bucket. Built once per bucket-id tensor and n_buckets, and kept on
    the tensor (every stat and value column of its calls reuses it)."""
    hit = getattr(bucket_ids, "_bucket_layout", None)
    if hit is not None and hit[0] == n_buckets:
        return hit[1]
    dev = bucket_ids.device
    ids = ordered.bucket_ids_kept(bucket_ids, n_buckets).to(torch.int32)
    sorted_b, order = torch.sort(ids, stable=True)
    starts = torch.searchsorted(
        sorted_b, torch.arange(n_buckets + 1, dtype=torch.int32,
                               device=dev)).to(torch.int32)
    s, e = starts[:-1].to(torch.int64), starts[1:].to(torch.int64)
    n_chunks = torch.where(e > s, (e - 1) // BUCKET_TILE
                           - s // BUCKET_TILE + 1, 0)
    chunk_first = torch.nn.functional.pad(torch.cumsum(n_chunks, 0),
                                          (1, 0)).to(torch.int32)
    layout = (order.to(torch.int32), sorted_b, starts, chunk_first)
    bucket_ids._bucket_layout = (n_buckets, layout)
    return layout


def ordered_bucket_stats_ref(bucket_ids: torch.Tensor, mask: torch.Tensor,
                             values: torch.Tensor, n_buckets: int,
                             stats=BUCKET_STATS) -> dict:
    """Plain version of `ordered_bucket_stats`: each stat from its plain
    reduce (`ops/ordered.py`)."""
    out = {}
    for st in stats:
        if st in ("sum", "sum_sq"):
            out[st] = ordered.bucket_fold(bucket_ids, mask, values,
                                          n_buckets, st == "sum_sq")
        elif st == "count":
            out[st] = ordered.bucket_count(bucket_ids, mask, n_buckets)
        else:
            out[st] = ordered.bucket_extreme(bucket_ids, mask, values,
                                             n_buckets, st == "max")
    return out


def ordered_bucket_stats(bucket_ids: torch.Tensor, mask: torch.Tensor,
                         values: torch.Tensor, n_buckets: int,
                         stats=BUCKET_STATS) -> dict:
    """Per-bucket stats of the matched docs' values, each the reference's
    exact f32 result: `sum` / `sum_sq` left folds from +0.0 in ascending
    doc order (`ordered.bucket_fold`), `count` an integer count as f32,
    `min` / `max` XLA's scatter min / max of where(mask, v, +-inf)
    (`ordered.bucket_extreme`). bucket_ids int32 [cap] ([-n, 0) wrapped,
    the rest out of range dropped), mask bool [B, cap], values f32 [cap]
    -> {stat: f32 [B, n_buckets]} for the stats asked."""
    stats = tuple(stats)
    bad = [st for st in stats if st not in BUCKET_STATS]
    if bad or not stats:
        raise ValueError(f"stats {stats}: each one of {BUCKET_STATS}")
    if mask.device.type == "cpu":
        return ordered_bucket_stats_ref(bucket_ids, mask, values, n_buckets,
                                        stats)
    dev = mask.device
    _check(bucket_ids, "bucket_ids", torch.int32, 1, dev)
    _check(mask, "mask", torch.bool, 2, dev)
    _check(values, "values", torch.float32, 1, dev)
    B, cap = mask.shape
    if bucket_ids.shape[0] != cap or values.shape[0] != cap:
        raise ValueError(f"bucket_ids {tuple(bucket_ids.shape)} / values "
                         f"{tuple(values.shape)} for rows of {cap}")
    out = {st: torch.empty((B, n_buckets), dtype=torch.float32, device=dev)
           for st in stats}
    if B == 0 or cap == 0 or n_buckets == 0:
        for st, t in out.items():
            t.fill_({"min": float("inf"), "max": float("-inf")}.get(st, 0.0))
        return out
    order, sorted_b, starts, chunk_first = bucket_layout(bucket_ids,
                                                         n_buckets)
    nbytes = _fn("ordered_bucket_stats_scratch")(B, cap, n_buckets)
    scratch = torch.empty((max(nbytes, 1),), dtype=torch.uint8, device=dev)
    ptr = {st: out[st].data_ptr() if st in out else 0
           for st in BUCKET_STATS}
    a = _BucketStatsArgs(order.data_ptr(), sorted_b.data_ptr(),
                         starts.data_ptr(), chunk_first.data_ptr(),
                         mask.data_ptr(), values.data_ptr(), ptr["sum"],
                         ptr["sum_sq"], ptr["count"], ptr["min"],
                         ptr["max"], scratch.data_ptr(), nbytes, B, cap,
                         n_buckets)
    err = _fn("ordered_bucket_stats")(ctypes.byref(a), _stream(dev))
    _raise_on(err, "ordered_bucket_stats")
    LAUNCHES["ordered_bucket_stats"] += 1
    return out


# ---------------------------------------------------------------------------
# The block join's to-parent fold (the nested query)
# ---------------------------------------------------------------------------


# lists longer than this go to a warp of their own
FOLD_LONG_LIST = 32


def block_join_layout(target: torch.Tensor) -> dict:
    """Each position's list for `to_parent_fold`: {"target", "starts"
    ([cap + 1]: position p's list is the rows [starts[p], starts[p +
    1]), the run of rows that ends at p or empty), "long" (the positions
    whose list is longer than "long_len", FOLD_LONG_LIST), "long_len"},
    int32 on target's device. Built once per segment at upload (the
    segment's `device_arrays()["nested"]` holds it). Raises ValueError
    where a list is not such a run: the builder lays a parent's nested
    rows out just before it and a primary row targets itself, so that
    is a broken block order."""
    t = target.to(torch.int64)
    cap = t.numel()
    ar = torch.arange(cap + 1, device=t.device)
    starts = torch.searchsorted(torch.sort(t).values, ar)
    n = starts[1:] - starts[:-1]
    # each index targets itself or a later position, and each non-empty
    # list ends at its own position: then the lists are those runs
    if not (bool(((t >= ar[:cap]) & (t < cap)).all())
            and bool(((n == 0) | (starts[1:] == ar[1:])).all())):
        raise ValueError("block join target is not in block order: some "
                         "position's rows are not the run that ends at it")
    return {"target": target.to(torch.int32),
            "starts": starts.to(torch.int32),
            "long_len": FOLD_LONG_LIST,
            "long": torch.nonzero(n > FOLD_LONG_LIST).flatten()
            .to(torch.int32)}


def to_parent_fold_ref(score: torch.Tensor, ok: torch.Tensor,
                       layout: dict, mode: str) -> tuple:
    """Plain version of `to_parent_fold` (`ordered.parent_fold`), from
    the target alone; the fold's passes are worked out once per layout
    and kept on it."""
    ranks = layout.get("_ranks")
    if ranks is None:
        t = layout["target"].to(torch.int64)
        order = torch.sort(t, stable=True).indices
        starts = torch.searchsorted(
            t[order], torch.arange(t.numel() + 1, device=t.device))
        ranks = layout["_ranks"] = ordered.parent_fold_ranks(
            layout["target"], order, starts)
    return ordered.parent_fold(score, ok, layout["target"], ranks, mode)


def to_parent_fold(score: torch.Tensor, ok: torch.Tensor, layout: dict,
                   mode: str) -> tuple:
    """The nested query's to-parent projection: per (row, position), the
    count of the matched indices that target it and, by `mode` (none /
    sum / max / min), their score's sum in ascending index order or XLA's
    max / min (`ordered.parent_fold`). score f32 [B, cap], ok bool
    [B, cap], layout `block_join_layout` -> (count f32 [B, cap], value
    f32 [B, cap] | None for "none")."""
    code = ordered.PARENT_FOLD_MODES[mode]
    if ok.device.type == "cpu":
        return to_parent_fold_ref(score, ok, layout, mode)
    dev = ok.device
    _check(score, "score", torch.float32, 2, dev)
    _check(ok, "ok", torch.bool, 2, dev)
    starts, longs = layout["starts"], layout["long"]
    _check(starts, "starts", torch.int32, 1, dev)
    _check(longs, "long", torch.int32, 1, dev)
    B, cap = ok.shape
    if score.shape != ok.shape or starts.shape[0] != cap + 1:
        raise ValueError(f"score {tuple(score.shape)} / ok "
                         f"{tuple(ok.shape)} / starts "
                         f"{tuple(starts.shape)} disagree")
    count = torch.empty((B, cap), dtype=torch.float32, device=dev)
    value = (torch.empty((B, cap), dtype=torch.float32, device=dev)
             if code else None)
    err = _fn("to_parent_fold")(
        starts.data_ptr(), longs.data_ptr() if longs.numel() else None,
        longs.numel(), layout["long_len"], score.data_ptr(), ok.data_ptr(),
        count.data_ptr(), value.data_ptr() if code else None, B, cap, code,
        _stream(dev))
    _raise_on(err, "to_parent_fold")
    LAUNCHES["to_parent_fold"] += 1
    return count, value


# ---------------------------------------------------------------------------
# K3: fused block-max bundle walk
# ---------------------------------------------------------------------------

BUNDLE_BT = 8            # query rows per block (one warp each in selection)
BUNDLE_MAX_CLAUSES = 8   # the executor's _FUSED_MAX_CLAUSES
BUNDLE_MAX_QM = 8        # widest dense clause (_DENSE_GROUP_MAX terms)
# forward slots K3 holds in registers (kSlots); a dense clause on a wider
# field reads its rows through term tables of BUNDLE_WIDE_Q query terms of
# every row of a batch tile (kWideQ)
BUNDLE_SLOTS = 8
BUNDLE_WIDE_Q = 4
# the positional clause caps (terms of a phrase / span, fields and terms
# of a BM25F clause): the executor admits no wider clause; mirrored by
# kMaxTerms / kMaxFields in csrc/positional_leaf.cuh
POS_MAX_TERMS = 8
POS_MAX_FIELDS = 4
POS_MAX_PARAMS = 512     # positional parameter ints per row (kMaxPW)
POS_MAX_PFIELDS = 8      # distinct positional fields of one bundle
# K3 runs one CTA per (batch tile x sub-chunk) work item. A sub-chunk's
# tiles are walked in order from the launch's seed threshold;
# bundle_chunk_tiles cuts a launch's tile span into sub-chunks of
# _BUNDLE_CHUNK_TILES tiles, shorter only where that would leave fewer
# than _BUNDLE_MIN_ITEMS items to share out (four times as many for a
# positional bundle, whose tiles cost as much as the rows that can match
# them: more, smaller items even out the SMs' loads). The values were
# chosen by measurement (chip_smoke --ab-parent, the sub-chunk rows;
# PERF.md, Findings)
_BUNDLE_CHUNK_TILES = 8
_BUNDLE_MIN_ITEMS = 512
_ROLES = {"must": 0, "filter": 1, "must_not": 2, "should": 3}
_KINDS = {"terms_dense": 0, "term_text": 0, "range_int": 1, "range_f32": 2}
_VEC_KIND = 8            # knn_vec (kVec of csrc/bundle_topk.cu)
# positional kinds of the descriptor table (posleaf::kPhraseExact ...)
_POS_KINDS = {("phrase_pos", "e"): 3, ("phrase_pos", "s"): 4,
              ("span_pos", "o"): 5, ("span_pos", "u"): 6}
_BM25F_KIND = 7


def _kind_code(kind: str) -> int:
    from .scoring import parse_positional_kind, positional_prefix
    if kind in _KINDS:
        return _KINDS[kind]
    if kind == "knn_vec":
        return _VEC_KIND
    head = positional_prefix(kind)
    if head is None:
        raise ValueError(f"clause kind [{kind}] has no bundle form")
    if head == "bm25f":
        return _BM25F_KIND
    return _POS_KINDS[(head, parse_positional_kind(kind)[2])]


def bundle_chunk_tiles(B: int, n_tiles: int, positional: bool = False
                       ) -> int:
    """Doc tiles walked in order by one work item of a launch over
    n_tiles tiles: at most _BUNDLE_CHUNK_TILES, fewer where the launch
    would otherwise have fewer than _BUNDLE_MIN_ITEMS (batch tile x
    sub-chunk) items, four times that for a positional bundle."""
    n_bt = -(-B // BUNDLE_BT)
    min_items = _BUNDLE_MIN_ITEMS * (4 if positional else 1)
    n_chunks = max(-(-n_tiles // _BUNDLE_CHUNK_TILES),
                   min(n_tiles, -(-min_items // n_bt)))
    return -(-n_tiles // n_chunks)


def bundle_positional(clauses: tuple) -> bool:
    """Whether a bundle has a positional clause (phrase, span, BM25F)."""
    from .scoring import positional_prefix
    return any(positional_prefix(kind) for _r, kind, _f, _w in clauses)


def bundle_occupancy(tile: int, pw: int, chunk_tiles: int, n_pos: int,
                     n_wide: int = 0) -> tuple[int, int]:
    """A K3 launch's dynamic shared memory in bytes, as the entry sizes
    it (n_wide: its wide clauses' term tables, `bundle_wide_tables`), and
    the CTAs an SM holds at that size. On the card; for reports (the walk
    does not ask)."""
    smem, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    _raise_on(_fn("bundle_topk_occupancy")(
        tile, pw, chunk_tiles, n_pos, n_wide, ctypes.byref(smem),
        ctypes.byref(per_sm)), "bundle_topk_occupancy")
    return smem.value, per_sm.value


WIDE_TABLE = 256         # entries of a wide clause's term table (kTab)
_MULT0, _MULT_STEP = 0x9E3779B1, 0x6A09E666


def _tab_entry(t: torch.Tensor, mult: int) -> torch.Tensor:
    """K3's table entry of a term (csrc/bundle_topk.cu `tab_entry`): the
    top 8 bits of the 32-bit product of the term id and `mult`."""
    return (((t.to(torch.int64) & 0xFFFFFFFF) * mult) & 0xFFFFFFFF) >> 24


def wide_tables_ref(qt: torch.Tensor, bt: int = BUNDLE_BT) -> list:
    """The term tables K3 builds for a wide dense clause, as its warp 1
    does: per batch tile of `bt` rows (rows past B as copies of the last)
    and per BUNDLE_WIDE_Q terms h, pair j = r * BUNDLE_WIDE_Q + qq (term
    h * BUNDLE_WIDE_Q + qq of row r) keyed by the first pair holding its
    term; the first multiplier (from 0x9E3779B1, steps of 0x6A09E666)
    under which the keys' entries (`_tab_entry`) all differ. Returns, per
    batch tile, per h: (mult, keys int64 [WIDE_TABLE] (term id of the
    entry), key index int64 [WIDE_TABLE] (-1: empty), each pair's key
    index [kPairs] (-1 past qm))."""
    B, qm = qt.shape
    n_pairs = bt * BUNDLE_WIDE_Q
    rows = qt.to(torch.int64).tolist()
    out = []
    for b0 in range(0, B, bt):
        tile = [rows[min(b0 + r, B - 1)] for r in range(bt)]
        tabs = []
        for h in range(-(-qm // BUNDLE_WIDE_Q)):
            key_of, first = [], {}
            for j in range(n_pairs):
                q = h * BUNDLE_WIDE_Q + j % BUNDLE_WIDE_Q
                if q >= qm:
                    key_of.append(-1)
                    continue
                key_of.append(first.setdefault(tile[j // BUNDLE_WIDE_Q][q],
                                               j))
            terms = torch.tensor(list(first), dtype=torch.int64)
            mult = _MULT0
            while True:
                e = _tab_entry(terms, mult)
                if e.unique().numel() == e.numel():
                    break
                mult = (mult + _MULT_STEP) & 0xFFFFFFFF
            keys = torch.zeros(WIDE_TABLE, dtype=torch.int64)
            index = torch.full((WIDE_TABLE,), -1, dtype=torch.int64)
            keys[e] = terms
            index[e] = torch.tensor(list(first.values()), dtype=torch.int64)
            tabs.append((mult, keys, index, torch.tensor(key_of)))
        out.append(tabs)
    return out


def dense_table_hits_ref(fwd_tids: torch.Tensor, fwd_imps: torch.Tensor,
                         qt: torch.Tensor, bt: int = BUNDLE_BT
                         ) -> torch.Tensor:
    """K3's wide dense clause as plain torch: each doc's slots, in order,
    looked up in the batch tile's term tables (`wide_tables_ref`: one
    entry a term), a slot whose term is a key adding its impact to the
    key's hit; the padded slots (id -1) in a second pass, and only for a
    doc with a padded slot whose impact is not +-0.0 (else their adds are
    of +0.0); each pair's hit its key's. f32 [B, qm, cap]; equal, bit for
    bit, to the slot-by-slot compare of the plain walk (hit + where(t ==
    tq, imp, 0) over the slots)."""
    B, qm = qt.shape
    cap, L = fwd_tids.shape
    t_all = fwd_tids.to(torch.int64)
    padded = t_all == -1
    pad = (padded & (fwd_imps != 0)).any(dim=1)
    order = [(l, ~padded[:, l]) for l in range(L)] \
        + [(l, padded[:, l] & pad) for l in range(L)]
    hits = torch.zeros((B, qm, cap), dtype=torch.float32)
    for i, tabs in enumerate(wide_tables_ref(qt, bt)):
        b0 = i * bt
        for h, (mult, keys, index, key_of) in enumerate(tabs):
            per_key = torch.zeros((bt * BUNDLE_WIDE_Q, cap),
                                  dtype=torch.float32)
            for l, looked in order:
                t = t_all[:, l]
                e = _tab_entry(t, mult)
                k = torch.where((keys[e] == t) & (index[e] >= 0) & looked,
                                index[e], -1)
                for j in index[index >= 0].tolist():
                    on = k == j
                    per_key[j] = torch.where(on, per_key[j] + fwd_imps[:, l],
                                             per_key[j])
            for r in range(min(bt, B - b0)):
                for qq in range(min(BUNDLE_WIDE_Q, qm - h * BUNDLE_WIDE_Q)):
                    hits[b0 + r, h * BUNDLE_WIDE_Q + qq] = \
                        per_key[int(key_of[r * BUNDLE_WIDE_Q + qq])]
    return hits


def bundle_wide_tables(text_cols: dict, clauses: tuple,
                       cl_inputs: tuple) -> int:
    """The term tables K3's entry builds for a bundle: a dense clause on a
    field wider than BUNDLE_SLOTS slots takes ceil(qm / BUNDLE_WIDE_Q)
    (qm: the bundle's widest dense clause)."""
    qm = _stack_bundle_inputs(clauses, cl_inputs)[0]
    wide = sum(_kind_code(kd) == 0
               and text_cols[f]["fwd_tids"].shape[1] > BUNDLE_SLOTS
               for _r, kd, f, _w in clauses)
    return wide * -(-qm // BUNDLE_WIDE_Q)


def _stack_bundle_inputs(clauses: tuple, cl_inputs: tuple):
    """Clause-stacked walk inputs: every dense clause padded to qm = the
    widest clause (tid -1 / weight 0 padding adds an exact +0.0); range
    clauses contribute their (lo, hi) pairs in clause order; positional
    clauses ride their own parameter rows (_pos_param_rows) and knn_vec
    clauses their column pointers. Returns
    (qm, qt [B, Cd*qm] i32, wq f32, msmc [B, Cd] i32, boostc f32,
    ranges ((lo [B], hi [B]), ...)); Cd may be 0."""
    from .scoring import positional_prefix
    b = cl_inputs[0][0].shape[0]
    dev = cl_inputs[0][0].device
    dense = [inp for (_r, kind, _f, _w), inp in zip(clauses, cl_inputs)
             if kind in _KINDS and _KINDS[kind] == 0]
    qm = max((inp[0].shape[1] for inp in dense), default=1)
    qts, wqs, msmcs, boostcs, ranges = [], [], [], [], []
    for (_r, kind, _f, _w), inp in zip(clauses, cl_inputs):
        if positional_prefix(kind) or kind == "knn_vec":
            continue
        if kind not in _KINDS:
            raise ValueError(f"clause kind [{kind}] has no bundle form")
        if _KINDS[kind] == 0:
            qt, wq, msm_c, boost_c = inp
            pad = qm - qt.shape[1]
            qts.append(torch.nn.functional.pad(qt, (0, pad), value=-1))
            wqs.append(torch.nn.functional.pad(wq, (0, pad)))
            msmcs.append(msm_c)
            boostcs.append(boost_c)
        else:
            ranges.append(tuple(inp))
    if not dense:
        return (qm, torch.empty((b, 0), dtype=torch.int32, device=dev),
                torch.empty((b, 0), dtype=torch.float32, device=dev),
                torch.empty((b, 0), dtype=torch.int32, device=dev),
                torch.empty((b, 0), dtype=torch.float32, device=dev),
                tuple(ranges))
    return (qm, torch.cat(qts, dim=1).to(torch.int32).contiguous(),
            torch.cat(wqs, dim=1).to(torch.float32).contiguous(),
            torch.stack(msmcs, dim=1).to(torch.int32).contiguous(),
            torch.stack(boostcs, dim=1).to(torch.float32).contiguous(),
            tuple(ranges))


def _pos_param_arrays(clauses: tuple, cl_inputs: tuple
                      ) -> tuple[list, tuple]:
    """Positional clause parameters as [B, x] columns, in clause order,
    with each column's pad value (qt pads -1, so an inert row decodes
    zero frequency; the rest pad 0). Per phrase / span clause: qt [B, n],
    wb [B, n], then idf_sum, slop, pboost, msm_c, boost_c as [B, 1]; per
    bm25f clause: qt [B, nf*nt] (field-major), idf [B, nt], wf [B, nf],
    then pboost, msm_c, boost_c."""
    from .scoring import positional_prefix
    flat: list = []
    pads: list = []

    def put(a, pad=0):
        flat.append(a)
        pads.append(pad)

    for (_r, kind, _f, _w), inp in zip(clauses, cl_inputs):
        head = positional_prefix(kind)
        if head is None:
            continue
        if head == "bm25f":
            qt, idf, wf, pb, mc, bc = inp
            put(qt.reshape(qt.shape[0], -1), -1)
            put(idf)
            put(wf)
        else:
            qt, wb, idf_sum, slop, pb, mc, bc = inp
            put(qt, -1)
            put(wb)
            put(idf_sum[:, None])
            put(slop[:, None].to(torch.int32))
        put(pb[:, None].to(torch.float32))
        put(mc[:, None].to(torch.int32))
        put(bc[:, None].to(torch.float32))
    return flat, tuple(pads)


def _pos_param_rows(clauses: tuple, cl_inputs: tuple, rows: int
                    ) -> tuple[torch.Tensor | None, list]:
    """The kernel's positional parameter rows: every column of
    _pos_param_arrays as int32 (f32 as its bits), side by side, padded to
    `rows` rows with the pad values. Returns (pp [rows, W] or None,
    per-clause column offset or None)."""
    from .scoring import positional_prefix
    flat, pads = _pos_param_arrays(clauses, cl_inputs)
    offsets, col = [], 0
    it = iter(flat)
    for _r, kind, _f, _w in clauses:
        head = positional_prefix(kind)
        if head is None:
            offsets.append(None)
            continue
        offsets.append(col)
        for _ in range(6 if head == "bm25f" else 7):
            col += next(it).shape[1]
    if not flat:
        return None, offsets
    cols = []
    for a, pad in zip(flat, pads):
        bits = (a.to(torch.float32).contiguous().view(torch.int32)
                if a.is_floating_point() else a.to(torch.int32))
        extra = rows - bits.shape[0]
        cols.append(torch.nn.functional.pad(bits, (0, 0, 0, extra),
                                            value=pad))
    return torch.cat(cols, dim=1).contiguous(), offsets


def _walk_tiles(cols: dict, fields: tuple, names: tuple, docs):
    return {f: tuple(cols[f][c][docs] for c in names) for f in fields}


def _walk_buffers(B: int, n_tiles: int, tile: int, ck: int,
                  emit_match: bool, dev: torch.device) -> tuple:
    """Full-width walk outputs at the values a tile no launch has walked
    reports: (cs -inf, ci 0) x ck, cnt 0, flags 0, match False."""
    cs = ci = match = None
    if ck > 0:
        cs = torch.full((B, n_tiles * ck), float("-inf"),
                        dtype=torch.float32, device=dev)
        ci = torch.zeros((B, n_tiles * ck), dtype=torch.int32, device=dev)
    if emit_match:
        match = torch.zeros((B, n_tiles * tile), dtype=torch.bool,
                            device=dev)
    return (cs, ci, torch.zeros((B, n_tiles), dtype=torch.int32, device=dev),
            torch.zeros((B, n_tiles), dtype=torch.int32, device=dev), match)


def bundle_walk_ref(text_cols: dict, num_cols: dict, clauses: tuple,
                    cl_inputs: tuple, msm: torch.Tensor, boost: torch.Tensor,
                    live: torch.Tensor, can: torch.Tensor, ub: torch.Tensor,
                    *, ck: int, update_thr: bool, emit_match: bool,
                    bt: int = BUNDLE_BT, chunk_tiles: int | None = None,
                    thr_init: torch.Tensor | None = None, t0: int = 0,
                    nt: int | None = None, out: tuple | None = None):
    """Plain version of the K3 walk, on any device. One launch walks the
    doc tiles [t0, t0 + nt) (default: all). Rows go in batch tiles of
    `bt`, the span's tiles in sub-chunks of `chunk_tiles` consecutive
    tiles (default `bundle_chunk_tiles`, the kernel's); each
    (batch tile, sub-chunk) walks its tiles in order with a per-row
    threshold seeded from `thr_init` [B] (None: -inf). Per (batch tile,
    doc tile):

      * no row can match -> hard skip: counts 0, flag 2, mask rows 0;
      * else the exact match count (and mask); with ck > 0, when some
        row's bound beats its threshold the ck best (score desc, lower
        doc first; -inf / 0 past the matches) with flag 0, and the
        threshold rises to the ck-th best when update_thr; otherwise
        flag 1 and no candidates.

    The sub-chunks run side by side here (step i walks tile i of every
    sub-chunk), which changes nothing: each one's state is its own.
    Outputs are full width, at their global tile columns: `out` (the
    first five outputs of an earlier launch) is written in place, else
    fresh buffers hold `_walk_buffers`' values outside the span.
    Returns (cs [B, J*ck] f32, ci [B, J*ck] i32, cnt [B, J] i32, flags
    [B, J] i32, match [B, cap] bool or None, thr [B] f32: the row max of
    the sub-chunks' final thresholds); cs/ci/thr are None at ck 0."""
    from .scoring import (VEC_CLAUSE_KINDS, bundle_num_fields,
                          bundle_pos_fields, bundle_text_fields,
                          bundle_tile_eval)
    from .topk import top_k_values
    B = msm.shape[0]
    cap = live.shape[0]
    n_tiles = can.shape[1]
    tile = cap // n_tiles
    dev = live.device
    if nt is None:
        nt = n_tiles - t0
    if chunk_tiles is None:
        chunk_tiles = bundle_chunk_tiles(B, nt, bundle_positional(clauses))
    n_chunks = -(-nt // chunk_tiles)
    n_bt = -(-B // bt)

    def per_row(x):
        """[n_bt, ...] batch-tile values -> [B, ...] row values."""
        return x.repeat_interleave(bt, dim=0)[:B]

    def tile_vote(x):
        """any over each batch tile's rows: [B, n] -> [B, n]."""
        pad = torch.zeros((n_bt * bt - B,) + tuple(x.shape[1:]),
                          dtype=torch.bool, device=dev)
        return per_row(torch.cat([x, pad]).reshape(
            (n_bt, bt) + tuple(x.shape[1:])).any(dim=1))

    cs, ci, cnt, flags, match_out = (
        out if out is not None
        else _walk_buffers(B, n_tiles, tile, ck, emit_match, dev))
    thr = None
    if ck > 0:
        thr = (torch.full((B, n_chunks), float("-inf"), dtype=torch.float32,
                          device=dev) if thr_init is None
               else thr_init.to(torch.float32)[:, None].repeat(1, n_chunks))
    for step in range(chunk_tiles):
        chunks = torch.arange(n_chunks, device=dev)
        tiles = t0 + chunks * chunk_tiles + step
        keep = tiles < t0 + nt
        chunks, tiles = chunks[keep], tiles[keep]
        nc = tiles.numel()
        docs = (tiles[:, None] * tile
                + torch.arange(tile, device=dev)[None, :]).reshape(-1)
        score, match = bundle_tile_eval(
            clauses, cl_inputs,
            _walk_tiles(text_cols, bundle_text_fields(clauses),
                        ("fwd_tids", "fwd_imps"), docs),
            _walk_tiles(num_cols, bundle_num_fields(clauses),
                        ("values", "exists"), docs),
            msm, boost, live[docs],
            pos_tiles=_walk_tiles(text_cols, bundle_pos_fields(clauses),
                                  ("fwd_pos", "k1ln", "lnorm"), docs),
            vec_tiles={ci: (inp[0][:, docs], inp[1][docs])
                       for ci, ((_r, kd, _f, _w), inp)
                       in enumerate(zip(clauses, cl_inputs))
                       if kd in VEC_CLAUSE_KINDS})
        score = score.reshape(B, nc, tile)
        can_j = can[:, tiles]                                # [B, nc]
        any_hit = tile_vote(can_j)
        match = match.reshape(B, nc, tile) & any_hit[..., None]
        cnt[:, tiles] = match.sum(dim=-1, dtype=torch.int32)
        if emit_match:
            match_out[:, docs] = match.reshape(B, nc * tile)
        if ck == 0:
            flags[:, tiles] = torch.where(any_hit, 0, 2).to(torch.int32)
            continue
        thr_j = thr[:, chunks]
        any_top = tile_vote(can_j & (ub[:, tiles] > thr_j))
        cand = torch.where(match, score, float("-inf"))
        v, p = top_k_values(cand.reshape(B * nc, tile), ck)
        v, p = v.reshape(B, nc, ck), p.reshape(B, nc, ck)
        sel = (any_hit & any_top)[..., None]
        cols = (tiles[:, None] * ck
                + torch.arange(ck, device=dev)[None, :]).reshape(-1)
        v = torch.where(sel, v, float("-inf"))
        cs[:, cols] = v.reshape(B, nc * ck)
        gid = p + (tiles * tile).to(torch.int32)[None, :, None]
        ci[:, cols] = torch.where(v > float("-inf"), gid,
                                  0).to(torch.int32).reshape(B, nc * ck)
        flags[:, tiles] = torch.where(
            ~any_hit, 2, torch.where(any_top, 0, 1)).to(torch.int32)
        if update_thr:
            thr[:, chunks] = torch.maximum(thr_j, v[..., ck - 1])
    thr_row = None if thr is None else thr.max(dim=1).values
    return cs, ci, cnt, flags, match_out, thr_row


class _PosField(ctypes.Structure):
    """Mirror of `posleaf::PosField` in csrc/positional_leaf.cuh."""
    _P, _I = ctypes.c_void_p, ctypes.c_int
    _fields_ = [("tids", _P), ("pos", _P), ("k1ln", _P), ("lnorm", _P),
                ("L", _I), ("P", _I)]


class _BundleArgs(ctypes.Structure):
    """Mirror of `struct BundleArgs` in csrc/bundle_topk.cu."""
    _P, _I = ctypes.c_void_p, ctypes.c_int
    _fields_ = [("tids", _P * 8), ("imps", _P * 8), ("L", _I * 8),
                ("vals", _P * 8), ("exists", _P * 8),
                ("pfields", _PosField * POS_MAX_PFIELDS), ("live", _P),
                ("clause", (_I * 10) * 8), ("n_clauses", _I),
                ("qt", _P), ("wq", _P), ("msmc", _P), ("boostc", _P),
                ("msm", _P), ("boost", _P), ("lo", _P), ("hi", _P),
                ("pp", _P), ("pw", _I),
                ("can", _P), ("ub", _P), ("cs", _P), ("ci", _P),
                ("cnt", _P), ("flags", _P), ("match", _P),
                ("B", _I), ("cap", _I), ("tile", _I), ("n_tiles", _I),
                ("qm", _I), ("n_dense", _I), ("n_range", _I), ("ck", _I),
                ("update_thr", _I), ("chunk_tiles", _I),
                ("emit_match", _I), ("thr_in", _P), ("thr_out", _P),
                ("t0", _I), ("nt", _I), ("n_pos", _I), ("n_sub", _I),
                ("n_wide", _I), ("wide_tab", _I * 8),
                ("vcol", _P * 8), ("vexists", _P * 8)]


class _PosLeafArgs(ctypes.Structure):
    """Mirror of `struct PosLeafArgs` in csrc/bundle_topk.cu."""
    _P, _I = ctypes.c_void_p, ctypes.c_int
    _fields_ = [("pfields", _PosField * POS_MAX_FIELDS),
                ("fidx", _I * POS_MAX_FIELDS), ("kind", _I), ("n", _I),
                ("nt", _I), ("pp", _P), ("pw", _I), ("s_out", _P),
                ("m_out", _P), ("B", _I), ("cap", _I)]


def _pos_field(col: dict, field: str, cap: int,
               dev: torch.device) -> _PosField:
    """Checked descriptor of a field's positional columns."""
    tids, pos = col["fwd_tids"], col.get("fwd_pos")
    if pos is None:
        raise ValueError(f"{field}: no positions pack")
    _check(tids, f"{field}.fwd_tids", torch.int32, 2, dev)
    _check(pos, f"{field}.fwd_pos", torch.int16, 2, dev)
    _check(col["k1ln"], f"{field}.k1ln", torch.float32, 1, dev)
    _check(col["lnorm"], f"{field}.lnorm", torch.float32, 1, dev)
    L = tids.shape[1]
    if (tids.shape[0] != cap or pos.shape[0] != cap or pos.shape[1] % L
            or col["k1ln"].shape[0] != cap or col["lnorm"].shape[0] != cap):
        raise ValueError(f"{field}: positional columns do not fit cap {cap}")
    return _PosField(tids.data_ptr(), pos.data_ptr(), col["k1ln"].data_ptr(),
                     col["lnorm"].data_ptr(), L, pos.shape[1] // L)


def _check_pos_shape(kind: str, field, inp: tuple) -> tuple[int, int]:
    """(n, nt) of a positional clause (n: terms, bm25f: fields) within
    the kernel's caps."""
    from .scoring import clause_fields, positional_prefix
    if positional_prefix(kind) == "bm25f":
        n, nt = inp[0].shape[1], inp[0].shape[2]
        if n != len(clause_fields(field)) or n > POS_MAX_FIELDS \
                or nt > POS_MAX_TERMS:
            raise ValueError(f"{kind}: takes at most {POS_MAX_FIELDS} "
                             f"fields and {POS_MAX_TERMS} terms")
        return n, nt
    n = inp[0].shape[1]
    if n > POS_MAX_TERMS:
        raise ValueError(f"{kind}: takes at most {POS_MAX_TERMS} terms")
    return n, 0


def bundle_walk(text_cols: dict, num_cols: dict, clauses: tuple,
                cl_inputs: tuple, msm: torch.Tensor, boost: torch.Tensor,
                live: torch.Tensor, can: torch.Tensor, ub: torch.Tensor, *,
                ck: int, update_thr: bool, emit_match: bool,
                thr_init: torch.Tensor | None = None, t0: int = 0,
                nt: int | None = None, out: tuple | None = None):
    """One launch of the K3 walk (csrc/bundle_topk.cu) over the doc
    tiles [t0, t0 + nt), seeded from `thr_init` [B], with
    `bundle_walk_ref`'s outputs: batch tile BUNDLE_BT, sub-chunks of
    `bundle_chunk_tiles`, the per-sub-chunk final thresholds
    folded with a row max into thr [B] (the next launch's thr_init).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise."""
    from .scoring import clause_fields
    if live.device.type == "cpu":
        return bundle_walk_ref(text_cols, num_cols, clauses, cl_inputs, msm,
                               boost, live, can, ub, ck=ck,
                               update_thr=update_thr, emit_match=emit_match,
                               thr_init=thr_init, t0=t0, nt=nt, out=out)
    dev = live.device
    B = msm.shape[0]
    cap = live.shape[0]
    n_tiles = can.shape[1]
    tile = cap // n_tiles
    if nt is None:
        nt = n_tiles - t0
    if t0 < 0 or nt <= 0 or t0 + nt > n_tiles:
        raise ValueError(f"K3 cannot walk tiles [{t0}, {t0 + nt}) of "
                         f"{n_tiles}")
    if len(clauses) > BUNDLE_MAX_CLAUSES:
        raise ValueError(f"K3 takes at most {BUNDLE_MAX_CLAUSES} clauses")
    if B > 65535 * BUNDLE_BT or n_tiles * tile != cap or tile > 1024:
        raise ValueError(f"K3 cannot walk B {B}, cap {cap}, "
                         f"{n_tiles} tiles")
    qm, qt, wq, msmc, boostc, ranges = _stack_bundle_inputs(clauses,
                                                            cl_inputs)
    if qm > BUNDLE_MAX_QM:
        raise ValueError(f"K3 takes dense clauses of at most "
                         f"{BUNDLE_MAX_QM} terms, got {qm}")
    rows = -(-B // BUNDLE_BT) * BUNDLE_BT
    pp, offsets = _pos_param_rows(clauses, cl_inputs, rows)
    pw = 0 if pp is None else pp.shape[1]
    if pw > POS_MAX_PARAMS:
        raise ValueError(f"K3 takes at most {POS_MAX_PARAMS} positional "
                         f"parameters per row, got {pw}")
    a = _BundleArgs()
    text_fields, num_fields, pos_fields, pos_clauses = [], [], [], []
    dc = ri = vi = 0
    for c, ((role, kind, field, _w), inp) in enumerate(zip(clauses,
                                                           cl_inputs)):
        code = _kind_code(kind)
        n_pos = nt_pos = 0
        if code == 0:
            if field not in text_fields:
                col = text_cols[field]
                tids, imps = col["fwd_tids"], col["fwd_imps"]
                L = tids.shape[1]
                _check(tids, f"{field}.fwd_tids", torch.int32, 2, dev)
                _check(imps, f"{field}.fwd_imps", torch.float32, 2, dev)
                if tids.shape[0] != cap or imps.shape != tids.shape:
                    raise ValueError(f"{field}: forward index "
                                     f"{tuple(tids.shape)} != cap {cap}")
                i = len(text_fields)
                a.tids[i], a.imps[i], a.L[i] = (tids.data_ptr(),
                                                imps.data_ptr(), L)
                text_fields.append(field)
            slot, fidx = dc, text_fields.index(field)
            dc += 1
        elif code in (1, 2):
            if field not in num_fields:
                col = num_cols[field]
                vals = col["values"]
                want = torch.int32 if kind == "range_int" else torch.float32
                _check(vals, f"{field}.values", want, 1, dev)
                _check(col["exists"], f"{field}.exists", torch.bool, 1, dev)
                if vals.shape[0] != cap or col["exists"].shape[0] != cap:
                    raise ValueError(f"{field}: column length != cap {cap}")
                i = len(num_fields)
                a.vals[i], a.exists[i] = (vals.data_ptr(),
                                          col["exists"].data_ptr())
                num_fields.append(field)
            slot, fidx = ri, num_fields.index(field)
            ri += 1
        elif code == _VEC_KIND:
            col, v_exists = inp[0], inp[1]
            _check(col, f"{field}.similarity", torch.float32, 2, dev)
            _check(v_exists, f"{field}.exists", torch.bool, 1, dev)
            if tuple(col.shape) != (B, cap) or v_exists.shape[0] != cap:
                raise ValueError(f"{field}: similarity column "
                                 f"{tuple(col.shape)} != {(B, cap)}")
            a.vcol[vi], a.vexists[vi] = col.data_ptr(), v_exists.data_ptr()
            slot, fidx = vi, vi
            vi += 1
        else:
            pos_clauses.append(c)
            n_pos, nt_pos = _check_pos_shape(kind, field, inp)
            for j, f in enumerate(clause_fields(field)):
                if f not in pos_fields:
                    if len(pos_fields) == POS_MAX_PFIELDS:
                        raise ValueError(f"K3 takes at most "
                                         f"{POS_MAX_PFIELDS} positional "
                                         f"fields")
                    a.pfields[len(pos_fields)] = _pos_field(
                        text_cols[f], f, cap, dev)
                    pos_fields.append(f)
                a.clause[c][6 + j] = pos_fields.index(f)
            slot, fidx = offsets[c], a.clause[c][6]
        a.clause[c][0], a.clause[c][1] = _ROLES[role], code
        a.clause[c][2], a.clause[c][3] = fidx, slot
        a.clause[c][4], a.clause[c][5] = n_pos, nt_pos
    _check(live, "live", torch.bool, 1, dev)
    msm_i = msm.to(torch.int32).contiguous()
    boost_f = boost.to(torch.float32).contiguous()
    can_b = can.to(torch.bool).contiguous()
    ub_f = ub.to(torch.float32).contiguous()
    for t, what in ((can_b, "can"), (ub_f, "ub")):
        if t.shape != (B, n_tiles) or t.device != dev:
            raise ValueError(f"{what} {tuple(t.shape)} != {(B, n_tiles)}")
    lo = hi = None
    if ranges:
        lo = torch.stack([r[0].to(torch.int32) if r[0].dtype == torch.int32
                          else r[0].to(torch.float32).view(torch.int32)
                          for r in ranges], dim=1).contiguous()
        hi = torch.stack([r[1].to(torch.int32) if r[1].dtype == torch.int32
                          else r[1].to(torch.float32).view(torch.int32)
                          for r in ranges], dim=1).contiguous()
    if out is not None:
        cs, ci, cnt, flags, match = out
        for t, what, want in ((cnt, "cnt", (B, n_tiles)),
                              (flags, "flags", (B, n_tiles)),
                              (cs, "cs", (B, n_tiles * ck) if ck else None),
                              (ci, "ci", (B, n_tiles * ck) if ck else None),
                              (match, "match",
                               (B, cap) if emit_match else None)):
            if (t is None) != (want is None) or (
                    t is not None and (tuple(t.shape) != want
                                       or t.device != dev
                                       or not t.is_contiguous())):
                raise ValueError(f"out {what} does not fit the walk")
    elif t0 == 0 and nt == n_tiles:
        cnt = torch.empty((B, n_tiles), dtype=torch.int32, device=dev)
        flags = torch.empty((B, n_tiles), dtype=torch.int32, device=dev)
        cs = ci = match = None
        if ck > 0:
            cs = torch.empty((B, n_tiles * ck), dtype=torch.float32,
                             device=dev)
            ci = torch.empty((B, n_tiles * ck), dtype=torch.int32,
                             device=dev)
        if emit_match:
            match = torch.empty((B, cap), dtype=torch.bool, device=dev)
    else:
        cs, ci, cnt, flags, match = _walk_buffers(B, n_tiles, tile, ck,
                                                  emit_match, dev)
    chunk_tiles = bundle_chunk_tiles(B, nt, bool(pos_clauses))
    thr_in = thr_out = None
    if ck > 0:
        if thr_init is not None:
            thr_in = thr_init.to(torch.float32).contiguous()
            if thr_in.shape != (B,) or thr_in.device != dev:
                raise ValueError(f"thr_init {tuple(thr_in.shape)} != {(B,)}")
        thr_out = torch.empty((B, -(-nt // chunk_tiles)),
                              dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    a.live, a.n_clauses = live.data_ptr(), len(clauses)
    a.qt, a.wq, a.msmc, a.boostc = ptr(qt), ptr(wq), ptr(msmc), ptr(boostc)
    a.msm, a.boost, a.lo, a.hi = ptr(msm_i), ptr(boost_f), ptr(lo), ptr(hi)
    a.pp, a.pw = ptr(pp), pw
    a.can, a.ub = ptr(can_b), ptr(ub_f)
    a.cs, a.ci, a.cnt, a.flags = ptr(cs), ptr(ci), ptr(cnt), ptr(flags)
    a.match = ptr(match)
    a.B, a.cap, a.tile, a.n_tiles = B, cap, tile, n_tiles
    a.qm, a.n_dense, a.n_range, a.ck = qm, dc, ri, ck
    a.update_thr, a.emit_match = int(update_thr), int(emit_match)
    a.chunk_tiles = chunk_tiles
    a.thr_in, a.thr_out = ptr(thr_in), ptr(thr_out)
    a.t0, a.nt = t0, nt
    fn = _fn("bundle_topk")
    err = fn(ctypes.byref(a), _stream(dev))
    _raise_on(err, "bundle_topk")
    LAUNCHES["bundle_topk"] += 1
    form = ("stepped" if nt < n_tiles else
            "seeded" if thr_in is not None else "single")
    BUNDLE_FORMS[form] += 1
    if vi:
        BUNDLE_VEC_FORMS[form] += 1
    thr = None if thr_out is None else thr_out.max(dim=1).values
    return cs, ci, cnt, flags, match, thr


# ---------------------------------------------------------------------------
# K3's positional leaf over the whole capacity (the unfused path)
# ---------------------------------------------------------------------------

# docs per pass of the plain version: its decode holds [B, docs, n, P]
# int32 cubes, so it walks the capacity in slices of about 2^22 (row, doc)
# pairs
_LEAF_REF_PAIRS = 1 << 22


def positional_leaf_ref(kind: str, field, inp: tuple, cols: dict
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `positional_leaf`: ops/scoring
    .positional_tile_scores over the capacity in doc slices (per doc, so
    slicing changes no number)."""
    from .scoring import clause_fields, positional_tile_scores
    fields = clause_fields(field)
    B = inp[0].shape[0]
    cap = cols[fields[0]]["fwd_tids"].shape[0]
    step = max(1024, _LEAF_REF_PAIRS // max(B, 1))
    s_parts, m_parts = [], []
    for d0 in range(0, cap, step):
        sl = slice(d0, min(cap, d0 + step))
        text = {f: (cols[f]["fwd_tids"][sl], cols[f]["fwd_imps"][sl])
                for f in fields}
        pos = {f: (cols[f]["fwd_pos"][sl], cols[f]["k1ln"][sl],
                   cols[f]["lnorm"][sl]) for f in fields}
        s, m = positional_tile_scores(kind, field, inp, text, pos)
        s_parts.append(s)
        m_parts.append(m)
    return torch.cat(s_parts, dim=1), torch.cat(m_parts, dim=1)


def positional_leaf(kind: str, field, inp: tuple, cols: dict
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One positional clause over the whole capacity -> (s_leaf [B, cap]
    f32 with the clause boost applied, m_leaf [B, cap] bool), the
    unfused path's leaf (reference eval_node's positional branch).
    `cols[f]` holds fwd_tids / fwd_imps / fwd_pos / k1ln / lnorm of each
    of the clause's fields; `inp` is the clause's bundle input tuple.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    or raise."""
    from .scoring import clause_fields
    fields = clause_fields(field)
    tids0 = cols[fields[0]]["fwd_tids"]
    if tids0.device.type == "cpu":
        return positional_leaf_ref(kind, field, inp, cols)
    dev = tids0.device
    cap = tids0.shape[0]
    B = inp[0].shape[0]
    if B > 65535:
        raise ValueError(f"positional_leaf takes at most 65535 rows, got {B}")
    n, nt = _check_pos_shape(kind, field, inp)
    clause = (("should", kind, field, False),)
    pp, _off = _pos_param_rows(clause, (inp,), B)
    a = _PosLeafArgs()
    for j, f in enumerate(fields):
        a.pfields[j] = _pos_field(cols[f], f, cap, dev)
        a.fidx[j] = j
    s_out = torch.empty((B, cap), dtype=torch.float32, device=dev)
    m_out = torch.empty((B, cap), dtype=torch.bool, device=dev)
    a.kind, a.n, a.nt = _kind_code(kind), n, nt
    a.pp, a.pw = pp.data_ptr(), pp.shape[1]
    a.s_out, a.m_out = s_out.data_ptr(), m_out.data_ptr()
    a.B, a.cap = B, cap
    fn = _fn("positional_leaf")
    err = fn(ctypes.byref(a), _stream(dev))
    _raise_on(err, "positional_leaf")
    LAUNCHES["positional_leaf"] += 1
    return s_out, m_out


def leaf_plan(kind: str, widths: list[tuple[int, int]], n: int, nt: int,
              pw: int, B: int) -> tuple[bool, int, int]:
    """The unfused leaf's launch for a clause over fields of (L, P) pack
    widths, as its entry plans it: (slot ids and pack staged, slab docs,
    dynamic shared memory in bytes), the kernel opted in. On the card;
    for tests and reports (the leaf does not ask)."""
    a = _PosLeafArgs()
    for j, (L, P) in enumerate(widths):
        a.pfields[j] = _PosField(0, 0, 0, 0, L, P)
        a.fidx[j] = j
    a.kind, a.n, a.nt, a.pw, a.B, a.cap = _kind_code(kind), n, nt, pw, B, 1
    cols, slab, smem = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    _raise_on(_fn("positional_leaf_plan")(
        ctypes.byref(a), ctypes.byref(cols), ctypes.byref(slab),
        ctypes.byref(smem)), "positional_leaf_plan")
    return bool(cols.value), slab.value, smem.value


def normalize_prune(flags: torch.Tensor, bt: int = BUNDLE_BT
                    ) -> torch.Tensor:
    """Per-(batch tile, doc tile) prune flags -> f32 [3] (hard skipped,
    thresholded, examined) in doc-tile units: averaged over batch tiles,
    so examined == n_tiles."""
    reps = flags[::bt]
    return (torch.stack([(reps == 2).sum(), (reps == 1).sum(),
                         torch.tensor(reps.numel(), device=flags.device)])
            .to(torch.float32) / reps.shape[0])


def _bundle_prep(text_cols, num_cols, clauses, cl_inputs, msm, boost):
    from .scoring import bundle_tile_bounds
    if boost is None:
        boost = torch.ones(msm.shape, dtype=torch.float32, device=msm.device)
    can, ub = bundle_tile_bounds(clauses, cl_inputs, text_cols, num_cols,
                                 msm, boost)
    return boost, can, ub


def _skip_span(out: tuple | None, B: int, n_tiles: int, tile: int, ck: int,
               emit_match: bool, dev: torch.device, t0: int, nt: int
               ) -> tuple:
    """A preempted chunk's tiles report as thresholded, with no
    candidates, counts or matches (pallas_scoring.py:863-876); the
    caller discards the whole result on timed_out anyway."""
    if out is None:
        out = _walk_buffers(B, n_tiles, tile, ck, emit_match, dev)
    cs, ci, cnt, flags, match = out
    if ck > 0:
        cs[:, t0 * ck:(t0 + nt) * ck] = float("-inf")
        ci[:, t0 * ck:(t0 + nt) * ck] = 0
    cnt[:, t0:t0 + nt] = 0
    flags[:, t0:t0 + nt] = 1
    if emit_match:
        match[:, t0 * tile:(t0 + nt) * tile] = False
    return out


def bundle_walk_steps(walk, text_cols: dict, num_cols: dict, clauses: tuple,
                      cl_inputs: tuple, msm: torch.Tensor,
                      boost: torch.Tensor, live: torch.Tensor,
                      can: torch.Tensor, ub: torch.Tensor, *, ck: int,
                      update_thr: bool, emit_match: bool, step=None,
                      thr_init: torch.Tensor | None = None, **walk_kw):
    """The driver of both launch forms (`_bundle_pallas_walk`): one
    launch of `walk` (`bundle_walk` or `bundle_walk_ref`) over every
    tile, or with `step = (chunk_tiles, st0, check)` the stepped walk
    (pallas_scoring.py:848-890): one launch per chunk of chunk_tiles
    tiles, the threshold carried from each launch into the next, all
    chunks writing one set of full-width outputs. `timed, st =
    check(c, st)` runs before chunk c, which is skipped when timed
    (`_skip_span`), and once more after the last chunk, so a deadline
    that passes during the last chunk still reports. The reference
    polls after the previous chunk's device work (io_callback), so on
    the card the driver waits on an event recorded after chunk c-1
    before it calls check(c); a check whose `sync` attribute is False
    (an infinite deadline, which can never report late) is called
    without that wait and the chunks go back to back. `walk_kw` reaches
    the plain walk (bt, chunk_tiles). Returns (cs, ci, cnt, flags,
    match, thr [B] or None, timed: None unstepped, else a bool)."""
    kw = dict(ck=ck, update_thr=update_thr, emit_match=emit_match,
              **walk_kw)
    args = (text_cols, num_cols, clauses, cl_inputs, msm, boost, live, can,
            ub)
    if ck == 0:
        thr_init = None              # the mask-only grid has no threshold
    if step is None:
        return tuple(walk(*args, thr_init=thr_init, **kw)) + (None,)
    chunk_tiles, st, check = step
    B, n_tiles = can.shape
    tile = live.shape[0] // n_tiles
    dev = live.device
    poll = dev.type == "cuda" and getattr(check, "sync", True)
    out, thr, done, timed = None, thr_init, None, False
    for c in range(-(-n_tiles // chunk_tiles)):
        t0 = c * chunk_tiles
        nt = min(chunk_tiles, n_tiles - t0)
        if done is not None:
            done.synchronize()
        timed, st = check(c, st)
        if timed:
            out = _skip_span(out, B, n_tiles, tile, ck, emit_match, dev, t0,
                             nt)
            continue
        res = walk(*args, thr_init=thr, t0=t0, nt=nt, out=out, **kw)
        out, thr = tuple(res[:5]), res[5]
        if poll:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
    if done is not None:
        done.synchronize()
    final, _st = check(-(-n_tiles // chunk_tiles), st)
    if ck > 0 and thr is None:
        thr = torch.full((B,), float("-inf"), dtype=torch.float32,
                         device=dev)
    return out + (thr, bool(timed) or bool(final))


def _fused_topk(walk, text_cols, num_cols, clauses, cl_inputs, msm, boost,
                live, k, emit_match, step=None, init_topk=None,
                idx_offset=0):
    from .scoring import bundle_primary_field
    from .topk import running_topk_merge, top_k_values
    cap = live.shape[0]
    k = min(k, cap) if init_topk is None else init_topk[0].shape[1]
    k_sel = min(k, cap)
    n_tiles = text_cols[bundle_primary_field(clauses)]["tile_max"].shape[1]
    ck = min(k_sel, cap // n_tiles)
    boost, can, ub = _bundle_prep(text_cols, num_cols, clauses, cl_inputs,
                                  msm, boost)
    cs, ci, cnt, flags, match, _thr, timed = bundle_walk_steps(
        walk, text_cols, num_cols, clauses, cl_inputs, msm, boost, live,
        can, ub, ck=ck, update_thr=(ck == k_sel), emit_match=emit_match,
        step=step,
        thr_init=None if init_topk is None else init_topk[0][:, -1])
    # tile-major strip: ties go to the lower flat index, i.e. the lower
    # tile and then the lower doc, as one top-k over [B, cap] would
    top_s, pos = top_k_values(cs, min(k_sel, cs.shape[1]))
    top_i = ci.gather(1, pos.to(torch.int64)) + idx_offset
    if init_topk is not None:
        # chain onto the earlier (base) walk's selection, its state
        # first, so base docs win ties
        top_s, top_i = running_topk_merge(init_topk[0], init_topk[1],
                                          top_s, top_i)
    out = (top_s, top_i, cnt.sum(dim=1, dtype=torch.int32),
           normalize_prune(flags))
    if emit_match:
        out = out + (match,)
    return out if timed is None else out + (timed,)


def _match_mask(walk, text_cols, num_cols, clauses, cl_inputs, msm, boost,
                live, emit_match, step=None):
    boost, can, ub = _bundle_prep(text_cols, num_cols, clauses, cl_inputs,
                                  msm, boost)
    _cs, _ci, cnt, flags, match, _thr, timed = bundle_walk_steps(
        walk, text_cols, num_cols, clauses, cl_inputs, msm, boost, live,
        can, ub, ck=0, update_thr=False, emit_match=emit_match, step=step)
    out = (cnt.sum(dim=1, dtype=torch.int32), normalize_prune(flags))
    if emit_match:
        out = out + (match,)
    return out if timed is None else out + (timed,)


def fused_topk_bundle_ref(text_cols: dict, num_cols: dict, clauses: tuple,
                          cl_inputs: tuple, msm: torch.Tensor,
                          boost: torch.Tensor | None, live: torch.Tensor,
                          k: int, emit_match: bool = False, step=None,
                          init_topk: tuple | None = None,
                          idx_offset: int = 0):
    """Plain version of `fused_topk_bundle` (the walk in torch)."""
    return _fused_topk(bundle_walk_ref, text_cols, num_cols, clauses,
                       cl_inputs, msm, boost, live, k, emit_match, step,
                       init_topk, idx_offset)


def fused_topk_bundle(text_cols: dict, num_cols: dict, clauses: tuple,
                      cl_inputs: tuple, msm: torch.Tensor,
                      boost: torch.Tensor | None, live: torch.Tensor,
                      k: int, emit_match: bool = False, step=None,
                      init_topk: tuple | None = None, idx_offset: int = 0):
    """Fused block-max score + top-k over a clause bundle (reference
    `fused_topk_bundle_pallas`). Returns (top_s [B, k], top_i [B, k],
    total [B] i32, prune_stats f32 [3] = (hard, thresholded, examined)
    in doc-tile units) plus the match mask [B, cap] bool when
    emit_match, plus timed_out (bool) when a `step` is given (the
    stepped walk of `bundle_walk_steps`). Entries past a row's total are
    -inf with undefined ids. `init_topk` = (scores [B, k], ids [B, k])
    chains this walk onto an earlier one (the base of a base + delta
    pair): k is its width, its k-th best seeds the threshold, this
    walk's ids are offset by `idx_offset` and merged after it. CPU
    tensors take the plain version."""
    if live.device.type == "cpu":
        return fused_topk_bundle_ref(text_cols, num_cols, clauses,
                                     cl_inputs, msm, boost, live, k,
                                     emit_match, step, init_topk,
                                     idx_offset)
    return _fused_topk(bundle_walk, text_cols, num_cols, clauses,
                       cl_inputs, msm, boost, live, k, emit_match, step,
                       init_topk, idx_offset)


def match_mask_bundle_ref(text_cols: dict, num_cols: dict, clauses: tuple,
                          cl_inputs: tuple, msm: torch.Tensor,
                          boost: torch.Tensor | None, live: torch.Tensor,
                          emit_match: bool = True, step=None):
    """Plain version of `match_mask_bundle`."""
    return _match_mask(bundle_walk_ref, text_cols, num_cols, clauses,
                       cl_inputs, msm, boost, live, emit_match, step)


def match_mask_bundle(text_cols: dict, num_cols: dict, clauses: tuple,
                      cl_inputs: tuple, msm: torch.Tensor,
                      boost: torch.Tensor | None, live: torch.Tensor,
                      emit_match: bool = True, step=None):
    """The mask-only k == 0 grid (reference `match_mask_bundle_pallas`):
    the ck == 0 build of K3, exact counts and, when emit_match, the
    match mask, with msm-aware hard skips and no selection. Returns
    (total [B], prune_stats f32 [3]) (+ match [B, cap] bool) (+
    timed_out when stepped). CPU tensors take the plain version."""
    if live.device.type == "cpu":
        return match_mask_bundle_ref(text_cols, num_cols, clauses,
                                     cl_inputs, msm, boost, live,
                                     emit_match, step)
    return _match_mask(bundle_walk, text_cols, num_cols, clauses, cl_inputs,
                       msm, boost, live, emit_match, step)


def fused_topk_dense(fwd_tids: torch.Tensor, fwd_imps: torch.Tensor,
                     tile_max: torch.Tensor, qt: torch.Tensor,
                     wq: torch.Tensor, live: torch.Tensor, k: int,
                     msm: torch.Tensor | None = None,
                     boost: torch.Tensor | None = None):
    """Single-dense-clause entry: one should clause, the enclosing bool's
    msm/boost as the outer params."""
    b = qt.shape[0]
    if msm is None:
        msm = torch.ones((b,), dtype=torch.int32, device=qt.device)
    clauses = (("should", "terms_dense", "f", False),)
    cl_inputs = ((qt, wq, torch.ones((b,), dtype=torch.int32,
                                     device=qt.device),
                  torch.ones((b,), dtype=torch.float32, device=qt.device)),)
    text_cols = {"f": {"fwd_tids": fwd_tids, "fwd_imps": fwd_imps,
                       "tile_max": tile_max}}
    return fused_topk_bundle(text_cols, {}, clauses, cl_inputs, msm, boost,
                             live, k)
