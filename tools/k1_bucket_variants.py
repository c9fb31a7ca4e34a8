"""Time patched copies of the port's K1 (`dense_score`) and bucket stats
(`ordered_bucket_stats`) against the port's own, on the card.

Each variant is this checkout's `elasticsearch_tpu_torch/ops` copied under
the git-ignored `smoke_checkout/variants/<name>/` with its edits
(`k3_variants.make_variant`; only the two kernels' sources are built),
loaded beside the port's kernels (`chip_smoke.load_parent_k3`) and timed
in turns with them (port, variant, variant, port: `chip_smoke.ab_turns`)
on chip_smoke's sweep inputs: K1 at B 256 over 2^20 docs of 8 slots
(term ids from 4,000: Q 1 and 3; from 24: Q 4), the bucket stats over
2^20 docs of the `status` column (three buckets, B 128), 1,000 buckets
(B 256) and one bucket (B 1), every stat asked and the sum alone.

Every variant here is a probe: it skips or changes a part, so its outputs
are not the port's, and its time bounds what that part costs:

  K1 no stores          the output rows are not written;
  K1 no scoring         every pair is written +0.0 (staging, signatures
                        and stores alone);
  K1 no staging         the forward rows read from device memory at every
                        L (outputs equal the port's);
  bucket compact only   the fold kernel is not launched;
  bucket no min / max   the count's warp reads no values (no min / max
                        keys);
  bucket sum adds only  the sum's warp adds 1.0 a value, from no memory;
  bucket squares adds only  the same for the squares' warp;
  bucket <role> warp alone  the other roles made trivial (adds of 1.0 from
                        no memory, no min / max keys): that warp's time;
  bucket scalar fold    the sum's fold a plain loop over the ring (outputs
                        equal the port's);
  bucket four pieces ahead, bucket pieces of 1,024  the fold's feed deeper
                        (outputs equal the port's);
  bucket fold no loads  the fold warps load no values (they add zeros).

    python tools/k1_bucket_variants.py --out-dir smoke_checkout/variants/results

Prints a JSON line per (variant, input) and writes them to
OUT_DIR/k1_bucket_variants.jsonl, beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402
import k3_variants  # noqa: E402

_K1 = "csrc/dense_score.cu"
_BK = "csrc/bucket_stats.cu"
# build only the two kernels' sources in a variant
_ONLY_TWO = ("cuda_scoring.py",
             '"scatter_add": "scatter_add.cu",\n'
             '            "bundle_topk": "bundle_topk.cu", '
             '"ordered_scan": "ordered_scan.cu",\n            ', "")
# a fold warp's adds of 1.0 a value from no memory; the count's warp
# reading no values
_SUM_ADDS = (_BK, "        fold_piece(my_ring[u & 1], n_cur, sum);",
             "        for (int k = 0; k < n_cur; ++k) "
             "sum = __fadd_rn(sum, 1.0f);")
_SQ_ADDS = (_BK, "fold_piece_sq(my_ring[u & 1], n_cur, sum);",
            "for (int k = 0; k < n_cur; ++k) sum = __fadd_rn(sum, 1.0f);")
_NO_KEYS = (_BK, "const bool keys = a.min != nullptr || a.max != nullptr;",
            "const bool keys = false;")
# name -> (kernel, outputs equal the port's, [(file, text, replacement)])
VARIANTS = {
    "K1 no stores": ("dense_score", False, [(
        _K1, "      if (rl + j >= nr) continue;\n        float* orow",
        "      if (true) continue;\n        float* orow")]),
    "K1 no scoring": ("dense_score", False, [(
        _K1, "const int n = __reduce_add_sync(~0u, __popc(cand));",
        "const int n = 0 * __reduce_add_sync(~0u, __popc(cand));")]),
    "K1 no staging": ("dense_score", True, [(
        _K1, "return L <= kMaxStagedL", "return L < 0")]),
    "bucket compact only": ("ordered_bucket_stats", False, [(
        _BK, "  fold_kernel<<<", "  if (0) fold_kernel<<<")]),
    "bucket no min / max": ("ordered_bucket_stats", False, [(
        _BK, "const bool keys = a.min != nullptr || a.max != nullptr;",
        "const bool keys = false;")]),
    "bucket sum adds only": ("ordered_bucket_stats", False, [(
        _BK, "        fold_piece(my_ring[u & 1], n_cur, sum);",
        "        for (int k = 0; k < n_cur; ++k) sum = __fadd_rn(sum, 1.0f);")]),
    "bucket squares adds only": ("ordered_bucket_stats", False, [(
        _BK, "fold_piece_sq(my_ring[u & 1], n_cur, sum);",
        "for (int k = 0; k < n_cur; ++k) sum = __fadd_rn(sum, 1.0f);")]),
    "bucket sum warp alone": ("ordered_bucket_stats", False, [
        _SQ_ADDS, _NO_KEYS]),
    "bucket squares warp alone": ("ordered_bucket_stats", False, [
        _SUM_ADDS, _NO_KEYS]),
    "bucket count warp alone": ("ordered_bucket_stats", False, [
        _SUM_ADDS, _SQ_ADDS]),
    "bucket scalar fold": ("ordered_bucket_stats", True, [(
        _BK, "        fold_piece(my_ring[u & 1], n_cur, sum);",
        "        for (int k = 0; k < n_cur; ++k) "
        "sum = __fadd_rn(sum, my_ring[u & 1][k]);")]),
    "bucket four pieces ahead": ("ordered_bucket_stats", True, [(
        _BK, "constexpr int kAhead = 2;", "constexpr int kAhead = 4;")]),
    "bucket pieces of 1,024": ("ordered_bucket_stats", True, [(
        _BK, "constexpr int kPiece = 512;", "constexpr int kPiece = 1024;")]),
    "bucket fold no loads": ("ordered_bucket_stats", False, [(
        _BK, "st[r] = k < n ? __ldg(vrow + from + k) : 0.0f;",
        "st[r] = 0.0f;")]),
}


def inputs(dev, rng):
    """(label, kernel, args) of the timed calls."""
    import torch
    from elasticsearch_tpu_torch import corpus
    out = []
    B, cap = 256, 1 << 20
    for n_terms, Qs in ((4000, (1, 3)), (24, (4,))):
        tids = rng.integers(-1, n_terms, size=(cap, 8)).astype(np.int32)
        imps = rng.random((cap, 8), dtype=np.float32) * 5
        imps[tids < 0] = 0
        for Q in Qs:
            qt = rng.integers(-1, n_terms, size=(B, Q)).astype(np.int32)
            qt[:, 0] = tids[rng.integers(0, cap, size=B), 0]
            wq = rng.random((B, Q), dtype=np.float32) * 3
            wq[qt < 0] = 0
            out.append((f"K1 L 8 Q {Q}, {n_terms} terms", "dense_score",
                        tuple(torch.from_numpy(a).to(dev)
                              for a in (tids, imps, qt, wq))))
    status = rng.integers(0, len(corpus.STATUS), size=cap)
    ords = np.array([sorted(set(corpus.STATUS)).index(corpus.STATUS[i])
                     for i in range(len(corpus.STATUS))])[status]
    size = torch.from_numpy(rng.integers(100, 100_001, size=cap)
                            .astype(np.float32)).to(dev)
    lo = torch.from_numpy(rng.integers(100, 60_000, size=(B, 1))
                          .astype(np.float32)).to(dev)
    ok = (size[None, :] >= lo) & (size[None, :] <= lo + 40_000)
    stats = ("sum", "sum_sq", "count", "min", "max")
    for label, ids, n_b, rows in (
            ("status", ords, 3, 128),
            ("1,000 buckets", rng.integers(-5, 1005, size=cap), 1000, 256),
            ("one bucket", np.zeros(cap), 1, 1)):
        for st in (stats, ("sum",)):
            out.append((f"bucket stats, {label}, {len(st)} stats",
                        "ordered_bucket_stats",
                        (torch.from_numpy(ids.astype(np.int32)).to(dev),
                         ok[:rows].contiguous(), size, n_b, st)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out-dir", default="smoke_checkout/variants/results")
    p.add_argument("--reps", type=int, default=8)
    p.add_argument("--only", default="",
                   help="run the variants whose name starts with this")
    args = p.parse_args(argv)
    import torch
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    if not torch.cuda.is_available():
        print("k1_bucket_variants: needs a CUDA device", file=sys.stderr)
        return 1
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    gpu = chip_smoke.gpu_line()
    print(f"gpu: {gpu}", flush=True)
    cs.build()
    dest = ROOT / "smoke_checkout" / "variants"
    chosen = {k: v for k, v in VARIANTS.items() if k.startswith(args.only)}
    roots = {name: k3_variants.make_variant(name, [_ONLY_TWO, *edits], dest)
             for name, (_k, _same, edits) in chosen.items()}
    with ThreadPoolExecutor(len(roots)) as pool:
        mods = dict(zip(roots, pool.map(
            lambda r: chip_smoke.load_parent_k3(str(r)), roots.values())))
    dev = torch.device("cuda")
    calls = inputs(dev, np.random.default_rng(42))
    lines = []
    for name, (kernel, same, _edits) in chosen.items():
        var = getattr(mods[name], kernel)
        for label, k, a in calls:
            if k != kernel:
                continue
            port = getattr(cs, kernel)
            if same:
                got, want = var(*a), port(*a)
                if isinstance(got, dict):
                    got, want = torch.stack(list(got.values())), \
                        torch.stack(list(want.values()))
                if not torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)):
                    raise AssertionError(f"{name} != the port on {label}")
            t = chip_smoke.ab_turns(lambda: var(*a), lambda: port(*a),
                                    args.reps)
            line = {"variant": name, "call": label, "port_ms": t["previous_ms"],
                    "variant_ms": t["new_ms"], "turns": t["turns"], "gpu": gpu}
            print(json.dumps(line), flush=True)
            lines.append(line)
    with open(out_dir / "k1_bucket_variants.jsonl", "w") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
