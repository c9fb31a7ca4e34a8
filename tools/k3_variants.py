"""Time patched copies of the port's K3 (the fused bundle walk) against
the port's own, on the card.

Each variant is this checkout's `elasticsearch_tpu_torch/ops` copied under
the git-ignored `smoke_checkout/variants/<name>/`, with one edit of its
source, loaded beside the port's K3 (`chip_smoke.load_parent_k3`) and
timed in turns with it (port, variant, variant, port: `chip_smoke.k3_ab`)
on the kernel sweep's inputs (B 256 over 2^20 docs, two text fields of 8
slots): the dense one-clause walk at k 10 and k 100, its stepped form (8
launches of 128 tiles, k 10, the match mask on) and the `phrase_pos:2:e`
walk at k 10; and on a synthetic hybrid walk (`chip_smoke.hybrid_walk`:
B 128 over 2^19 docs, a `match` on a passage field of 64 slots and a
knn_vec clause) at k 10 and k 0.

A variant that undoes a design step (the steps are listed in the header
of `csrc/bundle_topk.cu`) must count every tile's matches as the port
does. A probe changes what is read, so its counts differ; it bounds what
a change of those reads could save:

  hot rows  a dense clause reads the forward row of doc (d mod 1,024), not
            of doc d: 64 KB of rows a field, which stay on chip, stand in
            for rows staged in shared memory;
  hot leaf  the positional leaf evaluates doc (d mod 1,024), not doc d;
  no dense terms  a dense clause compares no query term (it matches no
            doc), which leaves the hybrid walk its vector clause alone.

The sweep's docs are drawn independently, so the window's docs are like
any others, but a probe's matches need not number the port's: both hit
counts are reported, since the work follows them.

    python tools/k3_variants.py --out-dir smoke_checkout/variants/results

Prints a JSON line per (variant, walk) and writes them to
OUT_DIR/k3_variants.jsonl, beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

_KERNEL = "csrc/bundle_topk.cu"
_WRAPPER = "cuda_scoring.py"
# name -> (counts as the port's, [(file under ops/, text, replacement)])
VARIANTS = {
    "fixed doc chunks": (True, [(
        _KERNEL, "const bool steal = kPos || ck > kStealCk;",
        "const bool steal = false;")]),
    # step 3 undone for the sweep's fields of 8 slots: their rows read
    # through step 7's term tables
    "narrow rows through tables": (True, [
        (_KERNEL, "const bool held = L <= kSlots;",
         "const bool held = false;"),
        (_KERNEL, "a.L[a.clause[c][2]] <= kSlots) continue;",
         "false) continue;")]),
    "sub-chunks of 4 tiles": (True, [(
        _WRAPPER, "_BUNDLE_CHUNK_TILES = 8", "_BUNDLE_CHUNK_TILES = 4")]),
    "sub-chunks of 16 tiles": (True, [(
        _WRAPPER, "_BUNDLE_CHUNK_TILES = 8", "_BUNDLE_CHUNK_TILES = 16")]),
    "hot rows": (False, [
        (_KERNEL, "const int* tp = a.tids[f] + doc * L;",
         "const int* tp = a.tids[f] + (doc & 1023u) * L;"),
        (_KERNEL, "const float* vp = a.imps[f] + doc * L;",
         "const float* vp = a.imps[f] + (doc & 1023u) * L;")]),
    "hot leaf": (False, [(
        _KERNEL, "a.pfields, doc, sl, ml);",
        "a.pfields, doc & 1023u, sl, ml);")]),
    # the hybrid walk's two clauses, each left out in turn: a dense
    # clause that compares no term (no doc matches it), a vector clause
    # that reads no column (its matches unchanged)
    "no dense terms": (False, [(
        _KERNEL, "const int qm = a.qm;", "const int qm = 0;")]),
    "no column read": (True, [(
        _KERNEL, "sel(ex, __ldg(col + b * a.cap + doc))",
        "sel(ex, 0.5f)")]),
}
# the variants timed on each walk (default: every variant on the sweep's
# walks, the hybrid ones on the hybrid walk)
HYBRID_VARIANTS = ("no dense terms", "no column read")


def make_variant(name: str, edits, dest: Path, src: Path = ROOT) -> Path:
    """A copy of the ops of the checkout at `src` (default: this one)
    under dest/<name>/ with the edits made (each text must occur exactly
    once; a text of None: the replacement is the whole file)."""
    root = dest / name.replace(" ", "_")
    ops = root / "elasticsearch_tpu_torch" / "ops"
    if root.exists():
        shutil.rmtree(root)
    shutil.copytree(src / "elasticsearch_tpu_torch" / "ops", ops,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, old, new in edits:
        path = ops / rel
        if old is None:
            path.write_text(new)
            continue
        text = path.read_text()
        if text.count(old) != 1:
            raise ValueError(f"{name}: [{old}] occurs {text.count(old)} "
                             f"times in {rel}")
        path.write_text(text.replace(old, new))
    return root


def walks(sw) -> list[tuple[str, tuple, dict]]:
    """(label, walk arguments, walk keywords) of the timed walks on the
    sweep's inputs."""
    from elasticsearch_tpu_torch.ops.scoring import bundle_tile_bounds
    B = sw.B
    msm = sw.t(np.ones(B, np.int32))
    boost = sw.t(np.ones(B, np.float32))
    out = []
    dense = (("should", "terms_dense", "f", False),)
    phrase = (("should", "phrase_pos:2:e", "f", False),)
    chunk = (sw.cap // 1024) // chip_smoke.FORM_CHUNKS
    for label, clauses, cl, kw in (
            ("1 clause, k 10", dense, (sw.dense(3),),
             {"ck": 10, "update_thr": True, "emit_match": False}),
            ("1 clause, k 100", dense, (sw.dense(3),),
             {"ck": 100, "update_thr": True, "emit_match": False}),
            ("1 clause stepped, k 10", dense, (sw.dense(3),),
             {"ck": 10, "update_thr": True, "emit_match": True,
              "step": (chunk, None, chip_smoke._never_late)}),
            ("phrase exact n 2, k 10", phrase,
             (sw.positional("phrase_pos:2:e", "f"),),
             {"ck": 10, "update_thr": True, "emit_match": False})):
        can, ub = bundle_tile_bounds(clauses, cl, sw.text, sw.num, msm,
                                     boost)
        out.append((label, (sw.text, sw.num, clauses, cl, msm, boost,
                            sw.live, can, ub), kw))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out-dir", default="smoke_checkout/variants/results")
    p.add_argument("--variants", nargs="*", default=list(VARIANTS),
                   choices=list(VARIANTS))
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--ops", default=None,
                   help="a checkout (an earlier commit's, under "
                        "smoke_checkout/) whose K3 and its variants are "
                        "timed instead of this one's")
    p.add_argument("--walks", choices=("sweep", "hybrid", "all"),
                   default="all",
                   help="the sweep's walks (every variant but the hybrid "
                        "ones), the synthetic hybrid walk "
                        "(chip_smoke.hybrid_walk: HYBRID_VARIANTS, its "
                        "ck 0 form too), or both")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k3_variants: no CUDA device", file=sys.stderr)
        return 1
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    gpu = chip_smoke.gpu_line()
    print(gpu, flush=True)
    cs.build()
    dest = ROOT / "smoke_checkout" / "variants"
    src = Path(args.ops).resolve() if args.ops else ROOT
    roots = {n: make_variant(n, VARIANTS[n][1], dest, src)
             for n in args.variants}
    if args.ops:
        roots["base"] = src
    # one nvcc per variant, all started together
    with ThreadPoolExecutor(max_workers=len(roots)) as pool:
        mods = dict(zip(roots, pool.map(
            lambda r: chip_smoke.load_parent_k3(str(r)), roots.values())))
    # the K3 the variants are timed against: this checkout's, or --ops'
    port = mods.pop("base", cs)
    dev = torch.device("cuda")
    plan = []
    if args.walks in ("sweep", "all"):
        sw = chip_smoke.SweepInputs(dev, np.random.default_rng(42), 256,
                                    1 << 20)
        plan += [(w, [n for n in mods if n not in HYBRID_VARIANTS])
                 for w in walks(sw)]
    if args.walks in ("hybrid", "all"):
        hargs, hkw = chip_smoke.hybrid_walk(dev, np.random.default_rng(42))
        names = [n for n in mods if n in HYBRID_VARIANTS]
        plan += [(("hybrid (synthetic), k 10", hargs, hkw), names),
                 (("hybrid (synthetic), k 0", hargs,
                   {**hkw, "ck": 0, "update_thr": False}), names)]
    rows = []
    with open(out_dir / "k3_variants.jsonl", "w") as fh:
        for (label, wargs, kw), names in plan:
            for name in names:
                mod = mods[name]
                exact = VARIANTS[name][0]
                ab = chip_smoke.k3_ab(wargs, kw, mod, reps=args.reps,
                                      same_counts=exact, new=port)
                rows.append({"walk": label, "variant": name,
                             "counts_as_port": exact,
                             "port_ms": ab["new_ms"],
                             "variant_ms": ab["previous_ms"],
                             "turns": ab["turns"], "hits": ab["hits"],
                             "thresholded_tiles": ab["thresholded_tiles"],
                             "gpu": gpu})
                line = json.dumps(rows[-1])
                print("k3_variant " + line, flush=True)
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
