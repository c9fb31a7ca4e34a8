"""Time patched copies of the port's K2 (`scatter_add`) and unfused
positional leaf against the port's own, on the main path's own calls, on
the card.

Each variant is this checkout's `elasticsearch_tpu_torch/ops` copied under
the git-ignored `smoke_checkout/variants/<name>/` with one edit
(`k3_variants.make_variant`), loaded beside the port's kernels
(`chip_smoke.load_parent_k3`) and timed in turns with them (port,
variant, variant, port: `chip_smoke.ab_turns`) on the first call each
kernel gets in chip_smoke's mixes over two 2^20-doc shards: K2 on the
`prefix` and `term_body` mixes, the leaf on `phrase_filter`; K2 also on
the kernel sweep's rows of random 128-doc blocks (rare terms) and of ten
terms' sorted lists.

  K2 chunk ranges, warp buckets   K2 without its partition
                   (`tools/k2_direct.cu`): per 128-posting chunk its doc
                   range, which each 2,048-doc bucket's warp filters 32
                   chunks at a time by ballot;
  K2 chunk ranges, CTA spans      the same with a CTA owning 16,384 docs
                   (`tools/k2_spans.cu`), a chunk whose docs ascend added
                   by 4 warps at once, a barrier per chunk;
  (the K2 variants' outputs must equal the port's)
  leaf without decode    probe: the leaf's second pass (the pairs whose
                   doc holds every term, decoded) skipped;
  leaf staging only      probe: both passes skipped (the slab's staging
                   and per-doc tables alone).

A probe's outputs are not the port's; its time bounds what its skipped
part costs. Each K2 call also reports the share of its 128-posting blocks
whose in-range docs span more than one bucket (`scatter_span` docs), the
postings that the partition serves and the chunk ranges read again.

    python tools/unfused_variants.py --out-dir chiprun_out/unfused

Prints a JSON line per (call, variant) and writes them to
OUT_DIR/unfused_variants.jsonl, beside the card's name and power limit.
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

_KERNEL = "csrc/bundle_topk.cu"
# name -> (kernel, outputs equal the port's, [(file under ops/, text,
# replacement)])
VARIANTS = {
    "K2 chunk ranges, warp buckets": ("scatter_add", True, [(
        "csrc/scatter_add.cu", None,
        (ROOT / "tools" / "k2_direct.cu").read_text())]),
    "K2 chunk ranges, CTA spans": ("scatter_add", True, [(
        "csrc/scatter_add.cu", None,
        (ROOT / "tools" / "k2_spans.cu").read_text())]),
    "leaf without decode": ("positional_leaf", False, [(
        _KERNEL, "const int qn = s_qn;", "const int qn = 0;")]),
    "leaf staging only": ("positional_leaf", False, [(
        _KERNEL, "for (int item = warp; item < np * groups;",
        "for (int item = warp; item < 0;")]),
}
CALLS = (("prefix", "scatter_add"), ("term_body", "scatter_add"),
         ("phrase_filter", "positional_leaf"))


def spanning_blocks(docs, cap: int) -> dict:
    """Of a K2 call's 128-posting blocks with an in-range doc: the share
    whose docs span more than one bucket, and the mean buckets a block
    meets."""
    import torch
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    sub = cs.scatter_span(cap)
    B, N = docs.shape
    pad = -N % 128
    d = torch.nn.functional.pad(docs, (0, pad), value=-1).view(B, -1, 128)
    ok = (d >= 0) & (d < cap)
    lo = torch.where(ok, d, cap).min(-1).values
    hi = torch.where(ok, d, -1).max(-1).values
    has = ok.any(-1)
    meets = (hi // sub - lo // sub + 1)[has].float()
    return {"blocks": int(has.sum()), "bucket_docs": sub,
            "share_spanning": float((meets > 1).float().mean()),
            "mean_buckets_met": float(meets.mean())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out-dir", default="smoke_checkout/variants/results")
    p.add_argument("--docs", type=int, default=1 << 20)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--variants", nargs="*", default=list(VARIANTS),
                   choices=list(VARIANTS))
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("unfused_variants: no CUDA device", file=sys.stderr)
        return 1
    from elasticsearch_tpu_torch.ops import cuda_scoring as cs
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    gpu = chip_smoke.gpu_line()
    print(gpu, flush=True)
    dev = torch.device("cuda")
    cs.build()
    dest = ROOT / "smoke_checkout" / "variants"
    roots = {n: k3_variants.make_variant(n, VARIANTS[n][2], dest)
             for n in args.variants}
    kernels = {VARIANTS[n][0] for n in args.variants}
    # one nvcc per source of each copy, all started together
    with ThreadPoolExecutor(max_workers=len(roots)) as pool:
        mods = dict(zip(roots, pool.map(
            lambda r: chip_smoke.load_parent_k3(str(r)), roots.values())))
    segs = chip_smoke.build_shards(args.docs, 2, 1000, workers=2)
    readers = chip_smoke.make_readers(segs, dev)
    mixes = chip_smoke.request_mixes(args.batch, readers, args.docs)
    seen, current, shims = chip_smoke.capture_first_calls()
    with chip_smoke.swapped_kernels(**shims):
        for mix in dict(CALLS):
            current["mix"] = mix
            chip_smoke.search_merged(readers, mixes[mix])
    torch.cuda.synchronize()
    calls = [(mix, kernel, seen[mix][kernel][0]) for mix, kernel in CALLS
             if kernel in kernels]
    rng = np.random.default_rng(42)
    cap = 1 << 20
    sweep = (("sweep: B 128 x 2048 random blocks",
              lambda: chip_smoke.synthetic_postings(rng, 128, 2048, cap)),
             ("sweep: B 128 x 262,144, 10 terms' sorted lists",
              lambda: chip_smoke.term_postings(rng, 128, 2048 * 128, cap)))
    for label, make in sweep if "scatter_add" in kernels else ():
        docs, vals = make()
        calls.append((label, "scatter_add",
                      (torch.from_numpy(docs).to(dev),
                       torch.from_numpy(vals).to(dev), cap)))
    with open(out_dir / "unfused_variants.jsonl", "w") as fh:
        for where, kernel, a in calls:
            port = getattr(cs, kernel)
            want = port(*a)
            info = (spanning_blocks(a[0], a[2]) if kernel == "scatter_add"
                    else {"kind": a[0], "B": a[2][0].shape[0],
                          "decode_share": chip_smoke.leaf_decode_share(*a)})
            for name, mod in mods.items():
                vk, exact, _edits = VARIANTS[name]
                if vk != kernel:
                    continue
                var = getattr(mod, kernel)
                if exact:
                    got = var(*a)
                    if not torch.equal(got, want):
                        raise AssertionError(f"{name} != the port at {where}")
                ab = chip_smoke.ab_turns(lambda: port(*a), lambda: var(*a),
                                         args.reps)
                row = {"call": where, "kernel": kernel, "variant": name,
                       "outputs_as_port": exact, "port_ms": ab["new_ms"],
                       "variant_ms": ab["previous_ms"], "turns": ab["turns"],
                       **info, "gpu": gpu}
                line = json.dumps(row)
                print("unfused_variant " + line, flush=True)
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
