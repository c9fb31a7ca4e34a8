"""Time the node path (`node.msearch`) against the engines' own readers on
the card, in two checkouts: this one and an earlier commit's.

Each checkout gets a process of its own (the checkout's packages and its
`chip_smoke.py` helpers on `sys.path`), which builds chip_smoke's node
path as chip_smoke does: 2 shards of `--docs` docs ingested through
`node.bulk` (this checkout's node durable, `path.data` under the
git-ignored `smoke_data/` and the `async` translog, as chip_smoke's; a
checkout whose `Node` refuses `path.data` runs without), one refresh
that compacts each shard, `gc.freeze()`, a `--delta-docs` delta a shard
and its refresh. Then, for each mix of `--mixes`, after a warm-up, in
turns (node, readers, readers, node) the mix's requests in chip_smoke's
msearch batches, each timed to a `torch.cuda.synchronize()`, with the
cyclic collector's passes and seconds during each batch (`gc.callbacks`).
One batch of the first mix each way also runs under cProfile (the 30
costliest functions by own time, written to
OUT_DIR/<tag>_<mix>_<way>.prof.txt).

    mkdir -p smoke_checkout/prev && git archive <commit> | tar -x -C smoke_checkout/prev
    python tools/node_ab.py --parent smoke_checkout/prev --out-dir OUT_DIR

Prints a JSON line per (checkout, mix) and writes them to
OUT_DIR/node_ab.jsonl, beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIXES = ("phrase_slop_aggs", "match_range_aggs", "count_match", "phrase")


class _GcClock:
    """The collector's passes per generation and their seconds, while on."""

    def __init__(self):
        self.passes = [0, 0, 0]
        self.s = 0.0
        self._t0 = None
        self.on = False

    def __call__(self, phase, info):
        if not self.on:
            return
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            self.s += time.perf_counter() - self._t0
            self.passes[info["generation"]] += 1
            self._t0 = None

    def reset(self):
        self.passes = [0, 0, 0]
        self.s = 0.0


def worker(tree: str, tag: str, args) -> None:
    import cProfile
    import gc
    import io
    import pstats
    import shutil
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch
    import chip_smoke as cs
    from elasticsearch_tpu_torch import corpus
    from elasticsearch_tpu_torch.node import Node
    sync = (torch.cuda.synchronize if args.device == "cuda"
            else (lambda: None))
    data = os.path.join(tree, "smoke_data", f"node_ab-{os.getpid()}")
    shutil.rmtree(data, ignore_errors=True)
    settings = {"node.name": "node-ab", "path.data": data,
                "index.translog.durability": "async"}
    try:
        node = Node(settings, device=args.device)
        durable = True
    except NotImplementedError:
        node = Node({"node.name": "node-ab"}, device=args.device)
        durable = False
    try:
        node.create_index("logs", {"number_of_shards": 2,
                                   "number_of_replicas": 0,
                                   "index.streaming.delta": True},
                          corpus.MAPPING)
        keys = cs.routing_keys(2)
        t0 = time.perf_counter()
        for s in range(2):
            docs = list(corpus.make_docs(args.docs, seed=42 + s,
                                         start=s * args.docs,
                                         long_every=1000))
            for i in range(0, len(docs), cs.NODE_WRITE_BATCH):
                r = node.bulk(cs._bulk_ops(docs[i:i + cs.NODE_WRITE_BATCH],
                                           keys[s]))
                if r["errors"]:
                    raise AssertionError("node.bulk failed")
            del docs
        ingest_s = time.perf_counter() - t0
        node.refresh("logs")
        gc.collect()
        gc.freeze()
        for s in range(2):
            extra = list(corpus.make_docs(
                args.delta_docs, seed=242 + s,
                start=2 * args.docs + s * args.delta_docs, long_every=1000))
            node.bulk(cs._bulk_ops(extra, keys[s]))
        node.refresh("logs")
        readers = cs.node_readers(node)
        mixes = cs.node_mixes(args.batch, readers, args.docs)
        clock = _GcClock()
        gc.callbacks.append(clock)

        def timed(fn):
            clock.reset()
            clock.on = True
            t1 = time.perf_counter()
            fn()
            sync()
            ms = (time.perf_counter() - t1) * 1e3
            clock.on = False
            return {"ms": ms, "gc_passes": list(clock.passes),
                    "gc_ms": clock.s * 1e3}

        for n, name in enumerate(args.mixes.split(",")):
            bodies = mixes[name]
            batch = cs.NODE_BATCH.get(name)
            by_node = lambda: cs.node_search(node, bodies, batch)  # noqa: E731
            by_readers = lambda: cs.time_mix(  # noqa: E731
                readers, bodies, 1, lambda: None, batch=batch)
            by_node()
            by_readers()
            sync()
            turns = {"node": [], "readers": []}
            for way in ("node", "readers", "readers", "node",
                        "node", "readers"):
                turns[way].append(timed(by_node if way == "node"
                                        else by_readers))
            if n == 0:
                for way, fn in (("node", by_node), ("readers", by_readers)):
                    prof = cProfile.Profile()
                    prof.enable()
                    fn()
                    sync()
                    prof.disable()
                    text = io.StringIO()
                    pstats.Stats(prof, stream=text).sort_stats(
                        "tottime").print_stats(30)
                    with open(os.path.join(
                            args.out_dir, f"{tag}_{name}_{way}.prof.txt"),
                            "w") as f:
                        f.write(text.getvalue())
            line = {"checkout": tag, "durable": durable, "mix": name,
                    "requests": len(bodies),
                    "msearch_batch": batch or len(bodies),
                    "docs": args.docs, "delta_docs": args.delta_docs,
                    "ingest_docs_per_s": 2 * args.docs / ingest_s,
                    **{f"{way}_ms": [t["ms"] for t in ts]
                       for way, ts in turns.items()},
                    **{f"{way}_gc": [[t["gc_passes"], t["gc_ms"]] for t in ts]
                       for way, ts in turns.items()},
                    "gpu": (cs.gpu_line() if args.device == "cuda"
                            else "cpu")}
            print(json.dumps(line), flush=True)
    finally:
        node.close()
        shutil.rmtree(data, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--parent", required=True,
                   help="a copy of the earlier commit's checkout")
    p.add_argument("--docs", type=int, default=1 << 20)
    p.add_argument("--delta-docs", type=int, default=1 << 17)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--mixes", default=",".join(MIXES))
    p.add_argument("--out-dir", required=True,
                   help="where the JSON lines and cProfile tables go")
    p.add_argument("--device", default="cuda",
                   help="cpu: a rehearsal at a toy size")
    p.add_argument("--worker", nargs=2, metavar=("TREE", "TAG"),
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    args.out_dir = os.path.abspath(args.out_dir)
    os.makedirs(args.out_dir, exist_ok=True)
    if args.worker:
        worker(os.path.abspath(args.worker[0]), args.worker[1], args)
        return 0
    rc = 0
    with open(os.path.join(args.out_dir, "node_ab.jsonl"), "w") as out:
        for tree, tag in ((os.path.abspath(args.parent), "parent"),
                          (HERE, "change")):
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--worker", tree, tag, "--parent", args.parent,
                 "--docs", str(args.docs),
                 "--delta-docs", str(args.delta_docs),
                 "--batch", str(args.batch), "--mixes", args.mixes,
                 "--out-dir", args.out_dir, "--device", args.device],
                stdout=subprocess.PIPE, text=True)
            for line in proc.stdout.splitlines():
                print(line, flush=True)
                out.write(line + "\n")
            rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
