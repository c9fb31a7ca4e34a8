"""IVF coarse quantization for dense_vector fields (the build half).

Counterpart of `elasticsearch_tpu/index/ann.py`. The exact scan
(ops/knn.py) scores every vector of a segment for every query; this adds
the coarse stage: seeded k-means at build, cluster pruning at query time
(ops/ann.py). Per cluster the index stores its centroid [D] f32 (in the
similarity's working space: the unit sphere for cosine, raw space
otherwise), its radius (max distance from the centroid to a member) and
its members' ordinals [cluster_cap] int32 (pad -1). The cluster count
and the capacity are pow2-bucketed, as the reference's.

The k-means loop runs on the host in numpy (`_kmeans_host`, the
reference's; its per-cluster sums in `np.add.at`'s order, without its
per-row dispatch), the full assignment in torch on
the segment's device (`_assign_full`). Delta segments never build an
index: they serve the exact scan, and compaction's new base builds its
own at its first search. A failed build degrades the segment to the
exact scan, sticky per (segment, field): the index is an accelerator,
never a correctness input. The reference's `site=ann` fault rules are
dispatch fault kinds, which the port does not carry yet
(utils/faults.py).
"""

from __future__ import annotations

import logging
import os
import threading
import weakref

import numpy as np
import torch

from .segment import next_pow2

# below this many vectors the exact scan wins outright
DEFAULT_MIN_DOCS = 1 << 16
DEFAULT_RECALL = 0.95
# k-means training sample cap: the coarse quantizer trains on a sample
# and assigns the full set in one pass
_TRAIN_CAP = 1 << 18
_KMEANS_ITERS = 10

# multiplicative slack on the transformed cluster bounds: members are
# scored from bf16-rounded device copies while the centroid geometry is
# f32; 1/64 covers the ~2^-8 relative rounding of both operands
ANN_BOUND_SLACK = np.float32(1.0 + 1.0 / 64.0)

# module config (Node plumbs index.ann.* through configure(); the
# ES_TPU_ANN_* environment variables override at read time)
_cfg_lock = threading.Lock()
_cfg_min_docs: int | None = None
_cfg_nprobe: int | None = None
_cfg_recall: float | None = None
_cfg_token: object | None = None


def configure(min_docs: int | None = None, nprobe: int | None = None,
              recall: float | None = None) -> object:
    """Node startup hook (process-global, last node wins). Returns an
    ownership token for reset(if_current=...)."""
    global _cfg_min_docs, _cfg_nprobe, _cfg_recall, _cfg_token
    with _cfg_lock:
        if min_docs is not None:
            _cfg_min_docs = int(min_docs)
        if nprobe is not None:
            _cfg_nprobe = int(nprobe)
        if recall is not None:
            _cfg_recall = float(recall)
        _cfg_token = object()
        return _cfg_token


def reset(if_current: object | None = None) -> None:
    global _cfg_min_docs, _cfg_nprobe, _cfg_recall, _cfg_token
    with _cfg_lock:
        if if_current is not None and if_current is not _cfg_token:
            return
        _cfg_min_docs = _cfg_nprobe = _cfg_recall = None
        _cfg_token = None


def min_docs() -> int:
    env = os.environ.get("ES_TPU_ANN_MIN_DOCS")
    if env is not None:
        return int(env)
    with _cfg_lock:
        return _cfg_min_docs if _cfg_min_docs is not None \
            else DEFAULT_MIN_DOCS


def declared_recall() -> float:
    env = os.environ.get("ES_TPU_ANN_RECALL")
    if env is not None:
        return float(env)
    with _cfg_lock:
        return _cfg_recall if _cfg_recall is not None else DEFAULT_RECALL


def default_nprobe(n_clusters: int, recall: float | None = None) -> int:
    """nprobe for a declared recall target, pow2-bucketed: 1/8 of the
    clusters at 0.95, 1/4 at 0.99 and above, 1/16 below 0.9, at least
    8 (the reference's heuristic)."""
    env = os.environ.get("ES_TPU_ANN_NPROBE")
    if env is not None:
        return max(1, next_pow2(int(env), floor=1))
    with _cfg_lock:
        cfg = _cfg_nprobe
    if cfg is not None:
        return max(1, next_pow2(cfg, floor=1))
    r = declared_recall() if recall is None else float(recall)
    frac = 0.25 if r >= 0.99 else (0.125 if r >= 0.9 else 0.0625)
    return max(8, next_pow2(int(np.ceil(n_clusters * frac)), floor=1))


# serializes ensure_ann() installs; the build runs outside it (a lost
# race wastes one build, never corrupts state)
_ENSURE_LOCK = threading.Lock()


def ensure_ann(segment, field: str, similarity: str, *,
               device: torch.device | None = None):
    """Build (once) and return `segment.ann[field]`. None when the segment
    is below the exact-scan crossover, is a delta, or its build failed
    (sticky per (segment, field), logged)."""
    ai = segment.ann.get(field)
    if ai is not None:
        return ai
    if segment.delta_parent is not None:
        return None
    skip = getattr(segment, "_ann_skip", None)
    if skip is not None and field in skip:
        return None
    vc = segment.vectors.get(field)
    if vc is None:
        return None
    try:
        built = build_ann(vc.values, vc.exists, similarity, device=device)
    except Exception:  # noqa: BLE001 - any build failure degrades
        logging.getLogger(__name__).exception(
            "ANN build failed for [%s] on segment [%s]; serving the exact "
            "scan (sticky until rebuild)", field,
            getattr(segment, "seg_id", "?"))
        built = None
    with _ENSURE_LOCK:
        ai = segment.ann.get(field)
        if ai is not None:
            return ai          # lost the build race; first install wins
        if built is None:
            if getattr(segment, "_ann_skip", None) is None:
                segment._ann_skip = set()
            segment._ann_skip.add(field)
            return None
        # copy-on-write: concurrent searches read segment.ann unlocked
        segment.ann = {**segment.ann, field: built}
    return built


def ensure_ann_device(segment, field: str, similarity: str,
                      device: torch.device):
    """ensure_ann, then (once per device) upload the probe's arrays.
    Returns (AnnIndex, {"centroids", "radii", "members"}) or None. The
    upload lives on `segment._ann_device`, outside the segment's device
    columns, and holds its bytes against the fielddata breaker."""
    ai = ensure_ann(segment, field, similarity, device=device)
    if ai is None:
        return None
    cache = getattr(segment, "_ann_device", None)
    entry = None if cache is None else cache.get((field, device))
    if entry is None:
        from ..utils.breaker import breaker_service
        hold = breaker_service().breaker("fielddata").hold(ai.nbytes())
        weakref.finalize(segment, hold.release)
        entry = {name: torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for name, a in (("centroids", ai.centroids),
                                 ("radii", ai.radii),
                                 ("members", ai.members))}
        entry["_breaker_hold"] = hold
        with _ENSURE_LOCK:
            cache = getattr(segment, "_ann_device", None)
            if cache is None:
                cache = {}
                segment._ann_device = cache
            existing = cache.get((field, device))
            if existing is not None:
                hold.release()
                entry = existing
            else:
                cache[(field, device)] = entry
    return ai, entry


class AnnIndex:
    """One field's IVF coarse index over a segment's vectors."""

    __slots__ = ("similarity", "centroids", "radii", "members", "counts")

    def __init__(self, similarity: str, centroids: np.ndarray,
                 radii: np.ndarray, members: np.ndarray,
                 counts: np.ndarray):
        self.similarity = similarity
        self.centroids = centroids      # [C, D] f32 (working space)
        self.radii = radii              # [C] f32
        self.members = members          # [C, cluster_cap] int32, pad -1
        self.counts = counts            # [C] int32

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def cluster_cap(self) -> int:
        return self.members.shape[1]

    @property
    def dims(self) -> int:
        return self.centroids.shape[1]

    def nbytes(self) -> int:
        return (self.centroids.nbytes + self.radii.nbytes
                + self.members.nbytes + self.counts.nbytes)

    def arrays(self) -> dict[str, np.ndarray]:
        """Store round-trip payload (index/store.py `ann__<field>`)."""
        return {"centroids": self.centroids, "radii": self.radii,
                "members": self.members, "counts": self.counts}

    @classmethod
    def from_arrays(cls, similarity: str,
                    arrays: dict[str, np.ndarray]) -> "AnnIndex":
        return cls(similarity,
                   np.ascontiguousarray(arrays["centroids"],
                                        dtype=np.float32),
                   np.ascontiguousarray(arrays["radii"], dtype=np.float32),
                   np.ascontiguousarray(arrays["members"], dtype=np.int32),
                   np.ascontiguousarray(arrays["counts"], dtype=np.int32))


def _working_space(values: np.ndarray, similarity: str) -> np.ndarray:
    """Vectors in the geometry the cluster bound is argued in: the unit
    sphere for cosine, raw space for dot_product / l2_norm."""
    x = values.astype(np.float32, copy=False)
    if similarity == "cosine":
        n = np.linalg.norm(x, axis=1, keepdims=True)
        return x / np.maximum(n, 1e-12)
    return x


def _cluster_sums(x: np.ndarray, assign: np.ndarray, counts: np.ndarray,
                  n_clusters: int) -> np.ndarray:
    """np.add.at(zeros, assign, x), bit for bit, without its per-row
    dispatch: each cluster's rows added to its zero sum one after
    another in ascending row order, the r-th rows of all clusters in one
    vector add."""
    sums = np.zeros((n_clusters, x.shape[1]), dtype=x.dtype)
    order = np.argsort(assign, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for r in range(int(counts.max(initial=0))):
        cl = np.nonzero(counts > r)[0]
        sums[cl] += x[order[starts[cl] + r]]
    return sums


def _kmeans_host(x: np.ndarray, n_clusters: int, seed: int,
                 iters: int = _KMEANS_ITERS) -> np.ndarray:
    """Seeded Lloyd k-means (the reference's loop): empty clusters
    re-seed to the points farthest from their assigned centroid."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    cent = x[rng.choice(n, size=n_clusters, replace=False)].copy()
    x2 = np.einsum("nd,nd->n", x, x)
    for _ in range(iters):
        # argmin_c ||x - c||^2 = argmin_c ||c||^2 - 2 x.c
        c2 = np.einsum("cd,cd->c", cent, cent)
        d = c2[None, :] - 2.0 * (x @ cent.T)          # [n, C] + const
        assign = np.argmin(d, axis=1)
        counts = np.bincount(assign, minlength=n_clusters)
        sums = _cluster_sums(x, assign, counts, n_clusters)
        nonempty = counts > 0
        cent[nonempty] = sums[nonempty] / counts[nonempty, None]
        empty = np.nonzero(~nonempty)[0]
        if empty.size:
            dmin = d[np.arange(n), assign] + x2
            far = np.argsort(-dmin)[: empty.size]
            cent[empty] = x[far]
    return cent.astype(np.float32)


def _assign_full(x: np.ndarray, cent: np.ndarray, device: torch.device,
                 chunk: int = 1 << 17) -> tuple[np.ndarray, np.ndarray]:
    """Assign every vector to its nearest centroid (f32 ||c||^2 - 2 x.c,
    first minimum on ties) in chunks on `device`, and measure each
    cluster's radius. The product's f32 sums run in the device's order,
    so a row whose two nearest centroids lie within that rounding may
    land in the other one than in the reference's build."""
    n = x.shape[0]
    c2 = np.einsum("cd,cd->c", cent, cent).astype(np.float32)
    cent_d = torch.from_numpy(np.ascontiguousarray(cent)).to(device)
    c2_d = torch.from_numpy(c2).to(device)
    assign = np.empty(n, dtype=np.int32)
    dmin = np.empty(n, dtype=np.float32)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        xc = torch.from_numpy(np.ascontiguousarray(x[lo:hi])).to(device)
        d = c2_d[None, :] - 2.0 * (xc @ cent_d.t())
        a = torch.argmin(d, dim=1)
        assign[lo:hi] = a.to(torch.int32).cpu().numpy()
        dmin[lo:hi] = d.gather(1, a[:, None])[:, 0].cpu().numpy()
    x2 = np.einsum("nd,nd->n", x, x).astype(np.float32)
    d2 = np.maximum(dmin + x2, 0.0)       # true squared distance
    radii2 = np.zeros(cent.shape[0], dtype=np.float32)
    np.maximum.at(radii2, assign, d2)
    return assign, np.sqrt(radii2)


def build_ann(values: np.ndarray, exists: np.ndarray, similarity: str,
              *, device: torch.device | None = None,
              seed: int = 0) -> AnnIndex | None:
    """Build one field's IVF index, or None when the segment holds fewer
    vectors than `index.ann.min_docs` / ES_TPU_ANN_MIN_DOCS."""
    ords = np.nonzero(np.asarray(exists, dtype=bool))[0].astype(np.int32)
    n = int(ords.size)
    if n < min_docs():
        return None
    x = _working_space(np.asarray(values)[ords], similarity)
    # sqrt(N)-ish coarse stage, pow2-bucketed; every cluster keeps >= ~2
    # members on average at the floor
    c = next_pow2(int(np.sqrt(n)), floor=8)
    c = min(c, next_pow2(max(n // 2, 1), floor=1))
    train = x
    if n > _TRAIN_CAP:
        rng = np.random.default_rng(seed)
        train = x[rng.choice(n, size=_TRAIN_CAP, replace=False)]
    cent = _kmeans_host(train, c, seed)
    assign, radii = _assign_full(
        x, cent, torch.device("cpu") if device is None else device)
    counts = np.bincount(assign, minlength=c).astype(np.int32)
    ccap = next_pow2(int(counts.max()), floor=8)
    members = np.full((c, ccap), -1, dtype=np.int32)
    order = np.argsort(assign, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for ci in range(c):
        lo = int(starts[ci])
        row = order[lo: lo + int(counts[ci])]
        members[ci, : row.size] = ords[row]
    return AnnIndex(similarity, cent, radii.astype(np.float32),
                    members, counts)
