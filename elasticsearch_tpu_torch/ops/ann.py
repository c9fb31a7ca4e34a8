"""IVF probe: cluster bounds + threshold-pruned exact scoring.

Counterpart of `elasticsearch_tpu/ops/ann.py`, the query-time half of
the coarse-quantized vector path (index/ann.py builds the clusters):

  * one small centroid product bounds every cluster's best transformed
    similarity (`cluster_bounds`, from centroid + radius geometry,
    inflated by ANN_BOUND_SLACK so bf16 member scoring cannot beat it);
  * the nprobe candidate clusters are picked and ordered by centroid
    similarity (the radius-free bound), then probed with a running top-k
    threshold carried across them: a cluster whose bound cannot beat the
    running k-th best is skipped without touching its members
    (`clusters_pruned`);
  * survivors score their members exactly through
    `ops/knn.knn_score_column`, so recall is lost only in the coarse
    stage.

The reference skips a probe slot batch-wide with `lax.cond(any(need))`
and masks the rows that do not need it. Here the rows that need the slot
are read back to the host, one sync per probe slot (`HOST_SYNCS` counts
them), and only they gather and score members; the others merge nothing.
Each row's result is its own, so the shard searcher probes a batch of
pure-knn requests in one call. The stats (probed, pruned, scored) are
the reference's. `cluster_bounds_np` is the host mirror, op for op.
"""

from __future__ import annotations

import numpy as np
import torch

from ..index.ann import ANN_BOUND_SLACK
from . import ordered
from .knn import fma_rn, knn_score_column, query_norm, sqrt_rn
from .topk import NEG_INF, running_topk_init, running_topk_merge, \
    top_k_values

# host reads of a probe slot's "does any row need it" flag, one per slot
# of every ivf_topk call (the reference's lax.cond, a device branch)
HOST_SYNCS = {"ivf_slot": 0}


def _slacked(t: torch.Tensor) -> torch.Tensor:
    """Bound inflation that is conservative on both signs: nonnegative
    bounds scale up, negative ones shrink toward zero. The reference
    divides by the slack, which its compiled program computes as a
    multiply by the constant's f32 reciprocal."""
    return torch.where(t >= 0.0, t * float(ANN_BOUND_SLACK),
                       t * float(np.float32(1.0) / ANN_BOUND_SLACK))


def cluster_bounds(centroids: torch.Tensor, radii: torch.Tensor,
                   query: torch.Tensor, *, similarity: str) -> torch.Tensor:
    """[C, D] centroids x [B, D] queries -> [B, C] f32 upper bounds on
    the transformed similarity of any cluster member.

      cosine      cos(q, x) <= q_hat . c + r
      dot_product q . x <= q . c + |q| r
      l2_norm     d(q, x) >= max(0, d(q, c) - r)
    each through its monotone score transform, with the fused
    multiply-adds of the reference's compiled probe program
    (q . c + |q| r, 1 + dmin^2)."""
    q = query.to(torch.float32)
    c = centroids.to(torch.float32)
    qc = q @ c.t()                                           # [B, C]
    if similarity == "cosine":
        qn = torch.clamp_min(query_norm(q), 1e-12)
        cosb = torch.clamp_max(qc / qn + radii[None, :], 1.0)
        return _slacked((1.0 + cosb) / 2.0)
    if similarity == "dot_product":
        qn = query_norm(q)
        dotb = fma_rn(qn.expand_as(qc), radii[None, :].expand_as(qc), qc)
        return _slacked((1.0 + dotb) / 2.0)
    qn2 = _sum_sq(q)
    c2 = _sum_sq(c)[:, 0][None, :]
    d = sqrt_rn(torch.clamp_min(qn2 - 2.0 * qc + c2, 0.0))
    dmin = torch.clamp_min(d - radii[None, :], 0.0)
    return _slacked(1.0 / fma_rn(dmin, dmin, torch.ones_like(dmin)))


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    """jnp.sum(x * x, axis=1, keepdims=True) in XLA's order."""
    return ordered.xla_block_sum(ordered.ftz(x * x))[:, None]


def cluster_bounds_np(centroids: np.ndarray, radii: np.ndarray,
                      query: np.ndarray, *, similarity: str) -> np.ndarray:
    """Host mirror of cluster_bounds, op for op in numpy f32."""
    slack = np.float32(ANN_BOUND_SLACK)

    def slacked(t):
        return np.where(t >= 0.0, t * slack, t / slack).astype(np.float32)

    q = np.asarray(query, dtype=np.float32)
    c = np.asarray(centroids, dtype=np.float32)
    r = np.asarray(radii, dtype=np.float32)
    qc = (q @ c.T).astype(np.float32)
    if similarity == "cosine":
        qn = np.maximum(np.linalg.norm(q, axis=1, keepdims=True),
                        np.float32(1e-12)).astype(np.float32)
        cosb = np.minimum(qc / qn + r[None, :], np.float32(1.0))
        return slacked((1.0 + cosb) / np.float32(2.0))
    if similarity == "dot_product":
        qn = np.linalg.norm(q, axis=1, keepdims=True).astype(np.float32)
        dotb = qc + qn * r[None, :]
        return slacked((1.0 + dotb) / np.float32(2.0))
    qn2 = np.sum(q * q, axis=1, keepdims=True, dtype=np.float32)
    c2 = np.sum(c * c, axis=1, dtype=np.float32)[None, :]
    d = np.sqrt(np.maximum(qn2 - 2.0 * qc + c2, np.float32(0.0)))
    dmin = np.maximum(d - r[None, :], np.float32(0.0))
    return slacked(1.0 / (np.float32(1.0) + dmin * dmin))


def _member_scores(v: torch.Tensor, nrm: torch.Tensor, query: torch.Tensor,
                   similarity: str) -> torch.Tensor:
    """Exact transformed similarity of gathered members: [B, M, D] member
    vectors x [B, D] queries -> [B, M] f32, through the one transform
    definition (ops/knn.knn_score_column), a row at a time as the
    reference's vmap."""
    ones = torch.ones(v.shape[1], dtype=torch.bool, device=v.device)
    return torch.cat([knn_score_column(v[b], nrm[b], ones, query[b:b + 1],
                                       similarity=similarity)
                      for b in range(v.shape[0])])


def ivf_topk(values: torch.Tensor, norms: torch.Tensor, exists: torch.Tensor,
             live: torch.Tensor, members: torch.Tensor,
             centroids: torch.Tensor, radii: torch.Tensor,
             query: torch.Tensor, *, similarity: str, k: int, nprobe: int,
             probe: tuple | None = None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """IVF probed top-k over one segment's vectors -> (scores [B, k],
    idx [B, k] global doc ordinals, stats int32 [3] = (clusters_probed,
    clusters_pruned, clusters_scored) in (query, cluster) units).
    Entries past a query's hits are -inf with undefined ids. `probe`:
    host-picked (bounds [B, nprobe], ids [B, nprobe]), else the centroid
    product and its top-k run here."""
    n_clusters = centroids.shape[0]
    nprobe = min(nprobe, n_clusters)
    b = query.shape[0]
    k = min(k, values.shape[0])
    ccap = members.shape[1]
    dev = values.device
    q = query.to(torch.float32)
    if probe is None:
        bounds = cluster_bounds(centroids, radii, q, similarity=similarity)
        # rank by the radius-free centroid score: the radius bound ceils
        # at the transform maximum for every cluster whose ball covers a
        # near-perfect match, so it cannot order candidates
        rank = cluster_bounds(centroids, torch.zeros_like(radii), q,
                              similarity=similarity)
        _pr, pidx = top_k_values(rank, nprobe)
        pb = bounds.gather(1, pidx.to(torch.int64))
    else:
        pb, pidx = probe
    top_s, top_i = running_topk_init(b, k, dev)
    probed = pruned = scored = 0
    c_k = min(k, ccap)
    for j in range(nprobe):
        cid = pidx[:, j].to(torch.int64).clamp(0, n_clusters - 1)
        # the radius bound vs the running k-th best; near clusters come
        # first, fill the threshold, and far ones skip
        need = pb[:, j] > top_s[:, -1]
        HOST_SYNCS["ivf_slot"] += 1
        rows = torch.nonzero(need)[:, 0]
        n_need = int(rows.numel())
        if n_need:
            # only the rows that need the slot gather and score; the
            # others merge -inf candidates, which changes no state (the
            # reference's masked lanes)
            mem = members[cid[rows]]                         # [r, ccap]
            valid = mem >= 0
            safe = torch.where(valid, mem, 0).to(torch.int64)
            s = _member_scores(values[safe], norms[safe], q[rows],
                               similarity)
            s = torch.where(valid & exists[safe] & live[safe], s, NEG_INF)
            c_s, c_loc = top_k_values(s, c_k)
            cand_s = torch.full((b, c_k), NEG_INF, dtype=torch.float32,
                                device=dev)
            cand_i = torch.zeros((b, c_k), dtype=torch.int32, device=dev)
            cand_s[rows] = c_s
            cand_i[rows] = safe.gather(1, c_loc.to(torch.int64)).to(
                torch.int32)
            top_s, top_i = running_topk_merge(top_s, top_i, cand_s, cand_i)
        probed += b
        pruned += b - n_need
        scored += n_need
    return top_s, top_i, torch.tensor([probed, pruned, scored],
                                      dtype=torch.int32)
