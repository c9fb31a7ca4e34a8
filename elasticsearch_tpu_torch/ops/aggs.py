"""Aggregation primitives: masked bucketing + metrics, in plain torch.

Counterpart of `elasticsearch_tpu/ops/aggs.py` (which the JAX package
computes outside any Pallas kernel). All functions take a match mask
[B, cap] (queries batched) and return per-bucket arrays [B, n_buckets].

`.at[].add(mode="drop")` first wraps ids in [-n, 0) numpy-style, then
drops the ids still out of bounds; torch's `index_add_` /
`scatter_reduce_` do neither, so every scatter here wraps the same way
and routes the rest to a sentinel column `n_buckets` of an
`n_buckets + 1` wide buffer that is sliced off.

f32 sums taken by the reference with XLA's `cumsum` / `.sum(-1)`
(sorted_group_reduce, sorted_hist_reduce, view_group_reduce's float
path, masked_stats) go through `cuda_scoring.ordered_prefix` /
`ordered_sum`, and its doc-space bucket scatters (bucket_sums,
bucket_sum_sq, bucket_counts: `.at[ids].add`; bucket_min, bucket_max:
`.at[ids].min / .max`) have their exact results in `ops/ordered.py`;
`bucket_stats` takes any of them at once (`cuda_scoring.
ordered_bucket_stats`: the plain reduces on the CPU, one kernel on the
card), so both give the reference's bits. Counts stay in int32 where
the views take them; `bucket_counts` scatters its 1.0s with
`index_add_`, exact in any order below 2^24 a bucket. Each f32 add,
subtract and multiply on agg values flushes subnormal results
(`ordered.ftz`), as XLA's CPU runtime does; the value columns they read
come flushed from `search/executor.device_arrays`.
"""

from __future__ import annotations

import torch

from . import cuda_scoring as cs
from . import ordered

F32_INF = float("inf")


def bucket_stats(bucket_ids, mask, values, n_buckets, stats) -> dict:
    """{stat: [B, n_buckets]} for the stats asked of `cuda_scoring.
    BUCKET_STATS` (sum, sum_sq, count, min, max), each what the
    reference's bucket_sums / bucket_sum_sq / bucket_counts / bucket_min
    / bucket_max give."""
    return cs.ordered_bucket_stats(
        bucket_ids.to(torch.int32).contiguous(), mask.contiguous(),
        values.to(torch.float32).contiguous(), n_buckets, stats)


def bucket_counts(bucket_ids: torch.Tensor, mask: torch.Tensor,
                  n_buckets: int) -> torch.Tensor:
    """Matched docs per bucket, summed in no fixed order: sums of 1.0,
    exact below 2^24 a bucket."""
    out = torch.zeros((mask.shape[0], n_buckets + 1), dtype=torch.float32,
                      device=mask.device)
    out.index_add_(1, ordered.bucket_ids_kept(bucket_ids, n_buckets),
                   mask.to(torch.float32))
    return out[:, :n_buckets]


def _view_block_k(n: int) -> int | None:
    """Block width for the two-level reduce (512, or 128 for small
    segments; None when neither divides)."""
    for k in (512, 128):
        if n % k == 0 and n >= k:
            return k
    return None


def view_group_reduce(w: torch.Tensor, bounds: torch.Tensor,
                      int_weights: bool = False) -> torch.Tensor:
    """Per-range sums of SORTED-SPACE weights: range g of `w` [B, Np]
    spans [bounds[g], bounds[g+1]) (bounds [G+1] or [B, G+1]).

    Two-level decomposition, as in the reference: block sums -> short
    cumsum -> boundary base plus an intra-block prefix at each bound.
    Counts (`int_weights`) accumulate in int32, exact past 2^24 docs;
    float sums take XLA's order at each level."""
    B, Np = w.shape
    K = _view_block_k(Np)
    bounds = bounds.to(torch.int64)
    if not int_weights:
        w = w.to(torch.float32)
    if K is None:
        if not int_weights:
            return _diff(cs.ordered_prefix(w.contiguous(), None,
                                           bounds.to(torch.int32)))
        cs0 = torch.nn.functional.pad(torch.cumsum(
            w.to(torch.int32), dim=-1, dtype=torch.int32), (1, 0))
        if bounds.dim() == 1:
            return cs0[:, bounds[1:]] - cs0[:, bounds[:-1]]
        return (cs0.gather(1, bounds[:, 1:])
                - cs0.gather(1, bounds[:, :-1]))
    NB = Np // K
    blocks = w.reshape(B, NB, K)
    blk = torch.div(bounds, K, rounding_mode="floor")
    off = bounds - blk * K
    if int_weights:
        bs = blocks.sum(dim=-1, dtype=torch.int32)
        cs0 = torch.nn.functional.pad(torch.cumsum(bs, dim=-1,
                                                   dtype=torch.int32), (1, 0))
        base = cs0[:, blk] if bounds.dim() == 1 else cs0.gather(1, blk)
    else:
        bs = cs.ordered_sum(blocks.contiguous())
        base = cs.ordered_prefix(bs, None, blk.to(torch.int32))
    lane = torch.arange(K, dtype=torch.int64, device=w.device)
    # bounds == Np land on blk == NB: cs0[NB] is valid, and off == 0
    # zeroes the intra term, so clamping the row gather is inert
    row_blk = blk.clamp(max=NB - 1)
    if bounds.dim() == 1:
        rows = blocks[:, row_blk]                         # [B, G+1, K]
        keep = lane[None, None, :] < off[None, :, None]
    else:
        rows = blocks.gather(1, row_blk[:, :, None].expand(-1, -1, K))
        keep = lane[None, None, :] < off[:, :, None]
    if int_weights:
        intra = torch.where(keep, rows.to(torch.int32),
                            torch.zeros((), dtype=torch.int32,
                                        device=w.device)
                            ).sum(dim=-1, dtype=torch.int32)
    else:
        intra = cs.ordered_sum(torch.where(keep, rows, 0.0).contiguous())
    return _diff(ordered.ftz(base + intra))


def _diff(pref: torch.Tensor) -> torch.Tensor:
    return ordered.ftz(pref[:, 1:] - pref[:, :-1])


def sorted_group_reduce(perm: torch.Tensor, starts: torch.Tensor,
                        weighted: torch.Tensor) -> torch.Tensor:
    """Sum `weighted` [B, cap] per group: `perm` [cap] sorts docs by
    group key; group g spans sorted positions [starts[g], starts[g+1]).
    The prefix sums of the permuted rows are taken in XLA's cumsum order
    at the group bounds only."""
    return _diff(cs.ordered_prefix(weighted.to(torch.float32).contiguous(),
                                   perm.to(torch.int32).contiguous(),
                                   starts.to(torch.int32).contiguous()))


def sorted_hist_reduce(sorted_vals: torch.Tensor, perm: torch.Tensor,
                       weighted: torch.Tensor,
                       edges: torch.Tensor) -> torch.Tensor:
    """Histogram over value-sorted docs: bucket b sums `weighted` where
    edges[b] <= value < edges[b+1]."""
    pos = torch.searchsorted(sorted_vals, edges.to(sorted_vals.dtype),
                             side="left")
    return _diff(cs.ordered_prefix(weighted.to(torch.float32).contiguous(),
                                   perm.to(torch.int32).contiguous(),
                                   pos.to(torch.int32)))


def bucket_sums(bucket_ids, mask, values, n_buckets):
    return bucket_stats(bucket_ids, mask, values, n_buckets, ("sum",))["sum"]


def bucket_min(bucket_ids, mask, values, n_buckets):
    return ordered.bucket_extreme(bucket_ids, mask, values, n_buckets)


def bucket_max(bucket_ids, mask, values, n_buckets):
    return ordered.bucket_extreme(bucket_ids, mask, values, n_buckets,
                                  largest=True)


def bucket_sum_sq(bucket_ids, mask, values, n_buckets):
    return bucket_stats(bucket_ids, mask, values, n_buckets,
                        ("sum_sq",))["sum_sq"]


def keyword_bucket_ids(ords: torch.Tensor, seg2global: torch.Tensor,
                       n_global: int) -> torch.Tensor:
    """Segment-local keyword ordinals -> shard-global bucket ids; missing
    docs (ord -1) map to n_global, which every scatter drops."""
    g = seg2global.to(torch.int32)[ords.clamp(min=0).to(torch.int64)]
    return torch.where(ords >= 0, g, n_global).to(torch.int32)


def fixed_histogram_bucket_ids(values: torch.Tensor, exists: torch.Tensor,
                               origin, interval,
                               n_buckets: int) -> torch.Tensor:
    """Fixed-interval (date_)histogram bucket ids; int32 columns stay in
    int32 (epoch seconds past 2^24 must not round through f32)."""
    if values.dtype == torch.int32:
        d = values - origin.to(torch.int32)
        q = torch.div(d, interval.to(torch.int32), rounding_mode="floor")
        bid = torch.where(d >= 0, q, -1)
    else:
        v = ordered.ftz(values.to(torch.float32))
        d = ordered.ftz(v - origin.to(torch.float32))
        bid = torch.floor(ordered.ftz(d / interval.to(torch.float32))
                          ).to(torch.int32)
    ok = exists & (bid >= 0) & (bid < n_buckets)
    return torch.where(ok, bid, n_buckets).to(torch.int32)


def edges_bucket_ids(values: torch.Tensor, exists: torch.Tensor,
                     edges: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Calendar-interval buckets: bucket i covers [edges[i], edges[i+1])."""
    bid = torch.searchsorted(edges.to(values.dtype), values,
                             side="right").to(torch.int32) - 1
    ok = exists & (bid >= 0) & (bid < n_buckets)
    return torch.where(ok, bid, n_buckets).to(torch.int32)


def masked_stats(values: torch.Tensor, exists: torch.Tensor,
                 mask: torch.Tensor) -> dict:
    """count/sum/min/max/sum_sq of a numeric column under a match mask,
    as [B] arrays. sum and sum_sq take XLA's window tree: the
    reference's bits at every length. min / max are XLA's reduce min /
    max of the flushed values: -0.0 below +0.0."""
    m = mask & exists[None, :]
    v = ordered.ftz(values.to(torch.float32))[None, :]
    return row_stats(v, m, signed_zeros=values.is_floating_point())


def row_stats(v: torch.Tensor, m: torch.Tensor,
              signed_zeros: bool = True) -> dict:
    """`masked_stats` of f32 values v ([1, cap] or [B, cap], flushed)
    under the mask m [B, cap]: the reference's where(m, v, 0).sum(-1),
    where(m, v * v, 0).sum(-1), and the reduce min / max."""
    mn = torch.where(m, v, F32_INF).amin(dim=-1)
    mx = torch.where(m, v, -F32_INF).amax(dim=-1)
    if signed_zeros:
        zero = v == 0
        neg = torch.signbit(v)
        has_neg0 = (m & zero & neg).any(dim=-1)
        has_pos0 = (m & zero & ~neg).any(dim=-1)
        mn = torch.where(mn == 0, torch.where(has_neg0, -0.0, 0.0), mn)
        mx = torch.where(mx == 0, torch.where(has_pos0, 0.0, -0.0), mx)
    return {
        "count": m.sum(dim=-1, dtype=torch.float32),
        "sum": cs.ordered_sum(torch.where(m, v, 0.0).contiguous()),
        "sum_sq": cs.ordered_sum(torch.where(m, ordered.ftz(v * v),
                                             0.0).contiguous()),
        "min": mn,
        "max": mx,
    }
