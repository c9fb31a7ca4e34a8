"""f32 sums in the reference's exact order, as plain torch on any device.

The reference computes its agg sums with `jnp.cumsum`, `.sum(-1)` and
`.at[ids].add(mode="drop")` outside any Pallas kernel, and XLA fixes the
order of those f32 adds:

* `jnp.cumsum` over the last axis is a recursive blocked scan of base
  16 (`xla_cumsum`): the row splits into blocks of 16, the last one
  zero-padded; each block takes its inclusive prefix sequentially from
  +0.0; the block totals are scanned by the same rule, recursively, until
  16 or fewer remain (then sequentially); an output is
  fl(exclusive prefix of its block + its intra-block prefix). A row of
  one element is returned as it is.
* `.sum(-1)` is a tree of centred windows (`xla_block_sum`): while more
  than 32 values remain, XLA pads them to k = ceil(n / 32) windows of
  exactly 32, p = 32 k - n zeros split p // 2 before the row and
  p - p // 2 after it (`reduce-window size=32 stride=32 pad=lo_hi` in the
  compiled HLO), and sums each window sequentially from +0.0; the last 32
  or fewer are summed sequentially. On a power-of-two length and on the
  128- and 512-wide blocks of `ops/aggs.view_group_reduce` p is 0: runs
  of 32, then the runs in order.
* `.at[ids].add(w, mode="drop")` is, for each bucket, a left fold from
  +0.0 over the bucket's docs in ascending doc order (`bucket_fold`);
  ids in [-n, 0) wrap, the rest out of range drop.

Zero padding and the +0.0 of an unmatched doc change no sum: a sum
started at +0.0 is never -0.0 under round-to-nearest, and s + 0.0 == s
otherwise. Every add here is its own elementwise torch op, so the CPU
and the card round alike (no FMA, no reassociation);
tests/test_torch_ordered_aggs.py pins the three orders against JAX
itself, at lengths 1-40 and others off a power of two.

`prefix_at` is the plain version of the card's scan kernel
(`ops/cuda_scoring.ordered_prefix`), `xla_block_sum` of its tree entry
(`ops/cuda_scoring.ordered_sum`), `bucket_fold` of its bucket-sum entry
(`ops/cuda_scoring.ordered_bucket_sum`).
"""

from __future__ import annotations

import torch

SCAN_BASE = 16       # block of XLA's scan rewrite
SUM_WINDOW = 32      # window of XLA's reduction tree


def _seq_prefix(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix over the last axis, sequential from +0.0."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    cols = []
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
        cols.append(acc)
    return torch.stack(cols, dim=-1)


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, sequential from +0.0."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """`jnp.cumsum(x, axis=-1)` of a float row, bit for bit."""
    n = x.shape[-1]
    if n <= 1:
        return x.clone()
    if n <= SCAN_BASE:
        return _seq_prefix(x)
    nb = -(-n // SCAN_BASE)
    blocks = torch.nn.functional.pad(x, (0, nb * SCAN_BASE - n)).reshape(
        *x.shape[:-1], nb, SCAN_BASE)
    intra = _seq_prefix(blocks)
    incl = xla_cumsum(intra[..., -1])
    excl = torch.nn.functional.pad(incl[..., :-1], (1, 0))
    out = excl[..., None] + intra
    return out.reshape(*x.shape[:-1], nb * SCAN_BASE)[..., :n]


def sum_windows(n: int) -> list[tuple[int, int]]:
    """The (lo, k) levels of XLA's reduction tree over n values: k
    windows of 32, the first starting lo zeros before the row; the last
    level is one window of all that remain (lo 0)."""
    levels = []
    while n > SUM_WINDOW:
        k = -(-n // SUM_WINDOW)
        levels.append(((SUM_WINDOW * k - n) // 2, k))
        n = k
    levels.append((0, 1))
    return levels


def xla_block_sum(x: torch.Tensor) -> torch.Tensor:
    """`x.sum(-1)` of a float row in XLA's order: centred windows of 32
    summed in order, level by level, then the last ones in order."""
    for lo, k in sum_windows(x.shape[-1]):
        n = x.shape[-1]
        w = SUM_WINDOW if k > 1 else n
        x = torch.nn.functional.pad(x, (lo, w * k - n - lo))
        x = _seq_sum(x.reshape(*x.shape[:-1], k, w))
    return x[..., 0]


def bucket_ids_kept(bucket_ids: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """`.at[].add(mode="drop")`'s ids: [-n, 0) wrapped, the rest out of
    [0, n) sent to n (dropped) -> int64."""
    ids = bucket_ids.to(torch.int64)
    ids = torch.where(ids < 0, ids + n_buckets, ids)
    return torch.where((ids >= 0) & (ids < n_buckets), ids, n_buckets)


def bucket_fold(bucket_ids: torch.Tensor, mask: torch.Tensor,
                values: torch.Tensor, n_buckets: int,
                square: bool = False) -> torch.Tensor:
    """out[b, j] = the left fold from +0.0 of v[d] (v*v with `square`)
    over the docs d of bucket j matched in row b, in ascending d: XLA's
    `.at[bucket_ids].add(where(mask, v, 0), mode="drop")`. bucket_ids
    [cap], mask bool [B, cap], values [cap] -> f32 [B, n_buckets].

    Each (row, bucket)'s k-th matched doc is added in pass k, so a pass
    adds to every target at most once (no order within a pass): as many
    passes as the longest fold."""
    B, cap = mask.shape
    dev = mask.device
    out = torch.zeros((B * n_buckets,), dtype=torch.float32, device=dev)
    v = values.to(torch.float32)
    if square:
        v = v * v
    ids = bucket_ids_kept(bucket_ids, n_buckets)
    rows, docs = torch.nonzero(mask & (ids < n_buckets)[None, :],
                               as_tuple=True)        # row-major: d ascends
    if docs.numel() == 0:
        return out.reshape(B, n_buckets)
    tgt = rows * n_buckets + ids[docs]
    order = torch.sort(tgt, stable=True).indices
    st = tgt[order]
    pos = torch.arange(st.numel(), device=dev)
    first = torch.where(torch.cat([torch.ones(1, dtype=torch.bool,
                                              device=dev),
                                   st[1:] != st[:-1]]), pos, 0)
    rank = pos - torch.cummax(first, dim=0).values
    by_rank = torch.sort(rank, stable=True).indices
    tgt_r, val_r = st[by_rank], v[docs[order[by_rank]]]
    lo = 0
    for count in torch.bincount(rank).tolist():
        out.index_add_(0, tgt_r[lo:lo + count], val_r[lo:lo + count])
        lo += count
    return out.reshape(B, n_buckets)


def prefix_at(w: torch.Tensor, perm: torch.Tensor | None,
              pos: torch.Tensor) -> torch.Tensor:
    """cs0[:, pos] of cs0 = [0, xla_cumsum(w[:, perm])]: the prefix sums
    of the (permuted) rows in the reference's order at positions `pos`
    in [0, n] ([P], or [B, P] per row) -> [B, P]."""
    if perm is not None:
        w = w[:, perm.to(torch.int64)]
    cs0 = torch.nn.functional.pad(xla_cumsum(w), (1, 0))
    pos = pos.to(torch.int64)
    if pos.dim() == 1:
        return cs0[:, pos]
    return cs0.gather(1, pos)
