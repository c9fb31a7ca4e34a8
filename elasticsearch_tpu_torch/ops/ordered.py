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

`.at[ids].min / .max(mode="drop")` keep no sum; their result still
depends on the order where NaN or signed zeros meet (`bucket_extreme`).

XLA's CPU runtime computes with subnormals flushed: an f32 add,
multiply or compare treats a subnormal input as a zero of its sign, and
a subnormal result becomes a zero of its sign. Every add and multiply
here flushes its result (`ftz`; left out where no sum of the values can
be subnormal, `may_underflow`) and the values entering a sum or an
extreme are flushed first, so the sums, squares, minima and maxima are
XLA's; a pure move (`xla_cumsum` or `xla_block_sum` of one element)
keeps its value as XLA does.

`prefix_at` is the plain version of the card's scan kernel
(`ops/cuda_scoring.ordered_prefix`), `xla_block_sum` of its tree entry
(`ops/cuda_scoring.ordered_sum`), `bucket_fold`, `bucket_count` and
`bucket_extreme` of its bucket-stats entry
(`ops/cuda_scoring.ordered_bucket_stats`), and `parent_fold` of the
block join's to-parent fold (`ops/cuda_scoring.to_parent_fold`): the
nested query's `.at[:, target].add / .max / .min` over [B, cap] scores,
each parent's indices folded in ascending order.
"""

from __future__ import annotations

import numpy as np
import torch

SCAN_BASE = 16       # block of XLA's scan rewrite
SUM_WINDOW = 32      # window of XLA's reduction tree
F32_TINY = 2.0 ** -126   # the smallest normal f32
SUM_SAFE = 2.0 ** -100   # summands at least this large never sum below
                         # F32_TINY (may_underflow)


def ftz(x: torch.Tensor) -> torch.Tensor:
    """Subnormal f32 values -> zeros of their sign (XLA's flush on the
    CPU); every other value, NaN and infinities included, unchanged."""
    return torch.where(x.abs() < F32_TINY, x * 0, x)


def ftz_np(a: np.ndarray) -> np.ndarray:
    """`ftz` of a host array: float32 columns flushed, others (and a
    float32 column without a subnormal) returned as they are."""
    if a is None or a.dtype != np.float32:
        return a
    tiny = np.abs(a) < np.float32(F32_TINY)
    if not tiny.any():
        return a
    return np.where(tiny, np.copysign(np.float32(0), a), a).astype(np.float32)


def may_underflow(x: torch.Tensor) -> bool:
    """Whether sums of the (flushed) values x can give a subnormal result:
    only if one lies below 2^-100. Each value at least that large is a
    multiple of 2^-123, so is each exact sum of them, and a nonzero sum
    below 2^-100 is exact: no sum of them lands in the subnormal range,
    and the flush after each add can be left out."""
    a = x.abs()
    return bool(((a > 0) & (a < SUM_SAFE)).any())


def _seq_prefix(x: torch.Tensor, flush: bool = True) -> torch.Tensor:
    """Inclusive prefix over the last axis, sequential from +0.0."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    cols = []
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
        if flush:
            acc = ftz(acc)
        cols.append(acc)
    return torch.stack(cols, dim=-1)


def _seq_sum(x: torch.Tensor, flush: bool = True) -> torch.Tensor:
    """Sum over the last axis, sequential from +0.0."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
        if flush:
            acc = ftz(acc)
    return acc


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """`jnp.cumsum(x, axis=-1)` of a float row, bit for bit."""
    if x.shape[-1] <= 1:
        return x.clone()
    x = ftz(x)
    return _cumsum(x, may_underflow(x))


def _cumsum(x: torch.Tensor, flush: bool) -> torch.Tensor:
    n = x.shape[-1]
    if n <= 1:
        return x.clone()
    if n <= SCAN_BASE:
        return _seq_prefix(x, flush)
    nb = -(-n // SCAN_BASE)
    blocks = torch.nn.functional.pad(x, (0, nb * SCAN_BASE - n)).reshape(
        *x.shape[:-1], nb, SCAN_BASE)
    intra = _seq_prefix(blocks, flush)
    incl = _cumsum(intra[..., -1], flush)
    excl = torch.nn.functional.pad(incl[..., :-1], (1, 0))
    out = excl[..., None] + intra
    if flush:
        out = ftz(out)
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
    summed in order, level by level, then the last ones in order. A
    row of one value is returned as it is (XLA's reduce moves it)."""
    if x.shape[-1] == 1:
        return x[..., 0].clone()
    x = ftz(x)
    flush = may_underflow(x)
    for lo, k in sum_windows(x.shape[-1]):
        n = x.shape[-1]
        w = SUM_WINDOW if k > 1 else n
        x = torch.nn.functional.pad(x, (lo, w * k - n - lo))
        x = _seq_sum(x.reshape(*x.shape[:-1], k, w), flush)
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
    v = ftz(values.to(torch.float32))
    if square:
        v = ftz(v * v)
    flush = may_underflow(v)
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
        t = tgt_r[lo:lo + count]
        out.index_add_(0, t, val_r[lo:lo + count])
        if flush:
            out[t] = ftz(out[t])
        lo += count
    return out.reshape(B, n_buckets)


def bucket_count(bucket_ids: torch.Tensor, mask: torch.Tensor,
                 n_buckets: int) -> torch.Tensor:
    """Matched docs per bucket as f32, as the reference's `.at[ids].add`
    of 1.0s gives them: exact, and stopped at 2^24 (fl(2^24 + 1) is
    2^24). bucket_ids [cap], mask bool [B, cap] -> f32 [B, n_buckets]."""
    B = mask.shape[0]
    out = torch.zeros((B, n_buckets + 1), dtype=torch.int64,
                      device=mask.device)
    out.index_add_(1, bucket_ids_kept(bucket_ids, n_buckets),
                   mask.to(torch.int64))
    return out[:, :n_buckets].clamp(max=1 << 24).to(torch.float32)


# `.at[ids].min / .max(mode="drop")` of where(mask, v, +-inf): XLA folds
# each bucket's docs in ascending doc order through its NaN-propagating
# minimum / maximum (on the CPU, LLVM's x86 lowering). Without NaN that is
# the order-free minimum with -0.0 below +0.0 (maximum: +0.0 above -0.0).
# Which NaN survives depends on the order: the minimum keeps the first NaN
# with the sign bit clear, else the last one with it set; the maximum the
# first NaN with the sign bit set, else the last one with it clear. Each
# candidate is ranked by an integer key, smaller preferred, whose ties
# cannot occur (the doc breaks them), so a reduction in any order gives
# the fold's result: class 0 / 1 for the two NaN kinds (ranked by doc,
# first or last), class 2 for numbers (ranked by the monotone bits below).
EXTREME_CLASS = 1 << 32
EXTREME_NONE = 3 << 32       # no matched doc: the reduction's +-inf


def float_order_bits(values: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 in [0, 2^32), monotone in value with -0.0 below +0.0
    (NaN excluded)."""
    u = values.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 1 << 31, 0xFFFFFFFF - u, u | (1 << 31))


def extreme_keys(values: torch.Tensor, largest: bool) -> torch.Tensor:
    """The rank key of each doc's value for `bucket_extreme`, int64 of
    the values' shape, [cap] or [B, cap] (smaller wins; the doc, the
    last axis, breaks NaN ties), taken from the flushed value."""
    v = ftz(values.to(torch.float32))
    cap = v.shape[-1]
    doc = torch.arange(cap, dtype=torch.int64, device=v.device)
    neg = (v.contiguous().view(torch.int32) < 0)
    ordv = float_order_bits(v)
    num = 2 * EXTREME_CLASS + (0xFFFFFFFF - ordv if largest else ordv)
    # the NaN kind kept first (minimum: sign clear; maximum: sign set)
    first = neg if largest else ~neg
    nan = torch.where(first, doc, EXTREME_CLASS + 0xFFFFFFFF - doc)
    return torch.where(torch.isnan(v), nan, num)


def extreme_value(keys: torch.Tensor, values: torch.Tensor,
                  largest: bool) -> torch.Tensor:
    """Decode `extreme_keys` (reduced per bucket) back to f32 values; a
    NaN class key takes its doc's value (values [cap], or [B, cap] with
    keys [B, n]: each row its own), EXTREME_NONE the reduction's
    identity (+inf for the minimum, -inf for the maximum)."""
    cls = keys >> 32
    lo = keys & 0xFFFFFFFF
    ordv = 0xFFFFFFFF - lo if largest else lo
    bits = torch.where(ordv >= 1 << 31, ordv & 0x7FFFFFFF, 0xFFFFFFFF - ordv)
    doc = torch.where(cls == 0, lo, 0xFFFFFFFF - lo).clamp(
        max=max(values.shape[-1] - 1, 0))
    vbits = values.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64) & 0xFFFFFFFF
    if not values.numel():
        nan_bits = lo
    elif values.dim() == 2:
        nan_bits = vbits.gather(1, doc)
    else:
        nan_bits = vbits[doc]
    bits = torch.where(cls < 2, nan_bits, bits)
    ident = 0xFF800000 if largest else 0x7F800000
    bits = torch.where(keys >= EXTREME_NONE, ident, bits)
    return (bits - ((bits >= 1 << 31).to(torch.int64) << 32)).to(
        torch.int32).view(torch.float32)


def bucket_extreme(bucket_ids: torch.Tensor, mask: torch.Tensor,
                   values: torch.Tensor, n_buckets: int,
                   largest: bool = False) -> torch.Tensor:
    """XLA's `.at[bucket_ids].min(where(mask, v, +inf), mode="drop")`
    (`.max` of where(mask, v, -inf) with `largest`), bit for bit, NaN and
    signed zeros included: bucket_ids [cap], mask bool [B, cap], values
    [cap] -> f32 [B, n_buckets]. An integer reduction of the rank keys,
    exact in any order."""
    B, cap = mask.shape
    keys = extreme_keys(values, largest)
    ids = bucket_ids_kept(bucket_ids, n_buckets)
    k = torch.where(mask, keys[None, :], EXTREME_NONE)
    out = torch.full((B, n_buckets + 1), EXTREME_NONE, dtype=torch.int64,
                     device=mask.device)
    out.scatter_reduce_(1, ids[None, :].expand(B, -1), k, reduce="amin",
                        include_self=True)
    return extreme_value(out[:, :n_buckets], values, largest)


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


PARENT_FOLD_MODES = {"none": 0, "sum": 1, "max": 2, "min": 3}


def parent_fold_ranks(target: torch.Tensor, order: torch.Tensor,
                      starts: torch.Tensor) -> tuple:
    """The fold's passes: the indices grouped by their rank in their
    target's list (the k-th index of every list in pass k) -> (indices
    by rank, their targets, the count of each pass). From the CSR of
    `parent_fold` (order: the indices stably sorted by target; starts:
    each position's first slot)."""
    t_sorted = target.to(torch.int64)[order.to(torch.int64)]
    pos = torch.arange(order.numel(), device=order.device)
    rank = pos - starts.to(torch.int64)[t_sorted]
    by_rank = torch.sort(rank, stable=True).indices
    idx = order.to(torch.int64)[by_rank]
    return idx, t_sorted[by_rank], torch.bincount(rank).tolist()


def parent_fold(score: torch.Tensor, ok: torch.Tensor, target: torch.Tensor,
                ranks: tuple, mode: str) -> tuple:
    """The block join's to-parent fold: per (row b, position p) over the
    indices i with target[i] == p, the count of ok[b, i] (f32) and, by
    `mode`, the reference's XLA scatter result:
      * "sum": `zeros.at[:, target].add(where(ok, score, 0))`, a left fold
        from +0.0 in ascending i of every index (+0.0 where not ok),
        flushed after each add;
      * "max" / "min": `full(-inf).at[:, target].max(where(ok, score,
        -inf))` (min: +inf), XLA's NaN-propagating compare with -0.0
        below +0.0, by the rank keys of `bucket_extreme`;
      * "none": the count alone (value None).
    score f32 [B, cap], ok bool [B, cap], target [cap], ranks
    `parent_fold_ranks(...)` -> (count [B, cap], value [B, cap] | None).
    The k-th index of every list is added in pass k, so a pass adds to
    each target at most once: as many passes as the longest list."""
    B, cap = ok.shape
    dev = ok.device
    tgt = target.to(torch.int64)
    count = torch.zeros((B, cap), dtype=torch.int64, device=dev)
    count.index_add_(1, tgt, ok.to(torch.int64))
    count = count.clamp(max=1 << 24).to(torch.float32)
    if mode == "none":
        return count, None
    v = ftz(score.to(torch.float32))
    if mode == "sum":
        v = torch.where(ok, v, 0.0)
        flush = may_underflow(v)
        out = torch.zeros((B, cap), dtype=torch.float32, device=dev)
        idx, t_by_rank, counts = ranks
        lo = 0
        for n in counts:
            i, t = idx[lo:lo + n], t_by_rank[lo:lo + n]
            acc = out[:, t] + v[:, i]
            out[:, t] = ftz(acc) if flush else acc
            lo += n
        return count, out
    largest = mode == "max"
    keys = torch.where(ok, extreme_keys(v, largest), EXTREME_NONE)
    best = torch.full((B, cap), EXTREME_NONE, dtype=torch.int64, device=dev)
    best.scatter_reduce_(1, tgt[None, :].expand(B, -1), keys, reduce="amin",
                         include_self=True)
    return count, extreme_value(best, v, largest)
