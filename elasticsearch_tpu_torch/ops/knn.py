"""Exact kNN scoring: the similarity column and the exact candidate scan.

Counterpart of `elasticsearch_tpu/ops/knn.py`. `knn_score_column` is the
one definition of a doc's vector score: the exact scan (`knn_topk`), the
IVF probe (`ops/ann.py`) and the fused bundle engine's `knn_vec` clause
(search/executor.py) all call it, so a hybrid BM25+vector bundle and its
unfused evaluation read the same column. The transforms and their op
order are the reference's:

  cosine      -> (1 + clip(q_hat . x / max(|x|, 1e-12), -1, 1)) / 2
  dot_product -> (1 + q . x) / 2
  l2_norm     -> 1 / (1 + max(|x|^2 - 2 q . x + |q|^2, 0))

The product. The reference takes a bf16 x bf16 `dot_general` with f32
accumulation and an f32 result (`preferred_element_type`), a large
matrix product that XLA runs outside any Pallas kernel. Here it stays a
library call: on the card `torch.mm(q_bf16, v_bf16.T, out_dtype=f32)`
(cuBLAS, bf16 tensor cores, f32 accumulation and result; a plain bf16
`torch.matmul` would round its result to bf16), on the CPU the f32
product of the bf16-rounded operands. Products of bf16 values are exact
in f32, so the two differ from XLA only in the order of the f32 sums
over D: for vectors whose every partial sum is exact (small integers,
queries whose norm is a power of two) all three give the same bits, and
otherwise each sum lies within D * 2^-24 * sum |q_d x_d| of the exact
one.

The query's norm (`jnp.linalg.norm`, sqrt of a sum of squares) and the
l2 transform's sum of squares are XLA reductions: they are summed in
XLA's order (`ops/ordered.xla_block_sum`, centred windows of 32), which
is XLA's CPU result for every D above 32 (config 5's D is 256). At D of
32 and below XLA's CPU code contracts most lengths' squares into FMAs
inside a sequential fold, and there the port's norm can be an ulp off
(ROADMAP, departures); the tests at such D use queries whose sums are
exact. XLA's
CPU runtime flushes subnormals (ops/ordered.ftz): the query, the vector
values (flushed once at upload, search/executor.device_arrays) and the
product are flushed; every later step maps normal values to normal
values or to exactly the value a flush would give (1 + s == 1 for any
|s| < 2^-24). Inside its compiled programs (the exact scan, the probe,
the segment program) XLA contracts the l2 transform's |x|^2 - 2 q.x
into one fused multiply-add, and so does the port (`fma_rn`); the
reference's eager op-by-op call of knn_score_column does not.

Selection is exact top-k with ties to the lower doc (`ops/topk`), where
the reference's TPU path selects with `approx_max_k` on segments of
2^18 docs and more (on the CPU that returns `lax.top_k`'s result).
"""

from __future__ import annotations

import torch

from . import ordered
from .topk import top_k_values

SIMILARITIES = ("cosine", "dot_product", "l2_norm")


def _sum_sq(q: torch.Tensor) -> torch.Tensor:
    """jnp.sum(q * q, axis=1, keepdims=True) in XLA's order -> [B, 1]."""
    return ordered.xla_block_sum(ordered.ftz(q * q))[:, None]


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (XLA's): torch's vectorized
    f32 sqrt on the CPU is not, so the root is taken in f64 and rounded
    once (exact: f64 carries more than 2 * 24 + 2 bits)."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def fma_rn(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
           ) -> torch.Tensor:
    """fl(a * b + c) of f32 values, rounded once (an FMA), on any device:
    a * b is exact in f64; the f64 sum is taken with round-to-odd (its
    exact error by TwoSum, the last bit forced odd where it is not 0),
    and rounding that to f32 is the correctly rounded result."""
    x = a.to(torch.float64) * b.to(torch.float64)
    y = c.to(torch.float64)
    s = x + y
    bp = s - x
    err = (x - (s - bp)) + (y - bp)
    nudge = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    s = torch.where(nudge, torch.nextafter(s, torch.where(
        err > 0, float("inf"), float("-inf")).to(torch.float64)), s)
    return s.to(torch.float32)


def query_norm(q: torch.Tensor) -> torch.Tensor:
    """jnp.linalg.norm(q, axis=1, keepdims=True) of f32 rows -> [B, 1]."""
    return sqrt_rn(_sum_sq(q))


def bf16_dots(q: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """[B, D] f32 queries x [N, D] bf16 vectors -> [B, N] f32 dots of the
    bf16-rounded query with f32 accumulation, subnormals flushed."""
    qb = q.to(torch.bfloat16)
    vb = values if values.dtype == torch.bfloat16 \
        else values.to(torch.bfloat16)
    if vb.device.type == "cuda":
        dots = torch.mm(qb, vb.t(), out_dtype=torch.float32)
    else:
        dots = qb.float() @ vb.float().t()
    return ordered.ftz(dots)


def knn_score_column(values: torch.Tensor, norms: torch.Tensor,
                     exists: torch.Tensor, query: torch.Tensor, *,
                     similarity: str) -> torch.Tensor:
    """Transformed similarity of every row vector -> [B, N] f32; rows
    without a vector score 0. values: [N, D] (bf16 on the device, any
    float dtype); norms [N] f32; exists [N] bool; query [B, D]."""
    q = ordered.ftz(query.to(torch.float32))
    if similarity == "l2_norm":
        dots = bf16_dots(q, values)
        qn = _sum_sq(q)
        # XLA contracts |x|^2 - 2 q.x into fma(|x|, |x|, -2 q.x) inside
        # every compiled program that serves a search
        d2 = torch.clamp_min(ordered.ftz(ordered.ftz(
            fma_rn(norms[None, :], norms[None, :], -2.0 * dots)) + qn), 0.0)
        scores = 1.0 / (1.0 + d2)
    else:
        if similarity == "cosine":
            qn = query_norm(q)
            q = ordered.ftz(q / torch.clamp_min(qn, 1e-12))
        dots = bf16_dots(q, values)
        if similarity == "cosine":
            dots = dots / torch.clamp_min(norms[None, :], 1e-12)
            dots = torch.clamp(dots, -1.0, 1.0)  # bf16 rounding guard
        scores = (1.0 + dots) / 2.0
    return torch.where(exists[None, :], scores, 0.0)


def knn_topk(values: torch.Tensor, norms: torch.Tensor, exists: torch.Tensor,
             live: torch.Tensor, query: torch.Tensor, *, similarity: str,
             k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (scores [B, k], idx [B, k] int32) over one segment: the exact
    top-k of the similarity column over live docs with a vector, ties to
    the lower doc; entries past the valid docs are -inf."""
    valid = exists & live
    scores = knn_score_column(values, norms, exists, query,
                              similarity=similarity)
    scores = torch.where(valid[None, :], scores, float("-inf"))
    k = min(k, values.shape[0])
    return top_k_values(scores, k)
