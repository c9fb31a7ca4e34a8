"""Top-k selection over dense score/sort-key arrays.

Counterpart of `elasticsearch_tpu/ops/topk.py`. The reference rests its
tie contract on `lax.top_k`, which prefers the lower index on equal
keys; doc ids are positional, so ties resolve to the lower doc id.
`torch.topk` leaves the order of equal keys unspecified, so every
selection here runs on a composite int64 key: the order-preserving
int32 image of the value in the high word and the inverted index in the
low word. Composite keys are unique, so any correct top-k over them
returns the reference's order, on the CPU and on the card alike.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")
_I32_MIN = -(2 ** 31)
_I32_MAX = 2 ** 31 - 1
_F32_LOWEST = -3.4028234663852886e38


def f32_order_key(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 with the same total order (-0.0 just below +0.0;
    NaN is never produced by the scoring paths)."""
    i = x.contiguous().view(torch.int32)
    return torch.where(i < 0, i ^ _I32_MAX, i)


def topk_indices(key: torch.Tensor, k: int) -> torch.Tensor:
    """Indices [B, k] of the k largest int32 keys per row, descending,
    equal keys in ascending index order (the lax.top_k contract)."""
    n = key.shape[-1]
    low = (n - 1) - torch.arange(n, dtype=torch.int64, device=key.device)
    comp = (key.to(torch.int64) << 32) | low
    top = torch.topk(comp, k, dim=-1, sorted=True).values
    return (n - 1) - (top & 0xFFFFFFFF)


def top_k_values(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """lax.top_k over float32 rows -> (values [B, k], indices int32 [B, k])."""
    idx = topk_indices(f32_order_key(x), k)
    return x.gather(-1, idx), idx.to(torch.int32)


def running_topk_init(b: int, k: int, device=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Empty running top-k state: (-inf scores, index 0 placeholders).
    Entries beyond a query's total hit count stay -inf with undefined
    indices, the contract top_k_hits callers already honour."""
    return (torch.full((b, k), NEG_INF, dtype=torch.float32, device=device),
            torch.zeros((b, k), dtype=torch.int32, device=device))


def running_topk_merge(top_s: torch.Tensor, top_i: torch.Tensor,
                       cand_s: torch.Tensor, cand_i: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold candidates [B, ck] into the running top-k [B, k]. The
    existing state goes FIRST: equal scores go to the lower position, so
    docs already in the state (earlier tiles or segments, lower doc ids)
    win ties against new candidates, and each side keeps its own
    ascending-doc-id tie order, as one top-k over the whole score array
    would."""
    k = top_s.shape[1]
    all_s = torch.cat([top_s, cand_s], dim=1)
    all_i = torch.cat([top_i, cand_i.to(top_i.dtype)], dim=1)
    m_s, m_pos = top_k_values(all_s, k)
    return m_s, all_i.gather(1, m_pos.to(torch.int64))


def top_k_hits(scores: torch.Tensor, valid: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(scores [B,cap], valid [B,cap]) -> (top_scores [B,k], top_idx [B,k],
    total_hits [B]). Invalid docs get -inf and can be recognized by the
    caller via total_hits / -inf scores."""
    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    top_scores, top_idx = top_k_values(masked, k)
    total = valid.sum(dim=-1, dtype=torch.int32)
    return top_scores, top_idx, total


def top_k_by_field(sort_key: torch.Tensor, valid: torch.Tensor,
                   missing: torch.Tensor, k: int, descending: bool = True
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Field sort -> (top_key [B,k], top_idx, total [B], top_missing [B,k]).

    sort_key: [cap] or [B, cap]; missing: [cap] bool (docs without the
    field sort LAST among matching docs but still above non-matching
    docs). int32 keys stay int32 end-to-end, with the reference's
    saturation of i32.min under ascending negation."""
    is_int = sort_key.dtype == torch.int32
    if sort_key.dim() == 1:
        sort_key = sort_key[None, :]
    miss = missing[None, :]
    if is_int:
        if descending:
            key = torch.where(miss, _I32_MIN + 1, sort_key)
        else:
            neg = torch.where(sort_key == _I32_MIN, _I32_MAX, -sort_key)
            key = torch.where(miss, _I32_MIN + 1, neg)
        masked = torch.where(valid, key, _I32_MIN)
        order = masked
    else:
        key = sort_key if descending else -sort_key
        key = torch.where(miss, _F32_LOWEST, key)
        masked = torch.where(valid, key, NEG_INF)
        order = f32_order_key(masked)
    order = order.expand(valid.shape)
    top_idx = topk_indices(order, k)
    total = valid.sum(dim=-1, dtype=torch.int32)
    top_missing = miss.expand(valid.shape).gather(1, top_idx)
    out_key = sort_key.expand(valid.shape).gather(1, top_idx)
    return out_key, top_idx.to(torch.int32), total, top_missing
