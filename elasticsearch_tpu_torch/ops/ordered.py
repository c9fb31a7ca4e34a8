"""f32 sums in the reference's exact order, as plain torch on any device.

The reference computes its agg sums with `jnp.cumsum` and `.sum(-1)`
outside any Pallas kernel, and XLA fixes the order of those f32 adds:

* `jnp.cumsum` over the last axis is a recursive blocked scan of base
  16 (`xla_cumsum`): the row splits into blocks of 16, the last one
  zero-padded; each block takes its inclusive prefix sequentially from
  +0.0; the block totals are scanned by the same rule, recursively, until
  16 or fewer remain (then sequentially); an output is
  fl(exclusive prefix of its block + its intra-block prefix). A row of
  one element is returned as it is.
* `.sum(-1)` is a tree of windows (`xla_block_sum`): while more than 32
  values remain, they split into k = ceil(n / 32) windows of
  ceil(n / k) values (the last zero-padded), each summed sequentially
  from +0.0; the last 32 or fewer are summed sequentially. For the
  128- and 512-wide blocks of `ops/aggs.view_group_reduce` that is runs
  of 32, then the runs in order.

Every add here is its own elementwise torch op, so the CPU and the card
round alike (no FMA, no reassociation); tests/test_torch_ordered_aggs.py
pins both orders against JAX itself. The window tree matches `.sum(-1)`
on rows of a power-of-two length (every capacity SegmentBuilder makes)
and on 128- / 512-wide blocks; on other lengths XLA's order was not
pinned, and masked_stats' sums are held to the bound ROADMAP.md states.

`prefix_at` is the plain version of the card's scan kernel
(`ops/cuda_scoring.ordered_prefix`), `xla_block_sum` of its tree entry
(`ops/cuda_scoring.ordered_sum`).
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
    """The (window, windows) levels of XLA's reduction tree over n values;
    the last level is one window of all that remain."""
    levels = []
    while n > SUM_WINDOW:
        k = -(-n // SUM_WINDOW)
        w = -(-n // k)
        levels.append((w, k))
        n = k
    levels.append((max(n, 1), 1))
    return levels


def xla_block_sum(x: torch.Tensor) -> torch.Tensor:
    """`x.sum(-1)` of a float row in XLA's window-tree order: for a
    128- or 512-wide block, runs of 32 summed in order, then the runs."""
    for w, k in sum_windows(x.shape[-1]):
        x = torch.nn.functional.pad(x, (0, w * k - x.shape[-1]))
        x = _seq_sum(x.reshape(*x.shape[:-1], k, w))
    return x[..., 0]


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
