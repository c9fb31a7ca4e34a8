"""K3's launch plan in the PyTorch port, on the CPU: the host-side pieces
of the walk that the CUDA kernel takes as given.

(a) The sub-chunk plan (`cuda_scoring.bundle_chunk_tiles`): the
    sub-chunks cover a launch's tile span exactly once, hold at most
    `_BUNDLE_CHUNK_TILES` tiles, and are that long wherever the span
    still gives `_BUNDLE_MIN_ITEMS` work items (batch tile x sub-chunk;
    four times as many for a positional bundle);
    the plain walk follows the same plan, so the kernel and its plain
    version share one schedule.
(b) The positional parameter rows of a bundle (`_pos_param_rows`), which
    the kernel stages in shared memory, fit its `kMaxPW` ints a row for
    every bundle the executor admits, 1 to 8 clauses, dense, range and
    positional at their widest, and give each positional clause a slice
    of its own. (Whether the kernel's shared memory fits at these widths
    is asked of its entry, on the card: tests/test_torch_cuda.py.)

Exact integer checks; no tolerance.
"""

import pytest
import torch

from elasticsearch_tpu_torch.ops import cuda_scoring as cs


@pytest.mark.parametrize("B,nt,pos", [(1, 1, False), (8, 1024, False),
                                      (64, 1024, False), (256, 1024, False),
                                      (256, 128, False), (256, 7, False),
                                      (1024, 4096, False),
                                      (4096, 1 << 16, False),
                                      (256, 1024, True), (256, 128, True),
                                      (64, 128, True), (1, 5, True)])
def test_sub_chunks_cover_the_span_once(B, nt, pos):
    chunk = cs.bundle_chunk_tiles(B, nt, pos)
    n_sub = -(-nt // chunk)
    n_bt = -(-B // cs.BUNDLE_BT)
    assert 1 <= chunk <= cs._BUNDLE_CHUNK_TILES
    assert (n_sub - 1) * chunk < nt <= n_sub * chunk
    items = n_bt * n_sub
    full = -(-nt // cs._BUNDLE_CHUNK_TILES)
    min_items = cs._BUNDLE_MIN_ITEMS * (4 if pos else 1)
    if n_bt * full >= min_items:
        # enough items at full length: every sub-chunk but the last full
        assert chunk == -(-nt // full)
    else:
        # shorter sub-chunks, for about the minimum number of items (or
        # one tile each)
        assert items >= min(min_items, n_bt * nt) // 2
    # a positional bundle never gets fewer items than a dense one
    assert n_sub >= -(-nt // cs.bundle_chunk_tiles(B, nt)) or not pos


def _clause(i, B):
    """The i-th clause of a widest-case bundle: a dense clause of 8
    terms, a range, BM25F over 4 fields with 8 terms or an 8-term sloppy
    phrase, in turn."""
    kind = (i + 2) % 4
    if kind == 0:
        fields = ("a", "b", "c", "d")
        return (("should", "bm25f:4:8", fields, False),
                (torch.zeros((B, 4, 8), dtype=torch.int32),
                 torch.ones((B, 8)), torch.ones((B, 4)), torch.ones(B),
                 torch.ones(B, dtype=torch.int32), torch.ones(B)))
    if kind == 1:
        return (("must", "phrase_pos:8:s", "a", False),
                (torch.zeros((B, 8), dtype=torch.int32), torch.ones((B, 8)),
                 torch.ones(B), torch.zeros(B, dtype=torch.int32),
                 torch.ones(B), torch.ones(B, dtype=torch.int32),
                 torch.ones(B)))
    if kind == 2:
        return (("should", "terms_dense", "a", False),
                (torch.zeros((B, 8), dtype=torch.int32), torch.ones((B, 8)),
                 torch.ones(B, dtype=torch.int32), torch.ones(B)))
    return (("filter", "range_int", "n", False),
            (torch.zeros(B, dtype=torch.int32),
             torch.ones(B, dtype=torch.int32)))


@pytest.mark.parametrize("n_clauses", range(1, cs.BUNDLE_MAX_CLAUSES + 1))
def test_parameter_rows_fit_every_admitted_bundle(n_clauses):
    B = 256
    pairs = [_clause(i, B) for i in range(n_clauses)]
    clauses = tuple(c for c, _ in pairs)
    inputs = tuple(x for _, x in pairs)
    pp, offsets = cs._pos_param_rows(clauses, inputs, B)
    pw = 0 if pp is None else pp.shape[1]
    n_pos = sum(o is not None for o in offsets)
    assert pw <= cs.POS_MAX_PARAMS
    assert len(offsets) == n_clauses and (n_pos > 0) == (pw > 0)
    assert n_pos == sum(cs.bundle_positional((c,)) for c in clauses)
    # one slice per positional clause, in clause order, inside the row
    if pp is not None:
        assert pp.shape == (B, pw) and pp.dtype == torch.int32
        starts = [o for o in offsets if o is not None]
        assert starts == sorted(starts) and len(set(starts)) == n_pos
        assert 0 <= starts[0] and starts[-1] < pw
