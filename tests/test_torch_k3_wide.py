"""K3's wide dense clauses (fields wider than the 8 slots it holds in
registers, such as the passages' 64), as plain torch on the CPU.

The kernel reads a wide field's forward row once per table of its batch
tile's query terms (csrc/bundle_topk.cu, step 7): each slot's term is
looked up in the table, which gives each distinct term an entry of its
own, and its impact added to that term's hit, in slot order; each (row,
term) pair then reads its term's hit. `cuda_scoring.dense_table_hits_ref`
mirrors that lookup (the same multiplier search, entries and key
indices, `wide_tables_ref`); these tests hold it, bit for bit, to the
plain walk's slot-by-slot compare (hit + where(t == tq, imp, 0) over the
slots) at L 64, on the cases an exact table has to get right: terms in
two slots, padded slots of nonzero impact, padded query terms (-1),
terms that share an entry under the first multiplier, the most negative
id as a term, rows sharing terms, 1 and 2 tables (qm up to 8), a batch
short of a tile, and non-finite weights. The port alone; nothing here
needs the reference.
"""

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch.ops import cuda_scoring as cs

torch.set_num_threads(1)


def _slot_hits(tids, imps, qt):
    """The plain walk's hits: per (row, term, doc) a fold over the slots
    of hit + where(t == tq, imp, 0), from +0.0."""
    B, qm = qt.shape
    out = torch.zeros((B, qm, tids.shape[0]), dtype=torch.float32)
    for q in range(qm):
        hit = torch.zeros((B, tids.shape[0]), dtype=torch.float32)
        for l in range(tids.shape[1]):
            hit = hit + torch.where(tids[:, l][None, :] == qt[:, q:q + 1],
                                    imps[:, l][None, :],
                                    torch.zeros((), dtype=torch.float32))
        out[:, q] = hit
    return out


def _colliding(n, start=0):
    """n distinct term ids that share an entry under the first
    multiplier the table build tries (it must look further)."""
    ids = torch.arange(start, start + 20_000)
    h = cs._tab_entry(ids, cs._MULT0)
    return ids[h == h[0]][:n].tolist()


def _case(seed, B, qm, cap=600, L=64, n_terms=400):
    rng = np.random.default_rng(seed)
    tids = np.full((cap, L), -1, np.int32)
    for d in range(cap):
        row = np.unique(rng.integers(0, n_terms, size=rng.integers(5, 61)))
        tids[d, :row.size] = row
        if d % 7 == 0 and row.size < L:
            tids[d, row.size] = row[-1]            # a term in two slots
    imps = (rng.integers(1, 64, size=(cap, L)) / 16).astype(np.float32)
    imps[tids < 0] = 0.0
    imps[::11, -1] = 0.5                           # padded, nonzero
    imps[::13, 0] = -0.0
    qt = rng.integers(-1, n_terms // 2, size=(B, qm)).astype(np.int32)
    coll = _colliding(min(qm, 6), start=int(rng.integers(0, 50)))
    qt[0, :len(coll)] = coll                       # one hash chain
    if B > 2:
        qt[2] = qt[1]                              # rows sharing terms
    if B > 3:
        qt[3, 0] = -(1 << 31)                      # the most negative id
        tids[min(5, cap - 1), 3] = -(1 << 31)
    return torch.from_numpy(tids), torch.from_numpy(imps), \
        torch.from_numpy(qt)


@pytest.mark.parametrize("seed,B,qm", [(0, 8, 4), (1, 13, 3), (2, 16, 8),
                                       (3, 5, 1), (4, 9, 5), (5, 24, 6)])
def test_table_hits_equal_slot_compares(seed, B, qm):
    tids, imps, qt = _case(seed, B, qm)
    got = cs.dense_table_hits_ref(tids, imps, qt)
    want = _slot_hits(tids, imps, qt)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool((want > 0).any())


@pytest.mark.parametrize("seed,qm", [(6, 4), (7, 8)])
def test_table_hits_score_like_the_plain_walk(seed, qm):
    """The row scores from the tables' hits (s_leaf + hit * wq in term
    order) equal dense_score_ref's, non-finite weights included."""
    tids, imps, qt = _case(seed, 11, qm)
    wq = (torch.arange(11 * qm, dtype=torch.float32).reshape(11, qm) % 7
          + 0.25) / 3
    wq[qt < 0] = 0.0
    wq[0, 0], wq[1, 1] = float("inf"), float("nan")
    hits = cs.dense_table_hits_ref(tids, imps, qt)
    acc = torch.zeros((11, tids.shape[0]), dtype=torch.float32)
    for q in range(qm):
        acc = acc + hits[:, q] * wq[:, q:q + 1]
    want = cs.dense_score_ref(tids, imps, qt, wq)
    assert torch.equal(acc.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("B,qm", [(8, 4), (13, 8), (3, 2)])
def test_tables_give_every_term_an_entry(B, qm):
    """Each table gives every distinct term of its pairs an entry of its
    own (the perfect hash the kernel's multiplier search finds), and
    each (row, term) pair of the batch tile the key index of the first
    pair holding its term, rows past B copying the last."""
    _t, _i, qt = _case(B + qm, B, qm, cap=4)
    n_pairs = cs.BUNDLE_BT * cs.BUNDLE_WIDE_Q
    for i, tabs in enumerate(cs.wide_tables_ref(qt)):
        assert len(tabs) == -(-qm // cs.BUNDLE_WIDE_Q)
        for h, (mult, keys, index, key_of) in enumerate(tabs):
            assert mult % 2 == 1
            full = index >= 0
            assert int(full.sum()) <= n_pairs
            assert bool((cs._tab_entry(keys[full], mult)
                         == torch.nonzero(full).flatten()).all())
            for j in range(n_pairs):
                r, qq = divmod(j, cs.BUNDLE_WIDE_Q)
                q = h * cs.BUNDLE_WIDE_Q + qq
                if q >= qm:
                    assert int(key_of[j]) == -1
                    continue
                term = int(qt[min(i * cs.BUNDLE_BT + r, B - 1), q])
                k = int(key_of[j])
                assert k <= j and int(keys[cs._tab_entry(
                    torch.tensor(term), mult)]) == term
                assert int(index[cs._tab_entry(torch.tensor(term),
                                               mult)]) == k
