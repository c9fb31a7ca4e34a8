"""The to-parent fold's layout on every nested segment the port builds.

The fold kernel (`to_parent_fold` in csrc/block_join.cu) reads each
position's list as the run of rows that ends at the position itself:
nested rows sit just before their parent and a primary row targets
itself. `cuda_scoring.block_join_layout` checks that property, refusing
a target without it, and lists the positions whose list goes to a warp
of its own (`long`). These tests hold the property on the layouts that
`executor.device_arrays` uploads for the port's nested segments: built by
the SegmentBuilder, after a parent's delete and a compaction
(`concat_segments`, `merge_segments`), after a store round trip, and in
a durable node through ingest, a delete, a force merge and a restart.
A target that breaks it is refused. The port alone, on the CPU; nothing
here needs the reference.
"""

import json

import numpy as np
import pytest
import torch

from elasticsearch_tpu_torch import corpus
from elasticsearch_tpu_torch.index.mapping import MapperService
from elasticsearch_tpu_torch.index.segment import (SegmentBuilder,
                                                   concat_segments,
                                                   merge_segments)
from elasticsearch_tpu_torch.index.store import Store
from elasticsearch_tpu_torch.node import Node
from elasticsearch_tpu_torch.ops import cuda_scoring as cs
from elasticsearch_tpu_torch.search import executor

torch.set_num_threads(1)

HOT = ((0, 400), (7, 60))


def _segment(docs, seg_id="s0"):
    svc = MapperService(mapping=corpus.QA_NESTED_MAPPING)
    b = SegmentBuilder()
    for did, src in docs:
        b.add(svc.parse(did, json.dumps(src)))
    return b.build(seg_id)


def _live(seg, dead):
    m = np.zeros(seg.capacity, dtype=bool)
    m[: seg.num_docs] = True
    for d in dead:
        m[seg.id_map[d]] = False
    return m


def assert_ranges(seg) -> np.ndarray:
    """The segment's uploaded fold layout is made of runs: the indices
    stably sorted by target are in their own order, every non-empty list
    is the run of rows ending at its position (its nested rows, then
    itself), and `long` lists exactly the positions whose list is longer
    than `long_len`. Returns the list lengths."""
    nest = executor.device_arrays(seg, "cpu")["nested"]
    cap = seg.capacity
    starts, target = nest["starts"].numpy(), nest["target"].numpy()
    np.testing.assert_array_equal(np.argsort(target, kind="stable"),
                                  np.arange(cap))
    n = np.diff(starts)
    p = np.nonzero(n)[0]
    np.testing.assert_array_equal(starts[p + 1], p + 1)
    for q in p:
        np.testing.assert_array_equal(target[starts[q]:q + 1], q)
    # a nested row's list is empty, and its parent comes after it
    child = seg.parent_of >= 0
    assert not n[child].any()
    assert (seg.parent_of[child] > np.nonzero(child)[0]).all()
    np.testing.assert_array_equal(nest["long"].numpy(),
                                  np.nonzero(n > nest["long_len"])[0])
    assert nest["long_len"] == cs.FOLD_LONG_LIST
    return n


@pytest.mark.parametrize("n,seed,hot", [(80, 5, HOT), (300, 6, ()),
                                        (150, 7, ((3, 33), (140, 32)))])
def test_built_segment_is_ranges(n, seed, hot):
    lens = assert_ranges(_segment(corpus.qa_nested_docs(n, seed=seed,
                                                        hot=hot)))
    assert lens.max() == max([k for _i, k in hot] + [0]) + 1 or not hot
    assert int((lens > cs.FOLD_LONG_LIST).sum()) == sum(
        k + 1 > cs.FOLD_LONG_LIST for _i, k in hot)


@pytest.mark.parametrize("how", ["concat", "merge"])
def test_compacted_segment_with_a_deleted_parent_is_ranges(how):
    docs = corpus.qa_nested_docs(120, seed=8, hot=((1, 40), (90, 50)))
    base, delta = _segment(docs[:80], "base"), _segment(docs[80:], "delta")
    live = {"base": _live(base, ("1", "5")), "delta": _live(delta, ("85",))}
    fold = concat_segments if how == "concat" else merge_segments
    folded = fold([base, delta], "folded", live_masks=live)
    assert "1" not in folded.id_map
    lens = assert_ranges(folded)
    # the hot question of the delta survives, the base's went with its
    # parent
    assert int((lens > cs.FOLD_LONG_LIST).sum()) == 1


def test_store_round_trip_is_ranges(tmp_path):
    seg = _segment(corpus.qa_nested_docs(60, seed=9, hot=((2, 45),)))
    store = Store(str(tmp_path))
    stem = store.save_segment(seg, _live(seg, ("4",)))
    loaded, _live_mask = Store(str(tmp_path)).load_segment(seg.seg_id,
                                                           stem=stem)
    assert_ranges(loaded)
    np.testing.assert_array_equal(
        executor.device_arrays(loaded, "cpu")["nested"]["starts"].numpy(),
        executor.device_arrays(seg, "cpu")["nested"]["starts"].numpy())


def _node_segments(node):
    return [s for e in node.indices["nested"].shards.values()
            for s in e.segments if s.has_nested]


def test_node_segments_are_ranges(tmp_path):
    """A durable node's nested segments after its ingest, a parent's
    delete and an update, a force merge and a restart."""
    settings = {"node.name": "l0", "path.data": str(tmp_path),
                "index.number_of_shards": 2}
    docs = corpus.qa_nested_docs(70, seed=18, hot=((2, 40), (9, 35)))
    node = Node(settings, device="cpu")
    try:
        node.create_index("nested", mappings=corpus.QA_NESTED_MAPPING)
        node.bulk([("index", {"_index": "nested", "_id": d, "doc": s})
                   for d, s in docs], refresh=True)
        steps = {"ingest": _node_segments(node)}
        node.delete_doc("nested", "2")
        node.index_doc("nested", "5", dict(docs[9][1], title="new"))
        node.refresh(None)
        steps["delete"] = _node_segments(node)
        node.force_merge(None)
        steps["force_merge"] = _node_segments(node)
        node.flush(None)
        node.close()
        node = Node(settings, device="cpu")
        steps["restart"] = _node_segments(node)
    finally:
        node.close()
    for step, segs in steps.items():
        assert segs, step
        for seg in segs:
            assert_ranges(seg)


def test_general_lists_take_the_csr_form():
    """A target whose lists are not runs ending at their position (a
    row after its parent, two lists interleaved, a target past the
    capacity) is a broken block order: the layout refuses it, so no
    general index-list form is needed. Runs are taken."""
    for target in ([2, 2, 2, 3, 3, 5], [2, 2, 1, 3],
                   [4, 1, 4, 3, 4, 5], [0, 0, 2, 3], [1, 1, 4, 4, 4, 6]):
        with pytest.raises(ValueError, match="block order"):
            cs.block_join_layout(torch.tensor(target, dtype=torch.int32))
    lay = cs.block_join_layout(torch.tensor([1, 1, 4, 4, 4, 5],
                                            dtype=torch.int32))
    np.testing.assert_array_equal(lay["starts"].numpy(),
                                  [0, 0, 2, 2, 2, 5, 6])
    np.testing.assert_array_equal(lay["long"].numpy(), [])


@pytest.mark.parametrize("cap", [1, 2, 3, 4, 5, 6])
def test_layout_check_equals_sorted_runs(cap):
    """The layout's check against its definition on every target of a
    small capacity: taken exactly where the indices stably sorted by
    target are in their own order and each non-empty list ends at its
    position; then `starts` is that CSR's and `long` its long lists."""
    import itertools
    for target in itertools.product(range(cap), repeat=cap):
        t = np.array(target)
        order = np.argsort(t, kind="stable")
        starts = np.searchsorted(t[order], np.arange(cap + 1))
        n = np.diff(starts)
        runs = bool((order == np.arange(cap)).all()) and bool(
            ((n == 0) | (starts[1:] == np.arange(1, cap + 1))).all())
        tt = torch.tensor(target, dtype=torch.int32)
        if not runs:
            with pytest.raises(ValueError):
                cs.block_join_layout(tt)
            continue
        lay = cs.block_join_layout(tt)
        np.testing.assert_array_equal(lay["starts"].numpy(), starts)
        np.testing.assert_array_equal(lay["long"].numpy(),
                                      np.nonzero(n > cs.FOLD_LONG_LIST)[0])
