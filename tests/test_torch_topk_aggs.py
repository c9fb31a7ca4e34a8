"""Top-k and aggregation primitives of the PyTorch port vs the JAX
reference, on the CPU.

Tolerances: exact for indices, tie order, totals, bucket ids and counts,
and for the float sums of the sorted and view reduces, which the port
takes in XLA's order (ops/ordered.py; tests/test_torch_ordered_aggs.py
pins that order on non-integer weights).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elasticsearch_tpu.ops import aggs as ref_aggs
from elasticsearch_tpu.ops import topk as ref_topk
from elasticsearch_tpu.search import executor as ref_ex

from elasticsearch_tpu_torch.ops import aggs as port_aggs
from elasticsearch_tpu_torch.ops import topk as port_topk
from elasticsearch_tpu_torch.search import executor as port_ex

torch.set_num_threads(1)
I32 = np.iinfo(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class TestTopK:
    @pytest.mark.parametrize("k", [1, 5, 16])
    def test_top_k_hits_ties_and_empty_rows(self, k):
        rng = np.random.default_rng(k)
        B, cap = 6, 300
        # few distinct values: long runs of exact ties everywhere
        scores = rng.integers(0, 4, size=(B, cap)).astype(np.float32) * 0.5
        valid = rng.random((B, cap)) < 0.5
        valid[1] = False                      # a row with no hit at all
        valid[2, :] = False
        valid[2, [3, 250]] = True             # fewer hits than k
        scores[3, :] = 1.25                   # every doc tied
        ref = ref_topk.top_k_hits(jnp.asarray(scores), jnp.asarray(valid), k)
        got = port_topk.top_k_hits(_t(scores), _t(valid), k)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(_np(g), np.asarray(r))
        assert got[1].dtype == torch.int32 and got[2].dtype == torch.int32

    def test_negative_zero_and_inf_order(self):
        scores = np.array([[0.0, -0.0, -np.inf, 3.0, -1.0, 0.0, np.inf]],
                          np.float32)
        valid = np.ones_like(scores, dtype=bool)
        valid[0, 6] = False
        ref = ref_topk.top_k_hits(jnp.asarray(scores), jnp.asarray(valid), 7)
        got = port_topk.top_k_hits(_t(scores), _t(valid), 7)
        np.testing.assert_array_equal(_np(got[1]), np.asarray(ref[1]))
        np.testing.assert_array_equal(_np(got[0]), np.asarray(ref[0]))

    @pytest.mark.parametrize("descending", [True, False])
    def test_top_k_by_field_int32_saturation(self, descending):
        rng = np.random.default_rng(int(descending))
        B, cap, k = 4, 200, 12
        keys = rng.integers(-3, 3, size=cap).astype(np.int32)
        keys[[5, 17, 40]] = I32.min           # negation must saturate
        keys[[6, 90]] = I32.max
        keys[[7, 8]] = I32.min + 1
        missing = rng.random(cap) < 0.2
        valid = rng.random((B, cap)) < 0.7
        valid[3] = False
        ref = ref_topk.top_k_by_field(jnp.asarray(keys), jnp.asarray(valid),
                                      jnp.asarray(missing), k, descending)
        got = port_topk.top_k_by_field(_t(keys), _t(valid), _t(missing), k,
                                       descending)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(_np(g), np.asarray(r))

    @pytest.mark.parametrize("descending", [True, False])
    def test_top_k_by_field_float_per_row_keys(self, descending):
        rng = np.random.default_rng(9)
        B, cap, k = 3, 150, 10
        keys = (rng.integers(0, 5, size=(B, cap)) * 0.25).astype(np.float32)
        keys[0, :4] = np.finfo(np.float32).max
        missing = rng.random(cap) < 0.3
        valid = rng.random((B, cap)) < 0.6
        ref = ref_topk.top_k_by_field(jnp.asarray(keys), jnp.asarray(valid),
                                      jnp.asarray(missing), k, descending)
        got = port_topk.top_k_by_field(_t(keys), _t(valid), _t(missing), k,
                                       descending)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(_np(g), np.asarray(r))


class TestBuckets:
    def _ids(self, rng, cap, n_buckets):
        # ids past either end: JAX wraps [-n, 0) numpy-style and drops
        # the rest; torch scatters must do the same, not clamp
        return rng.integers(-n_buckets - 3, n_buckets + 4, size=cap).astype(np.int32)

    def test_scatter_family_drops_oob(self):
        rng = np.random.default_rng(1)
        B, cap, nb = 3, 400, 9
        ids = self._ids(rng, cap, nb)
        mask = rng.random((B, cap)) < 0.6
        vals = rng.integers(-50, 50, size=cap).astype(np.int32)
        for name in ("bucket_sums", "bucket_min", "bucket_max",
                     "bucket_sum_sq"):
            r = getattr(ref_aggs, name)(jnp.asarray(ids), jnp.asarray(mask),
                                        jnp.asarray(vals), nb)
            g = getattr(port_aggs, name)(_t(ids), _t(mask), _t(vals), nb)
            np.testing.assert_array_equal(_np(g), np.asarray(r), err_msg=name)
        r = ref_aggs.bucket_counts(jnp.asarray(ids), jnp.asarray(mask), nb)
        g = port_aggs.bucket_counts(_t(ids), _t(mask), nb)
        np.testing.assert_array_equal(_np(g), np.asarray(r))

    @pytest.mark.parametrize("Np", [100, 256, 1024])
    @pytest.mark.parametrize("per_row", [False, True])
    def test_view_group_reduce_int32_counts(self, Np, per_row):
        rng = np.random.default_rng(Np)
        B, G = 4, 7
        w = rng.random((B, Np)) < 0.5
        if per_row:
            bounds = np.sort(rng.integers(0, Np + 1, size=(B, G + 1)),
                             axis=1).astype(np.int32)
            bounds[:, -1] = Np                # bound at the very end
        else:
            bounds = np.sort(rng.integers(0, Np + 1, size=G + 1)
                             ).astype(np.int32)
            bounds[0], bounds[-1] = 0, Np
        r = ref_aggs.view_group_reduce(jnp.asarray(w), jnp.asarray(bounds),
                                       int_weights=True)
        g = port_aggs.view_group_reduce(_t(w), _t(bounds), int_weights=True)
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(_np(g), np.asarray(r))
        wf = (rng.integers(0, 9, size=(B, Np)) * 0.5).astype(np.float32)
        r = ref_aggs.view_group_reduce(jnp.asarray(wf), jnp.asarray(bounds))
        g = port_aggs.view_group_reduce(_t(wf), _t(bounds))
        np.testing.assert_array_equal(_np(g), np.asarray(r))

    def test_view_group_reduce_float_sums_rtol(self):
        # exact: the port takes the block sums, the short cumsum and the
        # intra-block prefix in XLA's order (ops/ordered.py)
        rng = np.random.default_rng(4)
        w = rng.random((2, 2048), dtype=np.float32) * 1e4
        bounds = np.array([0, 3, 511, 512, 1500, 2048], np.int32)
        r = ref_aggs.view_group_reduce(jnp.asarray(w), jnp.asarray(bounds))
        g = port_aggs.view_group_reduce(_t(w), _t(bounds))
        np.testing.assert_array_equal(_np(g).view(np.int32),
                                      np.asarray(r).view(np.int32))

    def test_sorted_group_and_hist_reduce(self):
        rng = np.random.default_rng(2)
        B, cap, G = 3, 256, 6
        ords = rng.integers(-1, G, size=cap).astype(np.int32)
        perm = np.argsort(ords, kind="stable").astype(np.int32)
        starts = np.searchsorted(ords[perm], np.arange(G + 1)
                                 ).astype(np.int32)
        w = rng.integers(0, 3, size=(B, cap)).astype(np.float32)
        r = ref_aggs.sorted_group_reduce(jnp.asarray(perm),
                                         jnp.asarray(starts), jnp.asarray(w))
        g = port_aggs.sorted_group_reduce(_t(perm), _t(starts), _t(w))
        np.testing.assert_array_equal(_np(g), np.asarray(r))
        vals = rng.integers(0, 1000, size=cap).astype(np.int32)
        perm = np.argsort(vals, kind="stable").astype(np.int32)
        edges = np.array([0, 100, 250, 250, 999, I32.max], np.int32)
        r = ref_aggs.sorted_hist_reduce(jnp.asarray(vals[perm]),
                                        jnp.asarray(perm), jnp.asarray(w),
                                        jnp.asarray(edges))
        g = port_aggs.sorted_hist_reduce(_t(vals[perm]), _t(perm), _t(w),
                                         _t(edges))
        np.testing.assert_array_equal(_np(g), np.asarray(r))

    def test_bucket_id_helpers(self):
        rng = np.random.default_rng(3)
        cap = 300
        ords = rng.integers(-1, 5, size=cap).astype(np.int32)
        s2g = np.array([4, 0, 9, 2, 7], np.int32)
        r = ref_aggs.keyword_bucket_ids(jnp.asarray(ords), jnp.asarray(s2g),
                                        16)
        g = port_aggs.keyword_bucket_ids(_t(ords), _t(s2g), 16)
        np.testing.assert_array_equal(_np(g), np.asarray(r))
        secs = (1_420_070_400 + rng.integers(-100, 40 * 86400, size=cap)
                ).astype(np.int32)
        exists = rng.random(cap) < 0.9
        for origin, interval, nb in ((1_420_070_400, 86400, 32),
                                     (1_420_070_400, 3600, 8)):
            r = ref_aggs.fixed_histogram_bucket_ids(
                jnp.asarray(secs), jnp.asarray(exists), np.asarray(origin),
                np.asarray(interval), nb)
            g = port_aggs.fixed_histogram_bucket_ids(
                _t(secs), _t(exists), torch.tensor(origin, dtype=torch.int32),
                torch.tensor(interval, dtype=torch.int32), nb)
            np.testing.assert_array_equal(_np(g), np.asarray(r))
        fv = (rng.random(cap) * 100 - 10).astype(np.float32)
        r = ref_aggs.fixed_histogram_bucket_ids(
            jnp.asarray(fv), jnp.asarray(exists), np.float32(-5.0),
            np.float32(7.5), 16)
        g = port_aggs.fixed_histogram_bucket_ids(
            _t(fv), _t(exists), torch.tensor(-5.0), torch.tensor(7.5), 16)
        np.testing.assert_array_equal(_np(g), np.asarray(r))
        edges = np.array([1_420_070_400, 1_422_748_800, 1_425_168_000,
                          I32.max, I32.max], np.int32)
        r = ref_aggs.edges_bucket_ids(jnp.asarray(secs), jnp.asarray(exists),
                                      jnp.asarray(edges), 4)
        g = port_aggs.edges_bucket_ids(_t(secs), _t(exists), _t(edges), 4)
        np.testing.assert_array_equal(_np(g), np.asarray(r))

    def test_masked_stats(self):
        rng = np.random.default_rng(6)
        vals = rng.integers(100, 100_000, size=512).astype(np.int32)
        exists = rng.random(512) < 0.8
        mask = rng.random((3, 512)) < 0.5
        mask[2] = False
        r = ref_aggs.masked_stats(jnp.asarray(vals), jnp.asarray(exists),
                                  jnp.asarray(mask))
        g = port_aggs.masked_stats(_t(vals), _t(exists), _t(mask))
        # sum / sum_sq exact too: XLA's reduction order at a
        # power-of-two row (ops/ordered.xla_block_sum)
        for key in ("count", "min", "max", "sum", "sum_sq"):
            np.testing.assert_array_equal(_np(g[key]), np.asarray(r[key]))

    @pytest.mark.parametrize("origin,interval", [
        (2 ** 31 - 5 * 86400, 86400),     # padded tail overflows int32
        (-(2 ** 31) + 10, 2 ** 30),       # offsets wrap in int32
        (1_420_070_400, 86400),
    ])
    def test_hist_edges_int32_overflow_clamp(self, origin, interval):
        params_np = (np.asarray(origin, np.int32),
                     np.asarray(interval, np.int32))
        r = ref_ex._hist_edges_for("hist_fixed", tuple(
            jnp.asarray(p) for p in params_np), 16, jnp.int32)
        g = port_ex._hist_edges_for("hist_fixed", tuple(
            _t(p) for p in params_np), 16, torch.int32, torch.device("cpu"))
        np.testing.assert_array_equal(_np(g), np.asarray(r))
