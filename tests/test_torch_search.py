"""Port parity: Algorithm-1 stages of repro_torch against repro.core.search.

The port's stages run on the JAX index's own arrays, carried across with
``index_from_arrays``, so a gap found here is a fault of the stage under
test and not of the build.  Stage-1 state (positions and Hamming
distances after every tree) must be bit-equal; stage-2 distances meet the
repo's distance contract and ids may differ only inside distance ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jsq
from repro.core import search as js
from repro.core import sketch as jsk
from repro.index import HilbertIndex as JIndex
from repro.index import IndexConfig as JIndexConfig
from repro.core.types import ForestConfig as JForestConfig
from repro_torch.core import quantize as tq
from repro_torch.core import search as ts
from repro_torch.core import sketch as tsk
from repro_torch.data import ann_datasets as tdata
from repro_torch.index import SearchParams, index_from_arrays
from test_kernels_integration import (DIST_ATOL, DIST_RTOL,
                                      _assert_ids_equal_up_to_distance_ties)

_FOREST = dict(n_trees=4, bits=4, key_bits=128, leaf_size=16, seed=0)


@pytest.fixture(scope="module")
def pair():
    data, queries = tdata.lowrank_dataset_with_queries(3000, 40, 64, n_clusters=8,
                                                       r=4, seed=7)
    jidx = JIndex.build(jnp.asarray(data), JIndexConfig(
        forest=JForestConfig(**_FOREST), store_points=False))
    arrays = {k: np.asarray(v) for k, v in jidx._array_bundle().items()}
    tidx = index_from_arrays(arrays, jidx.config.to_dict(), device="cpu")
    return jidx, tidx, queries


@pytest.mark.parametrize("use_kernels", [True, False])
def test_stage1_best_pos_bit_equal_after_every_tree(pair, use_kernels):
    jidx, tidx, queries = pair
    k1, k2 = 16, 64
    jq, tq = jnp.asarray(queries), torch.from_numpy(queries)
    jqsk = jsk.make_sketches(jidx.quant, jq)
    tqsk = tsk.make_sketches(tidx.quant, tq)
    np.testing.assert_array_equal(np.asarray(jqsk).view(np.int32), tqsk.numpy())
    jbp = jnp.full((40, k2), -1, jnp.int32)
    jbd = jnp.full((40, k2), 2**30, jnp.int32)
    tbp = torch.full((40, k2), -1, dtype=torch.int32)
    tbd = torch.full((40, k2), 2**30, dtype=torch.int32)
    jf, tf = jidx.forest, tidx.forest
    common = dict(bits=4, key_bits=128, leaf_size=16, k1=k1, k2=k2)
    for t in range(4):
        jbp, jbd = js.stage1_tree_merge(
            jq, jqsk, jbp, jbd, jf.orders[t], jf.directories[t], jf.lo, jf.hi,
            jf.perms[t], jf.flips[t], jidx.master_rank, jidx.sketches_master,
            use_kernels=use_kernels, **common)
        tbp, tbd = ts.stage1_tree_merge(
            tq, tqsk, tbp, tbd, tf.orders[t], tf.directories[t], tf.lo, tf.hi,
            tf.perms[t], tf.flips[t], tidx.master_rank, tidx.sketches_master,
            use_kernels=use_kernels, **common)
        np.testing.assert_array_equal(np.asarray(jbp), tbp.numpy(), err_msg=f"tree {t}")
        np.testing.assert_array_equal(np.asarray(jbd), tbd.numpy(), err_msg=f"tree {t}")

    # Stage 2 from the same positions: the distance contract.
    for h, k in ((1, 8), (2, 30)):
        jids, jd = js.stage2_packed_windows(
            jq, jbp, jidx.codes_master, jidx.master_order, jidx.quant, h=h, k=k)
        tids, td = ts.stage2_packed_windows(
            tq, tbp, tidx.codes_master, tidx.master_order, tidx.quant, h=h, k=k,
            use_kernels=use_kernels)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=DIST_RTOL,
                                   atol=DIST_ATOL)
        _assert_ids_equal_up_to_distance_ties(jids, tids.numpy(), jd)


def test_fused_search_chunk_matches(pair):
    jidx, tidx, queries = pair
    kw = dict(bits=4, key_bits=128, leaf_size=16, k1=16, k2=64, h=1, k=8)
    jf, tf = jidx.forest, tidx.forest
    jids, jd = js.fused_search_chunk(
        jnp.asarray(queries), jf.orders, jf.directories, jf.lo, jf.hi, jf.perms,
        jf.flips, jidx.master_rank, jidx.sketches_master, jidx.codes_master,
        jidx.master_order, jidx.quant, **kw)
    tids, td = ts.fused_search_chunk(
        torch.from_numpy(queries), tf.orders, tf.directories, tf.lo, tf.hi,
        tf.perms, tf.flips, tidx.master_rank, tidx.sketches_master,
        tidx.codes_master, tidx.master_order, tidx.quant, use_kernels=True, **kw)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=DIST_RTOL,
                               atol=DIST_ATOL)
    _assert_ids_equal_up_to_distance_ties(jids, tids.numpy(), jd)


def test_merge_topk_dedup_tie_order_bit_equal():
    rng = np.random.default_rng(0)
    # Small ranges force duplicate positions and tied distances everywhere.
    best_pos = rng.integers(-1, 20, size=(6, 10)).astype(np.int32)
    best_dist = rng.integers(0, 4, size=(6, 10)).astype(np.int32)
    new_pos = rng.integers(0, 20, size=(6, 12)).astype(np.int32)
    new_dist = rng.integers(0, 4, size=(6, 12)).astype(np.int32)
    for k in (1, 10, 22):
        jp, jd = js._merge_topk_dedup(*(jnp.asarray(a) for a in
                                        (best_pos, best_dist, new_pos, new_dist)), k)
        tp, td = ts._merge_topk_dedup(*(torch.from_numpy(a) for a in
                                        (best_pos, best_dist, new_pos, new_dist)), k)
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())


def test_dedup_rank_topk_ties_and_padding_bit_equal():
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 15, size=(5, 12)).astype(np.int32)
    d2 = rng.integers(0, 3, size=(5, 12)).astype(np.float32) / 2
    valid = rng.random((5, 12)) < 0.8
    master_order = rng.permutation(15).astype(np.int32)
    for k in (3, 12, 20):
        jids, jd = js._dedup_rank_topk(jnp.asarray(pos), jnp.asarray(d2),
                                       jnp.asarray(valid), jnp.asarray(master_order), k)
        tids, td = ts._dedup_rank_topk(torch.from_numpy(pos), torch.from_numpy(d2),
                                       torch.from_numpy(valid),
                                       torch.from_numpy(master_order), k)
        np.testing.assert_array_equal(np.asarray(jids), tids.numpy())
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())


def test_expand_windows_and_slices_bit_equal():
    best_pos = np.array([[-1, 0, 5], [9, 2, 3]], dtype=np.int32)
    rows = np.arange(40, dtype=np.uint32).reshape(10, 4)
    for h in (0, 2, 7):
        js_starts, js_pos, jw = js._expand_windows(jnp.asarray(best_pos), 10, h)
        t_starts, t_pos, tw = ts._expand_windows(torch.from_numpy(best_pos), 10, h)
        assert jw == tw
        np.testing.assert_array_equal(np.asarray(js_starts), t_starts.numpy())
        np.testing.assert_array_equal(np.asarray(js_pos), t_pos.numpy())
        np.testing.assert_array_equal(
            np.asarray(js._window_slices(jnp.asarray(rows), js_starts, jw)),
            ts._window_slices(torch.from_numpy(rows.view(np.int32)), t_starts,
                              tw).numpy().view(np.uint32))


def test_paper_memory_model_matches():
    assert ts.paper_memory_model(1000, 384, 48000, 123) == js.paper_memory_model(
        1000, 384, 48000, 123)


def test_stage2_expand_rank_matches_jax_and_packed_path(pair):
    jidx, tidx, queries = pair
    rng = np.random.default_rng(2)
    n = tidx.n_points
    best_pos = rng.integers(-1, n, size=(40, 24)).astype(np.int32)
    best_pos[:, :3] = [0, n - 1, -1]  # both edges and padding
    jcodes = jsq.unpack_codes(jidx.codes_master, jidx.dim)
    tcodes = tq.unpack_codes(tidx.codes_master, tidx.dim)
    np.testing.assert_array_equal(np.asarray(jcodes), tcodes.numpy())
    jq, tqr, tbp = jnp.asarray(queries), torch.from_numpy(queries), torch.from_numpy(best_pos)
    for h, k in ((0, 5), (2, 30), (1, 200)):
        jids, jd = js.stage2_expand_rank(jq, jnp.asarray(best_pos), jcodes,
                                         jidx.master_order, jidx.quant, h=h, k=k)
        tids, td = ts.stage2_expand_rank(tqr, tbp, tcodes, tidx.master_order,
                                         tidx.quant, h=h, k=k)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=DIST_RTOL,
                                   atol=DIST_ATOL)
        _assert_ids_equal_up_to_distance_ties(jids, tids.numpy(), jd)
        pids, pd = ts.stage2_packed_windows(tqr, tbp, tidx.codes_master,
                                            tidx.master_order, tidx.quant, h=h, k=k)
        assert torch.equal(pids, tids) and torch.equal(pd, td)


def _tied_candidates(seed, q, c):
    rng = np.random.default_rng(seed)
    # Few ids and few distance values: duplicates and ties everywhere.
    ids = rng.integers(-1, 12, size=(q, c)).astype(np.int32)
    d = (rng.integers(0, 4, size=(q, c)) / 4).astype(np.float32)
    d[rng.random((q, c)) < 0.1] = np.inf
    return ids, d


@pytest.mark.parametrize("k", [1, 5, 24, 40])
def test_merge_topk_bit_equal_with_ties_and_padding(k):
    ids, d = _tied_candidates(k, 9, 24)
    jids, jd = js.merge_topk(jnp.asarray(ids), jnp.asarray(d), k=k)
    tids, td = ts.merge_topk(torch.from_numpy(ids), torch.from_numpy(d), k=k)
    np.testing.assert_array_equal(np.asarray(jids), tids.numpy())
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    assert tids.dtype == torch.int32 and td.shape == (9, k)


def test_merge_topk_signed_zero_order_bit_equal():
    # lax.top_k ranks -0.0 before +0.0; a plain torch.sort calls them equal.
    ids = np.array([[3, 3, 1, 1], [5, 6, 7, 8]], np.int32)
    d = np.array([[0.0, -0.0, -0.0, 0.0], [0.0, -0.0, 1.0, -1.0]], np.float32)
    jids, jd = js.merge_topk(jnp.asarray(ids), jnp.asarray(d), k=4)
    tids, td = ts.merge_topk(torch.from_numpy(ids), torch.from_numpy(d), k=4)
    np.testing.assert_array_equal(np.asarray(jids), tids.numpy())
    np.testing.assert_array_equal(np.signbit(np.asarray(jd)), np.signbit(td.numpy()))


@pytest.mark.parametrize("first", [True, False])
def test_merge_topk_pair_bit_equal(first):
    ia, da = _tied_candidates(10, 6, 8)
    ib, db = _tied_candidates(11, 6, 8)
    jout = js.merge_topk_pair(*(jnp.asarray(a) for a in (ia, da, ib, db)),
                              jnp.asarray(first), k=8)
    tout = ts.merge_topk_pair(*(torch.from_numpy(a) for a in (ia, da, ib, db)),
                              first, k=8)
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_inflate_k_matches():
    for k, dead, pool in ((10, 0, 50), (10, 45, 50), (0, 0, 5), (3, 2, 0)):
        assert ts.inflate_k(k, dead, pool) == js.inflate_k(k, dead, pool)


@pytest.mark.parametrize("k", [1, 7, 32])
def test_brute_force_topk_matches_jax(k):
    rng = np.random.default_rng(k)
    pts = rng.normal(size=(32, 16)).astype(np.float32)
    pts[5] = pts[9]  # an exact distance tie
    queries = rng.normal(size=(8, 16)).astype(np.float32)
    valid = rng.random(32) < 0.8
    jidx, jd = js.brute_force_topk(jnp.asarray(queries), jnp.asarray(pts),
                                   jnp.asarray(valid), k=k)
    tidx, td = ts.brute_force_topk(torch.from_numpy(queries), torch.from_numpy(pts),
                                   torch.from_numpy(valid), k=k)
    assert tidx.dtype == torch.int32 and tidx.shape == (8, k)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=DIST_RTOL,
                               atol=DIST_ATOL)
    _assert_ids_equal_up_to_distance_ties(jidx, tidx.numpy(), jd)


@pytest.mark.parametrize("backend", ["ref", "kernel"])
def test_unfused_search_equals_fused(pair, backend):
    _, tidx, queries = pair
    p = SearchParams(k1=16, k2=64, h=1, k=8)
    fused = tidx.search(queries, p, backend=backend, query_chunk=16)
    loop = tidx.search(queries, p, backend=backend, query_chunk=16, fused=False)
    assert torch.equal(fused[0], loop[0]) and torch.equal(fused[1], loop[1])
