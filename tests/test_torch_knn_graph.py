"""Port parity: Algorithm 2 (Task 2) of repro_torch against repro.core.knn_graph.

The port runs on the JAX index's own arrays, carried across with
``index_from_arrays``.  Per Hilbert order, the order, the rank and the
running top-k2 (ids and Hamming distances) must be bit-equal to the JAX
stages; the final graph meets the repo's distance contract, with ids equal
except inside distance ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import knn_graph as jkg
from repro.core.types import ForestConfig as JForestConfig
from repro.core.types import GraphParams as JGraphParams
from repro.index import HilbertIndex as JIndex
from repro.index import IndexConfig as JIndexConfig
from repro_torch.core import knn_graph as tkg
from repro_torch.data import ann_datasets as tdata
from repro_torch.index import (GraphParams, HilbertIndex, IndexConfig,
                               index_from_arrays)
from test_kernels_integration import (DIST_ATOL, DIST_RTOL,
                                      _assert_ids_equal_up_to_distance_ties)

_FOREST = dict(n_trees=2, bits=4, key_bits=128, leaf_size=16, seed=0)
_GRAPH = dict(n_orders=4, k1=16, k2=32, k=8)


@pytest.fixture(scope="module")
def pair():
    data = tdata.lowrank_embeddings(3000, 64, n_clusters=8, r=4, seed=3)
    jidx = JIndex.build(jnp.asarray(data), JIndexConfig(forest=JForestConfig(**_FOREST)))
    arrays = {k: np.asarray(v) for k, v in jidx._array_bundle().items()}
    tidx = index_from_arrays(arrays, jidx.config.to_dict(), device="cpu")
    assert tidx.points is not None
    return jidx, tidx


def test_every_order_bit_equal_to_jax(pair):
    jidx, tidx = pair
    n, d = tidx.points.shape
    p = GraphParams(**_GRAPH)
    jsk = jidx.sketches_master[jidx.master_rank]
    tsk = tidx.sketches_master[tidx.master_rank.long()]
    np.testing.assert_array_equal(np.asarray(jsk).view(np.int32), tsk.numpy())
    jf, tf = jidx.forest, tidx.forest
    curve = dict(bits=4, key_bits=128)
    jbi = jnp.full((n, p.k2), -1, jnp.int32)
    jbd = jnp.full((n, p.k2), 2**30, jnp.int32)
    tbi = torch.full((n, p.k2), -1, dtype=torch.int32)
    tbd = torch.full((n, p.k2), 2**30, dtype=torch.int32)
    rng = np.random.default_rng(p.seed)
    for o in range(p.n_orders):
        perm = rng.permutation(d).astype(np.int32)
        flip = rng.integers(0, 2, d).astype(bool)
        jorder, jrank = jkg.order_and_rank(jidx.points, jf.lo, jf.hi, jnp.asarray(perm),
                                           jnp.asarray(flip), **curve)
        torder, trank = tkg.order_and_rank(tidx.points, tf.lo, tf.hi,
                                           torch.from_numpy(perm),
                                           torch.from_numpy(flip), **curve)
        np.testing.assert_array_equal(np.asarray(jorder), torder.numpy(), f"order {o}")
        np.testing.assert_array_equal(np.asarray(jrank), trank.numpy(), f"order {o}")
        jbi, jbd = jkg.merge_order(jbi, jbd, jorder, jrank, jsk, k1=p.k1, k2=p.k2)
        # A ragged row chunk: chunking must change no bit.
        tbi, tbd = tkg.merge_order(tbi, tbd, torder, trank, tsk, k1=p.k1, k2=p.k2,
                                   chunk=1024)
        np.testing.assert_array_equal(np.asarray(jbi), tbi.numpy(), f"order {o}")
        np.testing.assert_array_equal(np.asarray(jbd), tbd.numpy(), f"order {o}")
    # The survivors of the whole loop are these.
    sbi, sbd = tkg.graph_survivors(tidx.points, tsk, p, lo=tf.lo, hi=tf.hi,
                                   chunk=999, **curve)
    assert torch.equal(sbi, tbi) and torch.equal(sbd, tbd)


def test_knn_graph_matches_jax(pair):
    jidx, tidx = pair
    jids, jd = jidx.knn_graph(JGraphParams(**_GRAPH))
    tids, td = tidx.knn_graph(GraphParams(**_GRAPH), chunk=1000)
    assert tids.dtype == torch.int32 and td.dtype == torch.float32
    assert tids.shape == (3000, 8)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=DIST_RTOL,
                               atol=DIST_ATOL)
    _assert_ids_equal_up_to_distance_ties(jids, tids.numpy(), jd)
    assert not (tids == torch.arange(3000, dtype=torch.int32)[:, None]).any()
    truth = tdata.exact_knn_graph(tidx.points.numpy(), 8)
    assert tdata.recall_at_k(tids.numpy(), truth) > 0.5


def test_save_load_knn_graph_bit_identical(tmp_path, pair):
    _, tidx = pair
    p = GraphParams(n_orders=2, k1=8, k2=16, k=4)
    tidx.save(str(tmp_path / "idx"))
    loaded = HilbertIndex.load(str(tmp_path / "idx"), device="cpu")
    g1, g2 = tidx.knn_graph(p), loaded.knn_graph(p)
    assert torch.equal(g1[0], g2[0]) and torch.equal(g1[1], g2[1])


def test_knn_graph_requires_stored_points(pair):
    _, tidx = pair
    slim = HilbertIndex.build(tidx.points[:200].numpy(), IndexConfig(
        forest=tidx.config.forest, store_points=False), device="cpu")
    assert slim.points is None
    with pytest.raises(ValueError, match="store_points"):
        slim.knn_graph(GraphParams(**_GRAPH))


def test_final_select_masks_padding_and_self():
    pts = torch.from_numpy(np.random.default_rng(0).normal(size=(6, 5)).astype(np.float32))
    best = torch.tensor([[-1, 0, 3, 2], [1, 1, 4, -1]], dtype=torch.int32)
    ids, d2 = tkg.final_select_chunk(pts, best, 0, k=3)
    jids, jd2 = jkg.final_select_chunk(jnp.asarray(pts.numpy()), jnp.asarray(best.numpy()),
                                       0, k=3)
    np.testing.assert_array_equal(np.asarray(jids), ids.numpy())
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=DIST_RTOL,
                               atol=DIST_ATOL)
    assert torch.isinf(d2[0, 2]) and torch.isinf(d2[1, 2])  # self / -1 ranked last
