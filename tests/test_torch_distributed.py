"""Port parity: the sharded sort, Task-2 graph and merges of repro_torch.core.distributed.

The port runs S logical shards on the CPU; the JAX package's functions run
in this process on its one device: the merges and collectives under
``jax.vmap(..., axis_name="data")`` (the same collectives ``shard_map``
would run), the partition on ``data_mesh(1)``, the halo windows and the
routing home on a 1-device mesh fed the port's own sample sort.  Integers
are bit-equal; distances meet the contract of
``tests/test_kernels_integration.py``.  The JAX package's 4-device run of
the same pieces is held to the port in ``tests/test_torch_sharded.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.core import distributed as jdist
from repro.core import hilbert as jhilbert
from repro.core import quantize as jquant
from repro.core import sketch as jsketch
from repro.core.types import ForestConfig as JForestConfig
from repro.launch.mesh import data_mesh
from repro_torch.core import distributed as tdist
from repro_torch.core import quantize as tquant
from repro_torch.core.shard_group import ShardGroup
from repro_torch.core.types import ForestConfig, GraphParams
from repro_torch.data import ann_datasets
from repro_torch.index import HilbertIndex, IndexConfig
from test_kernels_integration import DIST_ATOL, DIST_RTOL

N, D = 2048, 24
FOREST = dict(n_trees=2, bits=4, key_bits=96, leaf_size=16, seed=0)
TCFG, JCFG = ForestConfig(**FOREST), JForestConfig(**FOREST)
# scripts/distributed_check.py's graph (k1 even: the halo windows are exact).
GRAPH = dict(n_orders=12, k1=32, k2=64, k=10)
PARITY_ORDERS = 3  # orders of the 1- against 4-shard bit-equality
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def data():
    """N + 3 float32 rows (the last 3 make a count no shard count divides)."""
    return ann_datasets.lowrank_embeddings(N + 3, D, n_clusters=8, seed=0)


def _vmap(fn, *args):
    return jax.vmap(fn, axis_name="data")(*(jnp.asarray(a) for a in args))


def _words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# -- collectives -----------------------------------------------------------


@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_shard_group_collectives_match_lax(s):
    g = ShardGroup(s, CPU)
    rng = np.random.default_rng(s)
    x = rng.integers(-50, 50, (s, s, 3, 2)).astype(np.int32)
    y = rng.standard_normal((s, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        g.all_to_all(torch.from_numpy(x)).numpy(),
        np.asarray(_vmap(lambda v: lax.all_to_all(v, "data", 0, 0, tiled=False), x)))
    gathered = np.asarray(_vmap(lambda v: lax.all_gather(v, "data"), y))
    for r in range(s):
        np.testing.assert_array_equal(g.all_gather(torch.from_numpy(y)).numpy(),
                                      gathered[r])
    for perm in ([(i, (i + 1) % s) for i in range(s)], [(i, i ^ 1) for i in range(s)]
                 if s > 1 else [(0, 0)]):
        np.testing.assert_array_equal(
            g.ppermute(torch.from_numpy(y), perm).numpy(),
            np.asarray(_vmap(lambda v: lax.ppermute(v, "data", perm), y)))
    np.testing.assert_array_equal(g.pmin(torch.from_numpy(y)).numpy(),
                                  np.asarray(_vmap(lambda v: lax.pmin(v, "data"), y)))
    np.testing.assert_array_equal(g.axis_index().numpy(),
                                  np.asarray(_vmap(lambda v: lax.axis_index("data"), y)))


def test_ppermute_sends_zeros_to_unnamed_ranks():
    g = ShardGroup(4, CPU)
    got = g.ppermute(torch.arange(1, 5, dtype=torch.float32)[:, None], [(0, 1), (1, 2)])
    assert got[:, 0].tolist() == [0.0, 1.0, 2.0, 0.0]
    with pytest.raises(ValueError):
        g.ppermute(torch.zeros(4, 1), [(0, 1), (2, 1)])
    with pytest.raises(ValueError):
        g.all_to_all(torch.zeros(4, 3, 2))


# -- cross-shard merges ----------------------------------------------------


def _merge_inputs(s, q=6, c=12, seed=0):
    """Pools with duplicate ids within and across shards, -1 slots, +inf
    distances and distance ties."""
    rng = np.random.default_rng(seed + s)
    ids = rng.integers(-1, 40, (s, q, c)).astype(np.int32)
    d2 = (rng.integers(0, 24, (s, q, c)) / 4).astype(np.float32)
    d2[rng.random((s, q, c)) < 0.1] = np.inf
    return ids, d2


@pytest.mark.parametrize("k", [5, 200])
@pytest.mark.parametrize("merge,prune", [("gather", False), ("tree", False),
                                         ("tree", True)])
@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_cross_shard_merge_bit_equal_to_jax(s, merge, prune, k):
    ids, d2 = _merge_inputs(s)
    ji, jd = _vmap(lambda i, d: jdist.cross_shard_merge_topk(
        i, d, k=k, axis="data", axis_size=s, merge=merge, prune=prune), ids, d2)
    ti, td = tdist.cross_shard_merge_topk(ShardGroup(s, CPU), torch.from_numpy(ids),
                                          torch.from_numpy(d2), k=k, merge=merge,
                                          prune=prune)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


@pytest.mark.parametrize("s", [2, 4, 8])
def test_tree_and_gather_merges_bit_equal_to_jax(s):
    ids, d2 = _merge_inputs(s, seed=7)
    g, ti, td = ShardGroup(s, CPU), torch.from_numpy(ids), torch.from_numpy(d2)
    ref_tree = _vmap(lambda i, d: jdist.tree_merge_topk(i, d, k=8, axis="data",
                                                        axis_size=s), ids, d2)
    ref_gather = _vmap(lambda i, d: jdist.gather_merge_topk(i, d, k=8, axis="data"),
                       ids, d2)
    for (ri, rd), (gi, gd) in ((ref_tree, tdist.tree_merge_topk(g, ti, td, k=8)),
                               (ref_gather, tdist.gather_merge_topk(g, ti, td, k=8))):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))
    # Every rank of the butterfly ends with the same result.
    tree_i, _ = tdist.tree_merge_topk(g, ti, td, k=8, prune=True)
    assert all(torch.equal(tree_i[0], tree_i[r]) for r in range(s))


def test_resolve_merge_policy_matches_jax():
    for n in range(1, 10):
        for merge in ("auto", "gather", "tree", "flat"):
            try:
                want = jdist.resolve_merge(merge, n)
            except ValueError:
                with pytest.raises(ValueError):
                    tdist.resolve_merge(merge, n)
                continue
            assert tdist.resolve_merge(merge, n) == want
            assert tdist.is_pow2(n) == jdist.is_pow2(n)


# -- partition ---------------------------------------------------------------


@pytest.mark.parametrize("extra", [0, 3])
@pytest.mark.parametrize("s", [3, 4, 8])
def test_hilbert_partition_bit_equal_to_jax(data, s, extra):
    pts = data[: N + extra]
    want = jdist.hilbert_partition(jnp.asarray(pts), JCFG, mesh=data_mesh(1), n_shards=s)
    got = tdist.hilbert_partition(torch.from_numpy(pts), TCFG, s)
    assert len(got) == s
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("s,n", [(1, N), (2, N), (3, N + 1), (4, N), (8, N)])
def test_sample_sort_prefixes_are_the_master_order(data, s, n, permuted):
    """Concatenated valid prefixes: JAX's single sort, keys and rows.  At
    S = 3 the JAX sample sort would drop its top bucket (below)."""
    pts = data[:n]
    lo, hi = pts.min(0), pts.max(0)
    rng = np.random.default_rng(s)
    perm = rng.permutation(D).astype(np.int32) if permuted else None
    flip = rng.integers(0, 2, D).astype(bool) if permuted else None
    jorder, jkeys = jhilbert.hilbert_sort(
        jnp.asarray(pts), bits=4, key_bits=96, lo=jnp.asarray(lo), hi=jnp.asarray(hi),
        perm=None if perm is None else jnp.asarray(perm),
        flip=None if flip is None else jnp.asarray(flip))
    keys_o, pay_o, n_valid, ovf = tdist.distributed_hilbert_order(
        ShardGroup(s, CPU), torch.from_numpy(pts), TCFG, torch.from_numpy(lo),
        torch.from_numpy(hi), None if perm is None else torch.from_numpy(perm),
        None if flip is None else torch.from_numpy(flip))
    assert int(ovf.sum()) == 0 and int(n_valid.sum()) == n
    nv = n_valid.tolist()
    np.testing.assert_array_equal(
        np.concatenate([pay_o["gid"][r, : nv[r]].numpy() for r in range(s)]),
        np.asarray(jorder))
    np.testing.assert_array_equal(
        np.concatenate([_words(keys_o[r, : nv[r]]) for r in range(s)]), np.asarray(jkeys))
    for r in range(s):  # sentinel tails: all-ones keys, gid -1
        assert (keys_o[r, nv[r]:] == -1).all() and (pay_o["gid"][r, nv[r]:] == -1).all()


def test_bucket_of_is_total_where_jax_faults():
    """``repro``'s ``_bucket_of`` crashes with no splitters (one shard) and,
    with a count of splitters one short of a power of two (3 shards), sends
    the top keys to bucket p, past the last shard, where the sample sort's
    scatter drops them uncounted.  The port's buckets are the count of
    splitters at or below each key."""
    keys = np.asarray([[5], [10], [15], [20], [25], [30]], np.uint32)
    splitters = np.asarray([[10], [20]], np.uint32)
    tk = torch.from_numpy(keys.view(np.int32))
    assert tdist._bucket_of(torch.zeros((0, 1), dtype=torch.int32), tk).tolist() == [0] * 6
    with pytest.raises(Exception):
        jdist._bucket_of(jnp.zeros((0, 1), jnp.uint32), jnp.asarray(keys))
    got = tdist._bucket_of(torch.from_numpy(splitters.view(np.int32)), tk)
    assert got.tolist() == [0, 1, 1, 2, 2, 2]
    jax_buckets = np.asarray(jdist._bucket_of(jnp.asarray(splitters), jnp.asarray(keys)))
    assert jax_buckets.max() == 3  # == p: the rows JAX's sample sort loses


def test_curve_partition_bounds_and_routing_bit_equal_to_jax(data):
    pts = data[:N]
    parts = tdist.hilbert_partition(torch.from_numpy(pts), TCFG, 4)
    first = [pts[int(p[0])] for p in parts] + [None]  # a fifth, empty shard
    lo, hi = pts.min(0), pts.max(0)
    jb = jdist.curve_partition_bounds(first, JCFG, lo, hi)
    tb = tdist.curve_partition_bounds(first, TCFG, torch.from_numpy(lo),
                                      torch.from_numpy(hi))
    np.testing.assert_array_equal(_words(tb), jb)
    probe = np.concatenate([data[N:], pts[::97], 2 * pts[:5] - 1]).astype(np.float32)
    want = jdist.route_to_shards(probe, JCFG, lo, hi, jb)
    got = tdist.route_to_shards(probe, TCFG, torch.from_numpy(lo), torch.from_numpy(hi), tb)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tdist.route_to_shards(probe[:0], TCFG, torch.from_numpy(lo),
                                 torch.from_numpy(hi), tb).shape == (0,)


# -- the sharded Task 2 --------------------------------------------------------


def _sketches(pts):
    quant = jquant.fit(jnp.asarray(pts), bits=4)
    codes = jquant.encode(quant, jnp.asarray(pts))
    return quant, codes, np.asarray(jsketch.sketches_from_codes(codes, bits=4))


def test_halo_and_route_home_bit_equal_to_jax_on_one_shard(data):
    """JAX's shard_map bodies on a 1-device mesh, fed the port's sort."""
    pts = data[:N]
    _, _, sks = _sketches(pts)
    g = ShardGroup(1, CPU)
    tp = torch.from_numpy(pts)
    _, pay, nv, _ = tdist.distributed_hilbert_order(
        g, tp, TCFG, tp.amin(0), tp.amax(0), payload={"sk": torch.from_numpy(sks.view(np.int32).copy())})
    mesh = data_mesh(1)
    k1 = GRAPH["k1"]
    jc, jd = jdist.halo_window_candidates(jnp.asarray(pay["gid"][0].numpy()),
                                          jnp.asarray(_words(pay["sk"][0])),
                                          jnp.asarray(nv.numpy()), mesh, k1)
    tc, td = tdist.halo_window_candidates(g, pay["gid"], pay["sk"], nv, k1)
    np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc))
    np.testing.assert_array_equal(td[0].numpy(), np.asarray(jd))
    want = jdist.route_home(jnp.asarray(pay["gid"][0].numpy()), jc, jd, mesh, N)
    got = tdist.route_home(g, pay["gid"], tc, td, N)
    for w, t in zip(want, got):
        np.testing.assert_array_equal(t.numpy().reshape(np.asarray(w).shape), np.asarray(w))


def test_merge_sharded_and_final_adc_match_jax(data):
    """``_merge_sharded`` bit-equal; ``_final_adc`` ids bit-equal, its fp32
    sums within the distance contract (XLA:CPU sums the d squares in 8
    fused multiply-add lanes and a tree; torch in its own order)."""
    pts = data[:N]
    quant, codes, _ = _sketches(pts)
    rng = np.random.default_rng(3)
    best_id = rng.integers(-1, N, (N, 32)).astype(np.int32)
    best_id[:, 5] = np.arange(N)  # self
    best_id[:, 9] = best_id[:, 2]  # a duplicate
    best_d = rng.integers(0, 30, (N, 32)).astype(np.int32)
    new_id = rng.integers(-1, N, (N, 16)).astype(np.int32)
    new_d = np.where(new_id < 0, 2**30, rng.integers(0, 30, (N, 16))).astype(np.int32)
    ji, jd = jdist._merge_sharded(*(jnp.asarray(a) for a in (best_id, best_d, new_id,
                                                           new_d)), 32)
    ti, td = tdist._merge_sharded(*(torch.from_numpy(a) for a in (best_id, best_d, new_id,
                                                                 new_d)), 32)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))

    tq = tquant.Quantizer(torch.from_numpy(np.array(quant.boundaries)),
                          torch.from_numpy(np.array(quant.centroids)))
    ji, jd = jdist._final_adc(jnp.asarray(pts), jnp.asarray(best_id), quant, codes, 10)
    tcodes = torch.from_numpy(np.array(codes))
    outs = [tdist._final_adc(torch.from_numpy(pts[s : s + 500]),
                             torch.from_numpy(best_id[s : s + 500]), tq, tcodes, 10,
                             row_start=s) for s in range(0, N, 500)]
    ti, td = torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=DIST_RTOL, atol=DIST_ATOL)
    assert not (ti.numpy() == np.arange(N)[:, None]).any()


@pytest.fixture(scope="module")
def graphs(data):
    """The 4-shard graph at GRAPH; the 1- and 4-shard graphs at PARITY_ORDERS."""
    pts = data[:N]
    few = GraphParams(**{**GRAPH, "n_orders": PARITY_ORDERS})
    out = {s: tdist.distributed_knn_graph(pts, few, TCFG, s, device="cpu") for s in (1, 4)}
    out["full"] = tdist.distributed_knn_graph(pts, GraphParams(**GRAPH), TCFG, 4,
                                              device="cpu")
    return out


def test_distributed_knn_graph_bit_equal_across_shard_counts(graphs):
    ids1, d1, ovf1 = graphs[1]
    ids, d2, ovf = graphs[4]
    assert ovf == 0 and ovf1 == 0 and graphs["full"][2] == 0
    assert torch.equal(ids, ids1) and torch.equal(d2, d1)
    for ids, d2, _ in (graphs[4], graphs["full"]):
        assert ids.shape == (N, GRAPH["k"]) and torch.isfinite(d2).all()
        assert not (ids == torch.arange(N, dtype=torch.int32)[:, None]).any()


def test_distributed_knn_graph_recall(data, graphs):
    pts = data[:N]
    gt = ann_datasets.exact_knn_graph(pts, GRAPH["k"])
    rec = ann_datasets.recall_at_k(graphs["full"][0].numpy(), gt)
    single = HilbertIndex.build(pts, IndexConfig(forest=TCFG), device="cpu")
    rec_single = ann_datasets.recall_at_k(single.knn_graph(GraphParams(**GRAPH))[0].numpy(), gt)
    assert rec > 0.5, rec
    assert abs(rec - rec_single) <= 0.05, (rec, rec_single)


def test_distributed_knn_graph_rejects_uneven_shards(data):
    with pytest.raises(ValueError):
        tdist.distributed_knn_graph(data[: N + 3], GraphParams(**GRAPH), TCFG, 4,
                                    device="cpu")
