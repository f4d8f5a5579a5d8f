"""Port parity: repro_torch's ShardedHilbertIndex against repro's.

The port runs S logical shards on the CPU.  In this process the JAX
reference is built from the JAX package's own functions on its one
device: ``quantize.fit`` once, the partition of ``data_mesh(1)``, each
shard padded with ``np.tile`` and built by ``build_with_timings(quant=)``
(``repro.index.sharded``'s recipe), searched by ``fused_search_chunk`` a
shard and merged by ``cross_shard_merge_topk`` under ``jax.vmap``.  One
subprocess runs ``repro``'s ``shard_map`` code on 4 virtual devices
(``tests/_jax_sharded_4dev.py``).  Stacks, partitions and Task-2 pieces
are bit-equal; searches meet the contract of
``tests/test_kernels_integration.py``; format-3 bundles load across the
packages wherever the JAX package can write them (its multi-shard
``save()`` raises under this jax).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core import quantize as jquant
from repro.core import search as jsearch
from repro.index import ForestConfig as JForestConfig
from repro.index import HilbertIndex as JIndex
from repro.index import IndexConfig as JIndexConfig
from repro.index import ShardedHilbertIndex as JSharded
from repro.index.facade import build_with_timings as jbuild
from repro.launch.mesh import data_mesh
from repro_torch.core import distributed as tdist
from repro_torch.core import quantize as tquant
from repro_torch.core import sketch as tsketch
from repro_torch.core.shard_group import ShardGroup
from repro_torch.data import ann_datasets
from repro_torch.index import (ForestConfig, HilbertIndex, IndexConfig,
                               MutableHilbertIndex, SearchParams,
                               ShardedMutableHilbertIndex)
from repro_torch.index.sharded import ShardedHilbertIndex, build_auto
from test_kernels_integration import (DIST_ATOL, DIST_RTOL,
                                      _assert_ids_equal_up_to_distance_ties)

N, D, Q = 2048, 24, 16
FOREST = dict(n_trees=2, bits=4, key_bits=96, leaf_size=16, seed=0)
TCFG = IndexConfig(forest=ForestConfig(**FOREST))
JCFG = JIndexConfig(forest=JForestConfig(**FOREST))
SEARCH = SearchParams(k1=64, k2=128, h=2, k=10)
# Pool-saturating: stage 1 covers every row on every layout, so each search
# is exact over the same global-quantizer ADC distances.
SATURATE = SearchParams(k1=N, k2=N, h=1, k=10)
SCRIPT = os.path.join(os.path.dirname(__file__), "_jax_sharded_4dev.py")
SUBPROCESS_TIMEOUT_S = 240
STACK_WORDS = ("directories", "sketches", "codes")


@pytest.fixture(scope="module")
def dataset():
    return ann_datasets.lowrank_dataset_with_queries(N, Q, D, n_clusters=8, seed=0)


def jax_reference(data, s):
    """``repro.index.sharded``'s build, from JAX functions on one device:
    (shard indexes, id maps, n_valid, pad_max, quantizer)."""
    quant = jquant.fit(jnp.asarray(data), bits=4)
    parts = jdist.hilbert_partition(jnp.asarray(data), JCFG.forest, mesh=data_mesh(1),
                                    n_shards=s)
    n_pad = -(-data.shape[0] // s)
    n_valid = np.asarray([len(p) for p in parts])
    pad_max = int(max((n_pad - v for v in n_valid if v > 0), default=0))
    id_maps = np.zeros((s, n_pad), np.int32)
    shards = []
    for r, gids in enumerate(parts):
        if len(gids):
            id_maps[r] = np.tile(np.asarray(gids, np.int32), -(-n_pad // len(gids)))[:n_pad]
        shards.append(jbuild(jnp.asarray(data[id_maps[r]]), JCFG, quant=quant)[0])
    return shards, id_maps, n_valid, pad_max, quant


@pytest.fixture(scope="module")
def built(dataset):
    data, _ = dataset
    return {s: (ShardedHilbertIndex.build(data, TCFG, n_shards=s, device="cpu"),
                jax_reference(data, s)) for s in (3, 4)}


def host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_within_contract(jids, jd, tids, td):
    jids, jd, tids, td = host(jids), host(jd), host(tids), host(td)
    assert jids.shape == tids.shape
    np.testing.assert_allclose(td, jd, rtol=DIST_RTOL, atol=DIST_ATOL)
    _assert_ids_equal_up_to_distance_ties(jids, tids, jd)


def assert_set_equal(ids_a, ids_b):
    for ra, rb in zip(host(ids_a), host(ids_b)):
        assert set(ra[ra >= 0].tolist()) == set(rb[rb >= 0].tolist())


def assert_stacks_equal(a, b):
    for name in a.stack._fields:
        assert torch.equal(getattr(a.stack, name), getattr(b.stack, name)), name
    assert (a.points is None) == (b.points is None)
    if a.points is not None:
        assert torch.equal(a.points, b.points)
    np.testing.assert_array_equal(a.n_valid, b.n_valid)
    assert a.pad_max == b.pad_max


# -- the built stack -----------------------------------------------------------


@pytest.mark.parametrize("s", [3, 4])
def test_stack_bit_equal_to_jax_reference(built, s):
    idx, (shards, id_maps, n_valid, pad_max, quant) = built[s]
    assert idx.n_shards == s and idx.pad_max == pad_max
    np.testing.assert_array_equal(idx.n_valid, n_valid)
    np.testing.assert_array_equal(idx.stack.id_map.numpy(), id_maps)
    np.testing.assert_array_equal(idx.quant.boundaries.numpy(), np.asarray(quant.boundaries))
    np.testing.assert_array_equal(idx.quant.centroids.numpy(), np.asarray(quant.centroids))
    leaves = {"orders": "forest.orders", "directories": "forest.directories",
              "lo": "forest.lo", "hi": "forest.hi", "sketches": "sketches_master",
              "codes": "codes_master", "master_order": "master_order",
              "master_rank": "master_rank"}
    for r, ix in enumerate(shards):
        jarr = {k: np.asarray(v) for k, v in ix._array_bundle().items()}
        for field, leaf in leaves.items():
            got = getattr(idx.stack, field)[r].numpy()
            if field in STACK_WORDS:
                got = got.view(np.uint32)
            np.testing.assert_array_equal(got, jarr[leaf], err_msg=f"shard {r} {field}")
        np.testing.assert_array_equal(idx.points[r].numpy(), jarr["points"])
        np.testing.assert_array_equal(idx.perms.numpy(), jarr["forest.perms"])
        np.testing.assert_array_equal(idx.flips.numpy(), jarr["forest.flips"])


def _jax_reference_search(ref, queries, params, merge, prune):
    """Per-shard JAX fused search with the facade's k_local, ids through the
    gid table, then the JAX merge under vmap: (S, Q, k) per rank."""
    shards, id_maps, _, pad_max, quant = ref
    s, n_pad = id_maps.shape
    k_local = max(1, min(params.k + pad_max, params.k2 * min(2 * params.h + 1, n_pad)))
    fc = JCFG.forest
    ids_all, d_all = [], []
    for r, ix in enumerate(shards):
        f = ix.forest
        ids_l, d2 = jsearch.fused_search_chunk(
            jnp.asarray(queries), f.orders, f.directories, f.lo, f.hi, f.perms, f.flips,
            ix.master_rank, ix.sketches_master, ix.codes_master, ix.master_order, quant,
            bits=fc.bits, key_bits=fc.key_bits, leaf_size=fc.leaf_size, k1=params.k1,
            k2=params.k2, h=params.h, k=k_local)
        gids = jnp.where(ids_l >= 0, jnp.asarray(id_maps[r])[jnp.maximum(ids_l, 0)], -1)
        ids_all.append(gids)
        d_all.append(jnp.where(gids >= 0, d2, jnp.inf))
    ids, d2 = jnp.stack(ids_all), jnp.stack(d_all)
    if merge == "local":
        fn = lambda i, d: jsearch.merge_topk(i, d, k=params.k)  # noqa: E731
    else:
        fn = lambda i, d: jdist.cross_shard_merge_topk(  # noqa: E731
            i, d, k=params.k, axis="data", axis_size=s, merge=merge, prune=prune)
    return jax.vmap(fn, axis_name="data")(ids, d2)


@pytest.mark.parametrize("s,merge,prune", [(4, "tree", False), (4, "gather", False),
                                           (4, "tree", True), (4, "local", False),
                                           (3, "gather", False), (3, "local", False)])
def test_search_within_contract_of_jax_reference(dataset, built, s, merge, prune):
    _, queries = dataset
    idx, ref = built[s]
    jids, jd = _jax_reference_search(ref, queries, SEARCH, merge, prune)
    if merge == "local":
        tids, td = idx.search_local(queries, SEARCH)
        assert tids.shape == (s, Q, SEARCH.k)
        for r in range(s):
            assert_within_contract(jids[r], jd[r], tids[r], td[r])
    else:
        tids, td = idx.search(queries, SEARCH, merge=merge, prune=prune)
        assert idx.last_dispatch_count == 1
        for r in range(s):  # every rank of the JAX merge holds the same result
            assert_within_contract(jids[r], jd[r], tids, td)


@pytest.mark.parametrize("s", [3, 4])
def test_pool_saturating_search_set_equal_to_single_index(dataset, built, s):
    data, queries = dataset
    single = HilbertIndex.build(data, TCFG, device="cpu")
    ids_1, d_1 = single.search(queries, SATURATE)
    idx, _ = built[s]
    merges = ("tree", "gather") if s == 4 else ("gather",)
    results = [idx.search(queries, SATURATE, merge=m) for m in merges]
    if s == 4:
        results.append(idx.search(queries, SATURATE, merge="tree", prune=True))
        assert torch.equal(results[2][0], results[0][0])  # prune: ids bit-equal
    for ids, d2 in results:
        assert_set_equal(ids, ids_1)
        assert torch.equal(d2.sort(1).values, d_1.sort(1).values)


def test_three_shards_auto_gathers_and_explicit_tree_raises(dataset, built):
    _, queries = dataset
    idx, _ = built[3]
    a = idx.search(queries, SEARCH)  # config.merge "auto"
    g = idx.search(queries, SEARCH, merge="gather")
    assert torch.equal(a[0], g[0]) and torch.equal(a[1], g[1])
    with pytest.raises(ValueError, match="power-of-two"):
        idx.search(queries, SEARCH, merge="tree")


def test_empty_shards_eleven_rows_over_eight(dataset):
    data, queries = dataset
    pts = data[:11]
    idx = ShardedHilbertIndex.build(pts, TCFG, n_shards=8, device="cpu")
    assert idx.n_valid.tolist() == [2, 2, 2, 2, 2, 1, 0, 0] and idx.pad_max == 1
    assert idx.stack.id_map[6:].eq(0).all()  # empty shards copy global row 0
    sp = SearchParams(k1=11, k2=11, h=1, k=10)
    ids, d2 = idx.search(queries, sp)
    ids_1, d_1 = HilbertIndex.build(pts, TCFG, device="cpu").search(queries, sp)
    assert_set_equal(ids, ids_1)
    assert torch.equal(d2.sort(1).values, d_1.sort(1).values)
    for row in ids.numpy():
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)


def test_one_shard_bit_identical_to_hilbert_index(dataset):
    data, queries = dataset
    idx = ShardedHilbertIndex.build(data, TCFG, device="cpu")
    assert idx.n_shards == 1 and idx.single is not None
    single = HilbertIndex.build(data, TCFG, device="cpu")
    for got, want in zip(idx.search(queries, SEARCH, query_chunk=4),
                         single.search(queries, SEARCH, query_chunk=4)):
        assert torch.equal(got, want)
    assert idx.last_dispatch_count == 4
    local = idx.search_local(queries, SEARCH)
    assert local[0].shape == (1, Q, SEARCH.k)


def test_one_dispatch_per_chunk(dataset, built):
    _, queries = dataset
    idx, _ = built[4]
    ids, d2 = idx.search(queries, SEARCH)
    ids_c, d_c = idx.search(queries, SEARCH, query_chunk=4)
    assert idx.last_dispatch_count == 4
    assert torch.equal(ids, ids_c) and torch.equal(d2, d_c)
    empty = idx.search(queries[:0], SEARCH)
    assert empty[0].shape == (0, SEARCH.k) and idx.last_dispatch_count == 0


# -- format-3 bundles ----------------------------------------------------------


def test_same_count_reload_bit_equal(dataset, built, tmp_path):
    _, queries = dataset
    idx, _ = built[4]
    idx.save(str(tmp_path))
    back = ShardedHilbertIndex.load(str(tmp_path), device="cpu")
    assert back.n_shards == 4 and back.config == idx.config
    assert_stacks_equal(back, idx)
    for got, want in zip(back.search(queries, SEARCH), idx.search(queries, SEARCH)):
        assert torch.equal(got, want)


def test_reshard_to_one_bit_identical_to_single_fused_path(dataset, built, tmp_path):
    data, queries = dataset
    built[4][0].save(str(tmp_path))
    one = ShardedHilbertIndex.load(str(tmp_path), n_shards=1, device="cpu")
    assert one.n_shards == 1 and one.config.shards is None
    single = HilbertIndex.build(data, TCFG, device="cpu")
    for got, want in zip(one.search(queries, SEARCH), single.search(queries, SEARCH)):
        assert torch.equal(got, want)


def test_v2_bundle_adopted_and_resharded(dataset, built, tmp_path):
    data, queries = dataset
    single = HilbertIndex.build(data, TCFG, device="cpu")
    single.save(str(tmp_path))
    adopted = ShardedHilbertIndex.load(str(tmp_path), device="cpu")
    assert adopted.n_shards == 1
    for got, want in zip(adopted.search(queries, SEARCH), single.search(queries, SEARCH)):
        assert torch.equal(got, want)
    four = ShardedHilbertIndex.load(str(tmp_path), n_shards=4, device="cpu")
    assert_stacks_equal(four, built[4][0])


def test_jax_reshard_of_port_bundle_matches_port_reshard(dataset, built, tmp_path):
    data, queries = dataset
    built[4][0].save(str(tmp_path))
    jidx = JSharded.load(str(tmp_path), mesh=data_mesh(1))
    tidx = ShardedHilbertIndex.load(str(tmp_path), n_shards=1, device="cpu")
    jids, jd = jidx.search(jnp.asarray(queries), SEARCH)
    assert_within_contract(jids, jd, *tidx.search(queries, SEARCH))


def test_port_loads_jax_written_bundles(dataset, tmp_path):
    data, queries = dataset
    v3, v2 = str(tmp_path / "v3"), str(tmp_path / "v2")
    jsh = JSharded.build(jnp.asarray(data), JCFG, mesh=data_mesh(1))
    jsh.save(v3)
    JIndex.build(jnp.asarray(data), JCFG).save(v2)
    want = jsh.search(jnp.asarray(queries), SEARCH)
    for path in (v3, v2):
        got = ShardedHilbertIndex.load(path, device="cpu")
        assert got.n_shards == 1
        assert_within_contract(*want, *got.search(queries, SEARCH))
    four = ShardedHilbertIndex.load(v3, n_shards=4, device="cpu")
    assert four.n_shards == 4
    assert_set_equal(four.search(queries, SATURATE)[0], jsh.search(
        jnp.asarray(queries), SATURATE)[0])


# -- build_auto and memory_report ----------------------------------------------


def test_build_auto_picks_the_facade_by_shard_count(dataset):
    data, _ = dataset
    pts = data[:512]
    assert isinstance(build_auto(pts, TCFG, device="cpu"), HilbertIndex)
    four = build_auto(pts, TCFG, n_shards=4, device="cpu")
    assert isinstance(four, ShardedHilbertIndex) and four.n_shards == 4
    two = build_auto(pts, IndexConfig(forest=TCFG.forest, shards=2), device="cpu")
    assert isinstance(two, ShardedHilbertIndex) and two.n_shards == 2
    mut = build_auto(pts, TCFG, mutable=True, device="cpu")
    assert isinstance(mut, MutableHilbertIndex) and mut.n_live == 512
    smut = build_auto(pts, TCFG, n_shards=2, mutable=True, device="cpu")
    assert isinstance(smut, ShardedMutableHilbertIndex) and smut.n_shards == 2
    assert smut.n_live == 512
    with pytest.raises(ValueError):
        ShardedHilbertIndex.build(pts, two.config, n_shards=3, device="cpu")


def test_memory_report_keys_and_bytes(dataset, built):
    data, _ = dataset
    jrep = JSharded.build(jnp.asarray(data), JCFG, mesh=data_mesh(1)).memory_report()
    trep = ShardedHilbertIndex.build(data, TCFG, device="cpu").memory_report()
    assert set(trep) == set(jrep)
    for key in ("n_shards", "sharded_bytes", "replicated_bytes", "per_device_bytes"):
        assert trep[key] == jrep[key], key
    idx, _ = built[4]
    rep = idx.memory_report()
    assert rep["n_shards"] == 4 and len(rep["per_device_bytes"]) == 4
    assert rep["resident_bytes"] == rep["sharded_bytes"] + rep["replicated_bytes"]
    assert rep["per_device_bytes"][0] == rep["sharded_bytes"] // 4 + rep["replicated_bytes"]


# -- repro's shard_map code on 4 virtual devices (one subprocess) ------------


def test_jax_four_devices_bit_equal_to_port(dataset, built, tmp_path):
    """``repro``'s 4-device ShardedHilbertIndex and one order of its sharded
    Task 2, against the port's S = 4 (the test's own time limit is 240 s)."""
    out = tmp_path / "jax4.npz"
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, SCRIPT, str(out)], capture_output=True, text=True,
                       timeout=SUBPROCESS_TIMEOUT_S, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    j = np.load(out)
    data, queries = dataset
    idx, _ = built[4]
    np.testing.assert_array_equal(idx.n_valid, j["s_n_valid"])
    np.testing.assert_array_equal(idx.stack.id_map.numpy(), j["s_id_map"])
    for merge in ("tree", "gather"):
        assert_within_contract(j[f"s_{merge}_ids"], j[f"s_{merge}_d2"],
                               *idx.search(queries, SEARCH, merge=merge))
    assert sorted(idx.memory_report()) == json.loads(str(j["s_report_keys"]))

    # One order of the sharded Task 2, as the script ran it.
    g = ShardGroup(4, torch.device("cpu"))
    pts = torch.from_numpy(data)
    quant = tquant.fit(pts, bits=4)
    sks = tsketch.sketches_from_codes(tquant.encode(quant, pts), bits=4)
    rng = np.random.default_rng(0)
    perm = torch.from_numpy(rng.permutation(D).astype(np.int32))
    flip = torch.from_numpy(rng.integers(0, 2, D).astype(bool))
    keys_o, pay_o, n_valid, ovf = tdist.distributed_hilbert_order(
        g, pts, TCFG.forest, pts.amin(0), pts.amax(0), perm, flip, payload={"sk": sks})
    assert int(ovf.sum()) == 0
    np.testing.assert_array_equal(keys_o.reshape(-1, keys_o.shape[2]).numpy().view(np.uint32),
                                  j["o_keys"])
    np.testing.assert_array_equal(pay_o["gid"].reshape(-1).numpy(), j["o_gid"])
    np.testing.assert_array_equal(pay_o["sk"].reshape(-1, 1).numpy().view(np.uint32),
                                  j["o_sk"])
    np.testing.assert_array_equal(n_valid.numpy(), j["o_n_valid"])
    np.testing.assert_array_equal(ovf.numpy(), j["o_overflow"])
    cand, dist = tdist.halo_window_candidates(g, pay_o["gid"], pay_o["sk"], n_valid, 16)
    np.testing.assert_array_equal(cand.reshape(-1, 16).numpy(), j["h_cand"])
    np.testing.assert_array_equal(dist.reshape(-1, 16).numpy(), j["h_dist"])
    home_c, home_d, ovf2 = tdist.route_home(g, pay_o["gid"], cand, dist, N)
    np.testing.assert_array_equal(home_c.reshape(N, 16).numpy(), j["r_cand"])
    np.testing.assert_array_equal(home_d.reshape(N, 16).numpy(), j["r_dist"])
    np.testing.assert_array_equal(ovf2.numpy(), j["r_overflow"])
    m_ids, m_d = tdist._merge_sharded(
        torch.full((N, 32), -1, dtype=torch.int32), torch.full((N, 32), 2**30, dtype=torch.int32),
        home_c.reshape(N, 16), home_d.reshape(N, 16), 32)
    np.testing.assert_array_equal(m_ids.numpy(), j["m_ids"])
    np.testing.assert_array_equal(m_d.numpy(), j["m_d"])
