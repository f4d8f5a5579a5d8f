"""Port parity: repro_torch's ShardedMutableHilbertIndex against repro's.

The port runs 4 logical shards on the CPU.  ``repro``'s class needs a
multi-device mesh, so one subprocess (``tests/_jax_sharded_mutable_4dev.py``,
once per pytest run, its own time limit 240 s) runs it on 4 virtual
devices through the op sequence of :func:`run_script` and saves its state
after each stage, its searches and a format-4 bundle; the port runs the
same sequence here.  Integer state is bit-equal after every stage,
searches meet the distance contract of
``tests/test_kernels_integration.py``, and format-4 bundles load across
the packages: ``repro`` writes one the port loads, and ``repro``'s
single-device ``load_sharded_mutable_as_mutable`` reads the port's.
"""

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.index import sharded_mutable as jsm
from repro_torch.index import (ForestConfig, HilbertIndex, IndexConfig,
                               MutableHilbertIndex, SearchParams, ShardedHilbertIndex,
                               ShardedMutableHilbertIndex, WalConfig, build_auto,
                               load_sharded_mutable_as_mutable)
from repro_torch.data import ann_datasets
from repro_torch.testing import faults
from _jax_sharded_mutable_4dev import (BASE, BUFFER, D, FOREST, MAX_SEGMENTS, MERGES, N,
                                       Q, SEAL_POW2, SEARCH, SHARDS, STAGES, reference,
                                       run_script, state_arrays)
from test_kernels_integration import (DIST_ATOL, DIST_RTOL,
                                      _assert_ids_equal_up_to_distance_ties)

CFG = IndexConfig(forest=ForestConfig(**FOREST), seal_pow2=SEAL_POW2)
SP = SearchParams(**SEARCH)


def host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_within_contract(jids, jd, tids, td):
    jids, jd, tids, td = host(jids), host(jd), host(tids), host(td)
    assert jids.shape == tids.shape
    np.testing.assert_allclose(td, jd, rtol=DIST_RTOL, atol=DIST_ATOL)
    _assert_ids_equal_up_to_distance_ties(jids, tids, jd)


def assert_same_state(a: dict, b: dict):
    assert set(a) == set(b), set(a) ^ set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def occupied(state: dict) -> dict:
    """The state with buffer slots past each shard's count zeroed: a flush
    leaves stale points there, and a load starts from empty buffers."""
    pts = state["buf_pts"].copy()
    for s, c in enumerate(state["buf_count"]):
        pts[s, c:] = 0
    return dict(state, buf_pts=pts)


def build(rows, **kw):
    kw = dict(dict(n_shards=SHARDS, buffer_capacity=BUFFER, max_segments=MAX_SEGMENTS,
                   device="cpu"), **kw)
    return ShardedMutableHilbertIndex.build(rows, CFG, **kw)


@pytest.fixture(scope="module")
def dataset():
    return ann_datasets.lowrank_dataset_with_queries(N, Q, D, n_clusters=8, seed=0)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """(repro's npz, the directory of its format-4 bundle)."""
    out = reference(tmp_path_factory)
    return np.load(os.path.join(out, "ref.npz")), os.path.join(out, "bundle")


@pytest.fixture(scope="module")
def port_run(dataset):
    """The port through run_script: state and searches after each stage,
    and the index as each stage left it (the last one, compacted)."""
    data, queries = dataset
    states, searches, reports = {}, {}, {}

    def on_stage(name, idx):
        searches[name] = {(m, p): idx.search(queries, SP, merge=m, prune=p)
                          for m, p in MERGES}
        states[name] = state_arrays(idx)
        reports[name] = idx.memory_report()

    run_script(build, data, on_stage)
    return states, searches, reports


def stage_state(j, stage):
    p = stage + "/"
    return {k[len(p):]: j[k] for k in j.files if k.startswith(p) and "/search/" not in k}


# -- the scripted sequence against repro on 4 devices ---------------------------------


@pytest.mark.parametrize("stage", STAGES)
def test_state_bit_equal_to_jax_four_devices(ref, port_run, stage):
    j, _ = ref
    states, _, _ = port_run
    assert_same_state(states[stage], stage_state(j, stage))


@pytest.mark.parametrize("stage", STAGES)
def test_searches_within_contract_of_jax_four_devices(ref, port_run, stage):
    j, _ = ref
    _, searches, _ = port_run
    for (merge, prune), (ids, d2) in searches[stage].items():
        tag = f"{stage}/search/{merge}{'_prune' if prune else ''}"
        assert_within_contract(j[tag + "/ids"], j[tag + "/d2"], ids, d2)
    # the prune masks only what cannot enter: ids bit-equal to the tree's
    tree, pruned = searches[stage][("tree", False)], searches[stage][("tree", True)]
    assert torch.equal(tree[0], pruned[0]) and torch.equal(tree[1], pruned[1])


def test_script_crosses_seals_merges_buffers_and_a_rewrite(port_run):
    states, _, _ = port_run
    # generations sealed or merged during the inserts, a tier cap held
    assert int(states["insert"]["gen"]) >= 4
    assert all(int(st["n_segments"]) <= MAX_SEGMENTS for st in states.values())
    assert states["insert"]["buf_count"].sum() > 0  # the deletes reach buffered rows
    # the search after the base's shard 0 emptied rewrote it
    assert int(states["rewrite"]["gen"]) == int(states["delete"]["gen"]) + 1
    assert states["rewrite"]["seg1/n_valid"][0] == 3


def test_memory_report_keys_equal_jax(ref, port_run):
    j, _ = ref
    _, _, reports = port_run
    assert sorted(reports["stream"]) == json.loads(str(j["report_keys"]))
    rep = reports["stream"]
    assert rep["total_bytes"] == (rep["sharded_bytes"] + rep["replicated_bytes"]
                                  + rep["values_bytes"] + rep["tombstone_bytes"])
    assert rep["per_device_bytes"] == [rep["sharded_bytes"] // 4 + rep["replicated_bytes"]] * 4


# -- compaction ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def streamed(dataset):
    """A streamed index with generations, buffered rows and tombstones."""
    data, _ = dataset
    idx = build(data[:BASE])
    for s in range(BASE, BASE + 600, 100):
        idx.insert(data[s : s + 100])
    idx.delete(np.arange(3, BASE + 600, 7))
    assert idx.n_buffered > 0 and idx.n_segments >= 2
    return idx


def live_rows(idx, data):
    ids = np.flatnonzero(idx._lsm.alive)
    return ids, data[ids]


def test_post_compact_search_bit_equal_to_fresh_sharded_build(dataset, streamed):
    data, queries = dataset
    idx = streamed.snapshot().compact()
    ids, pts = live_rows(streamed, data)
    fresh = ShardedHilbertIndex.build(pts, CFG, n_shards=SHARDS, device="cpu")
    for merge, prune in MERGES:
        got = idx.search(queries, SP, merge=merge, prune=prune)
        fi, fd = fresh.search(queries, SP, merge=merge, prune=prune)
        fi = torch.where(fi >= 0, torch.from_numpy(ids.astype(np.int32))[fi.long()], -1)
        assert torch.equal(got[0], fi) and torch.equal(got[1], fd)
    assert idx.n_segments == 1 and idx.n_buffered == 0


# -- format-4 bundles --------------------------------------------------------------------


def test_save_load_array_identical(dataset, streamed, tmp_path):
    _, queries = dataset
    streamed.save(str(tmp_path))
    back = ShardedMutableHilbertIndex.load(str(tmp_path), device="cpu")
    assert back.n_shards == SHARDS and back.config == streamed.config
    assert_same_state(occupied(state_arrays(back)), occupied(state_arrays(streamed)))
    for merge, prune in MERGES:
        for got, want in zip(back.search(queries, SP, merge=merge, prune=prune),
                             streamed.search(queries, SP, merge=merge, prune=prune)):
            assert torch.equal(got, want)
    # a second save skips every unchanged (generation, shard) bundle
    stamp = {p: os.stat(os.path.join(dp, p)).st_mtime_ns
             for dp, _, fs in os.walk(tmp_path / "segments") for p in fs}
    back.save(str(tmp_path))
    assert stamp == {p: os.stat(os.path.join(dp, p)).st_mtime_ns
                     for dp, _, fs in os.walk(tmp_path / "segments") for p in fs}


def test_reshard_on_load_four_to_two_equals_fresh_build(dataset, streamed, tmp_path):
    data, queries = dataset
    streamed.save(str(tmp_path))
    two = ShardedMutableHilbertIndex.load(str(tmp_path), n_shards=2, device="cpu")
    assert two.n_shards == 2 and two.n_segments == 1 and two.n_buffered == 0
    assert two.n_live == streamed.n_live and two._lsm.next_id == streamed._lsm.next_id
    ids, pts = live_rows(streamed, data)
    fresh = ShardedHilbertIndex.build(pts, CFG, n_shards=2, device="cpu")
    fi, fd = fresh.search(queries, SP)
    fi = torch.where(fi >= 0, torch.from_numpy(ids.astype(np.int32))[fi.long()], -1)
    got = two.search(queries, SP)
    assert torch.equal(got[0], fi) and torch.equal(got[1], fd)


def test_jax_load_as_mutable_reads_port_bundle(dataset, streamed, tmp_path):
    """``repro``'s single-device degrade path on a bundle the port wrote
    equals the port's own ``load_sharded_mutable_as_mutable``."""
    _, queries = dataset
    streamed.save(str(tmp_path))
    jm = jsm.load_sharded_mutable_as_mutable(str(tmp_path))
    tm = load_sharded_mutable_as_mutable(str(tmp_path), device="cpu")
    assert isinstance(tm, MutableHilbertIndex) and tm.n_segments == 1
    np.testing.assert_array_equal(tm._lsm.alive, jm._lsm.alive)
    assert tm._lsm.next_id == jm._lsm.next_id and tm.n_live == streamed.n_live
    np.testing.assert_array_equal(tm.segments[0].ids, jm.segments[0].ids)
    np.testing.assert_array_equal(tm.segments[0].index.codes_master.numpy().view(np.uint32),
                                  np.asarray(jm.segments[0].index.codes_master))
    jids, jd = jm.search(jnp.asarray(queries), jsm.SearchParams(**SEARCH))
    assert_within_contract(jids, jd, *tm.search(queries, SP))


def test_port_loads_jax_written_bundle(ref, tmp_path):
    j, path = ref
    shutil.copytree(path, tmp_path / "b")
    got = ShardedMutableHilbertIndex.load(str(tmp_path / "b"), device="cpu")
    assert_same_state(occupied(state_arrays(got)), occupied(stage_state(j, "delete")))


def test_format3_bundle_adopted(dataset, tmp_path):
    data, queries = dataset
    static = ShardedHilbertIndex.build(data[:BASE], CFG, n_shards=SHARDS, device="cpu")
    static.save(str(tmp_path))
    got = ShardedMutableHilbertIndex.load(str(tmp_path), device="cpu")
    want = ShardedMutableHilbertIndex.from_sharded(static)
    assert_same_state(state_arrays(got), state_arrays(want))
    for a, b in zip(got.search(queries, SP), static.search(queries, SP)):
        assert torch.equal(a, b)
    assert ShardedMutableHilbertIndex.load(str(tmp_path), n_shards=2,
                                           device="cpu").n_shards == 2


# -- the WAL and the save's fault point ---------------------------------------------------


def test_wal_replay_after_drop_without_save(dataset, tmp_path):
    data, queries = dataset
    idx = build(data[:BASE])
    idx.save(str(tmp_path))
    idx.enable_wal(str(tmp_path), WalConfig(sync_every=1))
    for s in range(BASE, BASE + 500, 100):
        idx.insert(data[s : s + 100])
    idx.delete(np.arange(0, BASE + 500, 9))
    want_state, want = state_arrays(idx), idx.search(queries, SP)
    idx.detach_wal().close()
    del idx
    rec = ShardedMutableHilbertIndex.load(str(tmp_path), device="cpu")
    assert rec.wal is not None
    assert_same_state(occupied(state_arrays(rec)), occupied(want_state))
    for a, b in zip(rec.search(queries, SP), want):
        assert torch.equal(a, b)
    rec.detach_wal().close()


def test_pre_manifest_fault_leaves_previous_manifest_loadable(dataset, tmp_path):
    data, queries = dataset
    idx = build(data[:BASE])
    idx.save(str(tmp_path))
    want_state, want = state_arrays(idx), idx.search(queries, SP)
    idx.insert(data[BASE : BASE + 300])
    idx.delete(np.arange(0, 50))
    faults.install_plan({"sharded_mutable.save.pre_manifest": (1, "raise")})
    try:
        with pytest.raises(faults.FaultInjected):
            idx.save(str(tmp_path))
    finally:
        faults.reset()
    back = ShardedMutableHilbertIndex.load(str(tmp_path), device="cpu")
    assert_same_state(occupied(state_arrays(back)), occupied(want_state))
    for a, b in zip(back.search(queries, SP), want):
        assert torch.equal(a, b)


# -- refusals, routing, build_auto ----------------------------------------------------------


def test_refuses_fewer_than_two_shards(dataset):
    data, _ = dataset
    with pytest.raises(ValueError, match="MutableHilbertIndex"):
        ShardedMutableHilbertIndex(CFG, n_shards=1, device="cpu")
    with pytest.raises(ValueError, match="MutableHilbertIndex"):
        ShardedMutableHilbertIndex.build(data[:64], CFG, device="cpu")  # config.shards None
    with pytest.raises(ValueError, match="n_shards"):
        ShardedMutableHilbertIndex(IndexConfig(shards=2), n_shards=4, device="cpu")


def test_refuses_to_load_onto_one_shard(streamed, tmp_path):
    streamed.save(str(tmp_path))
    with pytest.raises(ValueError, match="load_sharded_mutable_as_mutable"):
        ShardedMutableHilbertIndex.load(str(tmp_path), n_shards=1, device="cpu")


def test_store_points_false_serves_but_refuses_compact(dataset):
    data, queries = dataset
    lean = IndexConfig(forest=CFG.forest, store_points=False)
    idx = ShardedMutableHilbertIndex.build(data[:BASE], lean, n_shards=SHARDS,
                                           device="cpu")
    assert idx._bounds is None  # no points to recover the opening keys from
    ids = idx.insert(data[BASE : BASE + 8])
    np.testing.assert_array_equal(idx._buf_count, [2, 2, 2, 2])  # round-robin
    np.testing.assert_array_equal(idx._buf_ids[:, :2].T.ravel(), ids)
    assert idx.search(queries, SP)[0].shape == (Q, SP.k)
    with pytest.raises(ValueError, match="stored points"):
        idx.compact()


def test_round_robin_routing_without_bounds(dataset):
    data, queries = dataset
    idx = ShardedMutableHilbertIndex(CFG, n_shards=SHARDS, buffer_capacity=BUFFER,
                                     device="cpu")
    assert idx.search(queries, SP)[0].eq(-1).all()  # empty
    ids = idx.insert(data[:6])
    np.testing.assert_array_equal(idx._buf_count, [2, 2, 1, 1])
    idx.insert(data[6:9])
    np.testing.assert_array_equal(idx._buf_count, [3, 2, 2, 2])
    assert idx._rr == 1 and idx._bounds is None and ids.tolist() == list(range(6))
    got_ids, got_d = idx.search(queries[:4], SearchParams(k=9))
    want = ((queries[:4, None, :] - data[None, :9, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(np.sort(host(got_ids), 1),
                                  np.tile(np.arange(9), (4, 1)))
    np.testing.assert_allclose(host(got_d), np.sort(want, 1), rtol=1e-4, atol=1e-4)


def test_build_auto_sharded_mutable(dataset):
    data, queries = dataset
    vals = np.arange(BASE, dtype=np.int32) * 3
    idx = build_auto(data[:BASE], CFG, n_shards=SHARDS, mutable=True, values=vals,
                     buffer_capacity=BUFFER, max_segments=MAX_SEGMENTS, device="cpu")
    assert isinstance(idx, ShardedMutableHilbertIndex) and idx.n_shards == SHARDS
    assert idx.buffer_capacity == BUFFER and idx.max_segments == MAX_SEGMENTS
    want = build(data[:BASE])
    for a, b in zip(idx.search(queries, SP), want.search(queries, SP)):
        assert torch.equal(a, b)
    ids, _ = idx.search(queries, SP)
    got = host(idx.values_at(ids, fill=-1))
    np.testing.assert_array_equal(got, np.where(host(ids) >= 0, host(ids) * 3, -1))
    np.testing.assert_array_equal(host(idx.values_dense()), vals)


def test_one_dispatch_per_chunk_and_device_default(dataset, streamed):
    _, queries = dataset
    ids, d2 = streamed.search(queries, SP)
    ids_c, d_c = streamed.search(queries, SP, query_chunk=4)
    assert streamed.last_dispatch_count == 4
    assert torch.equal(ids, ids_c) and torch.equal(d2, d_c)
    empty = streamed.search(queries[:0], SP)
    assert empty[0].shape == (0, SP.k) and streamed.last_dispatch_count == 0
    assert streamed.device == torch.device("cpu") and ids.dtype == torch.int32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ShardedMutableHilbertIndex(CFG, n_shards=SHARDS)


def test_save_fault_point_is_registered():
    assert "sharded_mutable.save.pre_manifest" in faults.POINTS


def test_every_declared_fault_point_is_registered():
    import re

    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "src", "repro_torch")
    declared = set()
    for dp, _, fs in os.walk(src):
        for f in fs:
            if f.endswith(".py"):
                with open(os.path.join(dp, f)) as fh:
                    declared |= set(re.findall(r'fault_point\(\s*"([^"]+)"', fh.read()))
    assert declared == faults.POINTS
