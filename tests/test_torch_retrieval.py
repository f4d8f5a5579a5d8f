"""Port parity: ``repro_torch.serve.RetrievalStore`` and ``knn_lm_mix``.

The single-device cases of ``tests/test_mutable_index.py`` run on both
packages from the same inputs: build, append, delete, lookup, compact,
enable_wal, save/load, serving_engine and values_at.  Store bundles load
across packages in both directions, and ``knn_lm_mix`` agrees within
rtol 1e-5 / atol 1e-6.

The sharded-mutable store (4 logical shards) is held to ``repro``'s
4-device store through ``tests/_jax_retrieval_4dev.py`` (a subprocess,
once for this module): state bit-equal after each stage of its
``store_script``, lookups within the contract, and v4 and v3 store
bundles loading across the packages, on 4 devices and degraded to one.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from repro.index import save_index_bundle as j_save_index_bundle
from repro.index import HilbertIndex as JIndex
from repro.serve.retrieval import RetrievalStore as JStore
from repro.serve.retrieval import knn_lm_mix as j_knn_lm_mix
from repro_torch.checkpoint import bundle
from repro_torch.checkpoint.wal import WalConfig as TWalConfig
from repro_torch.index import (MutableHilbertIndex, ShardedHilbertIndex,
                               ShardedMutableHilbertIndex,
                               load_sharded_mutable_as_mutable)
from repro_torch.serve.retrieval import RetrievalStore as TStore
from repro_torch.serve.retrieval import knn_lm_mix as t_knn_lm_mix
from _torch_parity import (JCFG, JSP, TCFG, TSP, Q, assert_within_contract,
                           dataset, host)
from test_torch_mutable import _assert_same, _state
from _jax_retrieval_4dev import (BASE, BUFFER, SHARDS, STAGES, base_values, run,
                                 store_script, store_state)
from _jax_sharded_mutable_4dev import state_arrays

VALS = (np.arange(1000, dtype=np.int32) % 31)


@pytest.fixture(scope="module")
def data():
    return dataset()


def _pair(data, **kw):
    d, _ = data
    return (JStore.build(d[:1000], VALS, JCFG, buffer_capacity=256, **kw),
            TStore.build(d[:1000], VALS, TCFG, buffer_capacity=256,
                         device="cpu", **kw))


def test_store_lifecycle_matches_repro(data, tmp_path):
    """append, delete, lookup, values_at, compact, save/load: the port's
    state bit-equal to ``repro``'s after every step, lookups within the
    contract, and the repro test's own assertions hold on the port."""
    d, queries = data
    js, ts = _pair(data)
    _assert_same(_state(js.index), _state(ts.index))
    ids1 = ts.lookup(queries, TSP)[0]
    assert_within_contract(*js.lookup(queries, JSP), *ts.lookup(queries, TSP))
    sevens = np.full(Q, 7, np.int32)
    jn, tn = js.append(queries, sevens), ts.append(queries, sevens)
    np.testing.assert_array_equal(tn, jn)
    ids2, d22 = ts.lookup(queries, TSP)
    assert (host(ids2)[:, 0] == tn).all()  # exact self-match from the buffer
    assert host(d22)[:, 0] == pytest.approx(0.0, abs=1e-3)
    assert (host(ts.values_at(ids2[:, :1])) == 7).all()
    np.testing.assert_array_equal(host(ts.values_at(ids2, fill=-5)),
                                  np.asarray(js.values_at(host(ids2), fill=-5)))
    assert js.delete(jn) == ts.delete(tn) == Q
    assert torch.equal(ts.lookup(queries, TSP)[0], ids1)
    js.compact()
    ts.compact()
    _assert_same(_state(js.index), _state(ts.index))
    np.testing.assert_array_equal(host(ts.values), np.asarray(js.values))
    ts.save(str(tmp_path / "ts"))
    loaded = TStore.load(str(tmp_path / "ts"), device="cpu")
    assert torch.equal(loaded.lookup(queries, TSP)[0], ids1)
    loaded.append(d[:10], VALS[:10])
    assert loaded.index.n_live == 1010
    assert ts.memory_report()["n_live"] == 1000


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_store_bundles_load_across_packages(data, tmp_path, direction):
    d, queries = data
    js, ts = _pair(data)
    for s in (js, ts):
        s.append(d[1000:1100], VALS[:100])
        s.delete(np.arange(0, 1000, 13))
    path = str(tmp_path / "store")
    if direction == "jax_to_torch":
        js.save(path)
        other = TStore.load(path, device="cpu")
        _assert_same(_state(js.index), _state(other.index))
        assert_within_contract(*js.lookup(queries, JSP), *other.lookup(queries, TSP))
    else:
        ts.save(path)
        other = JStore.load(path)
        _assert_same(_state(other.index), _state(ts.index))
        assert_within_contract(*other.lookup(queries, JSP), *ts.lookup(queries, TSP))


def test_store_wal_replays_across_packages(data, tmp_path):
    """A port store with a WAL: save, more writes, crash (no save); both
    packages recover the same state from the checkpoint + log."""
    d, _ = data
    _, ts = _pair(data)
    path = str(tmp_path / "wal_store")
    ts.save(path)
    ts.enable_wal(path, TWalConfig(sync_every=1))
    ts.append(d[1000:1040], VALS[:40])
    ts.delete(np.arange(5, 900, 17))
    ts.index.wal.sync()
    recovered_t = TStore.load(path, device="cpu")
    recovered_j = JStore.load(path)
    for rec in (recovered_t, recovered_j):
        rec.index.detach_wal().close()
    _assert_same(_state(recovered_j.index), _state(ts.index))
    _assert_same(_state(recovered_t.index), _state(ts.index))
    ts.index.detach_wal().close()


def test_serving_engine_routes_store_traffic(data):
    """With an engine attached: lookups go through its queue, writes are
    routed, compact() is a forced maintenance swap; reattaching stops the
    previous engine (the repro regression)."""
    from repro_torch.serve import EngineClosed

    d, queries = data
    js, ts = _pair(data)
    je, te = js.serving_engine(JSP), ts.serving_engine(TSP, start=True)
    assert te.running
    jn = js.append(d[1000:1050], VALS[:50])
    tn = ts.append(d[1000:1050], VALS[:50])
    np.testing.assert_array_equal(tn, jn)
    js.delete(jn[::2])
    ts.delete(tn[::2])
    js.compact()
    ts.compact()
    assert te.epoch == 1 and ts.index is not te.index
    _assert_same(_state(je.index), _state(te.index))
    ids, dist = ts.lookup(queries, TSP)
    assert isinstance(ids, np.ndarray)
    assert_within_contract(*js.lookup(queries, JSP), ids, dist)
    np.testing.assert_array_equal(host(ts.values_at(ids)),
                                  np.asarray(js.values_at(ids)))
    second = ts.serving_engine(TSP)
    assert ts.engine is second and not te.running
    with pytest.raises(EngineClosed):
        te.submit(queries[:1])
    assert ts.lookup(queries[:4], TSP)[0].shape == (4, TSP.k)


def test_knn_lm_mix_matches_repro(data):
    d, queries = data
    js, ts = _pair(data)
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(Q, 31)).astype(np.float32)
    want = np.asarray(j_knn_lm_mix(logits, queries, js, JSP, lam=0.3,
                                   temperature=2.0))
    got = t_knn_lm_mix(torch.from_numpy(logits), queries, ts, TSP, lam=0.3,
                       temperature=2.0)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    # fewer live entries than k: the -1 slots are masked in both
    small = (JStore.build(d[:5], VALS[:5], JCFG), TStore.build(d[:5], VALS[:5], TCFG,
                                                              device="cpu"))
    want = np.asarray(j_knn_lm_mix(logits[:4], queries[:4], small[0], JSP))
    got = t_knn_lm_mix(torch.from_numpy(logits[:4]), queries[:4], small[1], TSP)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_first_static_store_bundle_loads_in_the_port(data, tmp_path):
    """The first store format (one static index bundle + values sidecar)
    is adopted as one sealed segment, as ``repro`` does."""
    import dataclasses

    d, queries = data
    static = JIndex.build(d[:500], dataclasses.replace(JCFG, store_points=False))
    values = np.arange(500, dtype=np.int32) % 11
    j_save_index_bundle(static, str(tmp_path / "old"), kind="retrieval_store",
                        extra_arrays={"values": values})
    store = TStore.load(str(tmp_path / "old"), device="cpu")
    jstore = JStore.load(str(tmp_path / "old"))
    assert_within_contract(*jstore.lookup(queries, JSP), *store.lookup(queries, TSP))
    np.testing.assert_array_equal(host(store.values), values)
    store.append(d[500:510], np.arange(10, dtype=np.int32))
    assert store.index.n_live == 510


# -- the sharded-mutable store (4 logical shards) ---------------------------------


def sharded_store(keys, values, **kw):
    return TStore.build(keys, values, TCFG, shards=SHARDS, buffer_capacity=BUFFER,
                        device="cpu", **kw)


def write_v3_store(path, keys, values):
    """The first sharded store checkpoint: a static sharded index (format
    3) and a values sidecar."""
    ShardedHilbertIndex.build(keys, TCFG, n_shards=SHARDS, device="cpu").save(
        path, kind="retrieval_store_sharded", extra_meta={"values_step": 1})
    bundle.save(os.path.join(path, "store_values"), 1, {"values": values},
                extra={"kind": "retrieval_store_sharded"})


def occupied(state):
    """Buffer slots past each shard's count zeroed (a load starts empty)."""
    pts = state["buf_pts"].copy()
    for sh, c in enumerate(state["buf_count"]):
        pts[sh, c:] = 0
    return dict(state, buf_pts=pts)


def assert_same_arrays(a, b):
    assert set(a) == set(b), set(a) ^ set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def unpadded(state):
    """A mutable state with each segment's ``n_valid`` -1 (unpadded) read as
    its row count, as a bulk load records it."""
    return dict(state, segments=[(g, nv if nv >= 0 else len(ids), ids, arrays)
                                 for g, nv, ids, arrays in state["segments"]])


def ref_stage(ref, name):
    p = name + "/"
    return {k[len(p):]: ref[k] for k in ref.files
            if k.startswith(p) and "/lookup/" not in k}


def ref_lookup(ref, name):
    return ref[name + "/lookup/ids"], ref[name + "/lookup/d2"]


@pytest.fixture(scope="module")
def four_devices(data, tmp_path_factory):
    """``repro``'s 4-device run (its ``ref.npz`` and ``v4_jax`` bundle) and
    the port's run of the same script; the port writes ``v4_port`` (after
    stage delete) and ``v3_port`` first, for ``repro`` to load."""
    d, queries = data
    out = str(tmp_path_factory.mktemp("store_4dev"))
    port = {}

    def on_stage(name, store):
        assert store.is_sharded and store.sharded.n_shards == SHARDS
        ids, d2 = store.lookup(queries, TSP)
        port[name] = (store_state(store, state_arrays), ids, d2,
                      store.values_at(ids, fill=-1))
        if name == "delete":
            store.save(os.path.join(out, "v4_port"))

    store_script(sharded_store, d, on_stage)
    write_v3_store(os.path.join(out, "v3_port"), d[:BASE], base_values())
    run(out)
    return np.load(os.path.join(out, "ref.npz")), out, port


@pytest.mark.parametrize("stage", STAGES)
def test_sharded_store_bit_equal_to_jax_four_devices(four_devices, stage):
    ref, _, port = four_devices
    state, ids, d2, vals = port[stage]
    assert_same_arrays(state, ref_stage(ref, stage))
    assert_within_contract(*ref_lookup(ref, stage), ids, d2)
    ids = host(ids)
    np.testing.assert_array_equal(host(vals), np.where(ids >= 0, state["values"][ids], -1))
    same = ids == ref[stage + "/lookup/ids"]
    np.testing.assert_array_equal(host(vals)[same], ref[stage + "/lookup/values"][same])


@pytest.mark.parametrize("name", ["v4_port", "v3_port"])
def test_port_store_bundles_load_on_jax_four_devices(four_devices, name):
    """``repro`` on 4 devices loads the port's v4 store and adopts its v3
    store; the port's own loads of them hold the same state."""
    ref, out, port = four_devices
    got = TStore.load(os.path.join(out, name), device="cpu")
    assert got.is_sharded and got.sharded.n_shards == SHARDS
    state = store_state(got, state_arrays)
    assert_same_arrays(occupied(state), occupied(ref_stage(ref, name)))
    if name == "v4_port":
        assert_same_arrays(occupied(state), occupied(port["delete"][0]))
    assert_within_contract(*ref_lookup(ref, name), *got.lookup(data_queries(), TSP))


def data_queries():
    return dataset()[1]


def test_jax_store_bundle_loads_in_port(four_devices, tmp_path):
    ref, out, _ = four_devices
    shutil.copytree(os.path.join(out, "v4_jax"), tmp_path / "b")
    got = TStore.load(str(tmp_path / "b"), device="cpu")
    assert got.is_sharded
    assert_same_arrays(occupied(store_state(got, state_arrays)),
                       occupied(ref_stage(ref, "delete")))
    assert_within_contract(*ref_lookup(ref, "delete"), *got.lookup(data_queries(), TSP))


@pytest.mark.parametrize("name", ["v4_port", "v3_port"])
def test_port_store_bundles_degrade_to_one_device_like_repro(four_devices, name, tmp_path):
    """On one device ``repro`` degrades a v4 store and reshards a v3 one
    into the mutable layout; the port's ``load(n_shards=1)`` equals it."""
    _, out, _ = four_devices
    shutil.copytree(os.path.join(out, name), tmp_path / "b")
    jstore = JStore.load(str(tmp_path / "b"))
    tstore = TStore.load(str(tmp_path / "b"), n_shards=1, device="cpu")
    assert not jstore.is_sharded and not tstore.is_sharded
    _assert_same(_state(jstore.index), _state(tstore.index))
    queries = data_queries()
    assert_within_contract(*jstore.lookup(queries, JSP), *tstore.lookup(queries, TSP))


def test_sharded_store_equals_a_direct_sharded_index(data):
    """Build, lookups, appends and deletes: the store equals the index it
    wraps, bit for bit."""
    d, queries = data
    store = sharded_store(d[:BASE], base_values())
    direct = ShardedMutableHilbertIndex.build(
        d[:BASE], dataclasses.replace(TCFG, shards=SHARDS), n_shards=SHARDS,
        values=base_values(), buffer_capacity=BUFFER, device="cpu")
    for step in range(3):
        for got, want in zip(store.lookup(queries, TSP), direct.search(queries, TSP)):
            assert torch.equal(got, want)
        ids = store.lookup(queries, TSP)[0]
        assert torch.equal(store.values_at(ids), direct.values_at(ids))
        rows = d[BASE + 100 * step : BASE + 100 * (step + 1)]
        vals = np.full(len(rows), step, np.int32)
        np.testing.assert_array_equal(store.append(rows, vals), direct.insert(rows, vals))
        assert store.delete(np.arange(step, BASE, 11)) == direct.delete(
            np.arange(step, BASE, 11))
    assert torch.equal(store.values, direct.values_dense())
    assert store.memory_report() == direct.memory_report()
    assert store.sharded.n_segments >= 2


def test_sharded_store_save_load_reshard_and_degrade(data, tmp_path):
    d, queries = data
    store = sharded_store(d[:BASE], base_values())
    path = str(tmp_path / "s")
    store.save(path)
    one = TStore.load(path, n_shards=1, device="cpu")
    single = TStore.build(d[:BASE], base_values(), TCFG, buffer_capacity=BUFFER,
                          device="cpu")
    assert isinstance(one.index, MutableHilbertIndex)
    _assert_same(unpadded(_state(single.index)), unpadded(_state(one.index)))
    store.append(d[BASE : BASE + 150], np.arange(150, dtype=np.int32))
    store.delete(np.arange(0, BASE + 150, 9))
    store.save(path)
    back = TStore.load(path, device="cpu")
    assert_same_arrays(occupied(store_state(back, state_arrays)),
                       occupied(store_state(store, state_arrays)))
    for a, b in zip(back.lookup(queries, TSP), store.lookup(queries, TSP)):
        assert torch.equal(a, b)
    assert TStore.load(path, n_shards=2, device="cpu").sharded.n_shards == 2
    one = TStore.load(path, n_shards=1, device="cpu")
    _assert_same(_state(load_sharded_mutable_as_mutable(
        path, kind="retrieval_store_sharded", device="cpu")), _state(one.index))
    assert one.index.n_live == store.sharded.n_live


def test_save_switching_layout_removes_the_other(data, tmp_path):
    """A save that switches layout leaves no manifest or segment bundle of
    the other behind, and the newest layout loads."""
    d, _ = data
    path = tmp_path / "s"
    sharded_store(d[:BASE], base_values()).save(str(path))
    assert (path / "sharded_mutable_manifest.json").exists()
    single = TStore.build(d[:500], VALS[:500], TCFG, device="cpu")
    single.save(str(path))
    assert not (path / "sharded_mutable_manifest.json").exists()
    assert not [n for n in os.listdir(path / "segments") if n.startswith("gen_")]
    assert not TStore.load(str(path), device="cpu").is_sharded
    write_v3_store(str(tmp_path / "v3"), d[:BASE], base_values())
    upgraded = TStore.load(str(tmp_path / "v3"), device="cpu")
    upgraded.save(str(tmp_path / "v3"))
    for gone in ("sharded_manifest.json", "shards", "store_values"):
        assert not (tmp_path / "v3" / gone).exists()
    assert TStore.load(str(tmp_path / "v3"), device="cpu").is_sharded
    upgraded.sharded = None
    upgraded.index = single.index
    upgraded.save(str(path))
    assert (path / "mutable_manifest.json").exists()


def test_sharded_store_serving_engine_routes_traffic(data):
    d, queries = data
    store = sharded_store(d[:BASE], base_values())
    direct = store.lookup(queries, TSP)
    eng = store.serving_engine(TSP)
    got = store.lookup(queries, TSP)
    assert all(np.array_equal(a, host(b)) for a, b in zip(got, direct))
    store.append(d[BASE : BASE + 80], np.zeros(80, np.int32))
    store.delete(np.arange(0, 200, 3))
    store.compact()
    assert eng.epoch == 1 and store._impl is not store.sharded
    assert store._impl.n_segments == 1 and store._impl.n_shards == SHARDS
    got = store.lookup(queries, TSP)
    want = store._impl.search(queries, TSP, query_chunk=16, allow_rewrite=False)
    assert all(np.array_equal(a, host(b)) for a, b in zip(got, want))
    logits = np.random.default_rng(1).normal(size=(Q, 31)).astype(np.float32)
    mixed = t_knn_lm_mix(torch.from_numpy(logits), queries, store, TSP)
    np.testing.assert_allclose(mixed.exp().sum(-1).numpy(), 1.0, rtol=1e-5)
