"""Port parity: ``repro_torch.serve.RetrievalStore`` and ``knn_lm_mix``.

The single-device cases of ``tests/test_mutable_index.py`` run on both
packages from the same inputs: build, append, delete, lookup, compact,
enable_wal, save/load, serving_engine and values_at.  Store bundles load
across packages in both directions, and ``knn_lm_mix`` agrees within
rtol 1e-5 / atol 1e-6.  The sharded layouts raise in the port.
"""

import numpy as np
import pytest
import torch

from repro.index import save_index_bundle as j_save_index_bundle
from repro.index import HilbertIndex as JIndex
from repro.serve.retrieval import RetrievalStore as JStore
from repro.serve.retrieval import knn_lm_mix as j_knn_lm_mix
from repro_torch.checkpoint.wal import WalConfig as TWalConfig
from repro_torch.serve.retrieval import RetrievalStore as TStore
from repro_torch.serve.retrieval import knn_lm_mix as t_knn_lm_mix
from _torch_parity import (JCFG, JSP, TCFG, TSP, Q, assert_within_contract,
                           dataset, host)
from test_torch_mutable import _assert_same, _state

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


def test_sharded_layouts_raise_naming_module_12(data, tmp_path):
    d, _ = data
    with pytest.raises(NotImplementedError, match="module 12"):
        TStore.build(d[:100], VALS[:100], TCFG, shards=2, device="cpu")
    (tmp_path / "s").mkdir()
    (tmp_path / "s" / "sharded_mutable_manifest.json").write_text("{}")
    with pytest.raises(NotImplementedError, match="module 12"):
        TStore.load(str(tmp_path / "s"), device="cpu")
