"""Port parity: ``repro_torch``'s ``MutableHilbertIndex`` against ``repro``'s.

Each case runs the same insert/bulk_load/delete/flush/compact sequence on
both packages, on inputs made from a numpy seed, and holds the port to:

* **state**, bit for bit: external ids, ``alive``, ``values``, ``next_id``,
  the buffer, and every segment's ``gen``, ``ids``, ``n_valid`` and arrays;
* **search**, within the contract of ``tests/test_kernels_integration.py``
  (``DIST_RTOL``, ``DIST_ATOL``, ids equal except inside ``TIE_ATOL`` ties).

Buffer distances use the Gram form, which XLA:CPU and torch round
differently when a query is one of the points, so parity searches use the
held-out queries of the dataset; cases that query with inserted points
compare ids only.  Then the cases of ``tests/test_mutable_index.py`` and
``tests/test_durability.py`` that concern the index, run on the port.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import WalConfig as JWalConfig
from repro.core.types import ForestConfig as JForestConfig
from repro.core.types import SearchParams as JSearchParams
from repro.index import HilbertIndex as JIndex
from repro.index import IndexConfig as JIndexConfig
from repro.index import MutableHilbertIndex as JMutable
from repro_torch.data import ann_datasets
from repro_torch.index import (ForestConfig, HilbertIndex, IndexConfig,
                               MutableHilbertIndex, SearchParams, WalConfig)
from repro_torch.index import mutable as tmutable
from test_kernels_integration import (DIST_ATOL, DIST_RTOL,
                                      _assert_ids_equal_up_to_distance_ties)

N, D, Q = 2000, 32, 24
FOREST = dict(n_trees=4, bits=4, key_bits=128, leaf_size=16, seed=0)
SP = dict(k1=16, k2=64, h=1, k=10)
CFG = IndexConfig(forest=ForestConfig(**FOREST))


def _cfgs(**kw):
    return (JIndexConfig(forest=JForestConfig(**FOREST), **kw),
            IndexConfig(forest=ForestConfig(**FOREST), **kw))


def _pair(*, buffer_capacity=4096, max_segments=8, **cfg_kw):
    jc, tc = _cfgs(**cfg_kw)
    return (JMutable(jc, buffer_capacity=buffer_capacity, max_segments=max_segments),
            MutableHilbertIndex(tc, buffer_capacity=buffer_capacity,
                                max_segments=max_segments, device="cpu"))


@pytest.fixture(scope="module")
def dataset():
    return ann_datasets.lowrank_dataset_with_queries(N, Q, D, n_clusters=8, seed=0)


def _segment_arrays(index):
    if isinstance(index, HilbertIndex):
        return index.array_bundle()
    return {k: np.asarray(v) for k, v in index._array_bundle().items()}


def _state(mut):
    n = mut._buf_count
    return {
        "next_id": mut._next_id, "gen": mut._gen, "dim": mut._dim,
        "track_values": mut._track_values, "alive": mut._alive,
        "values": mut._values, "buf_ids": None if n == 0 else mut._buf_ids[:n],
        "buf_points": None if n == 0 else mut._buf_points[:n],
        "segments": [(s.gen, s.n_valid, s.ids, _segment_arrays(s.index))
                     for s in mut.segments],
    }


def _assert_same(want, got, where=""):
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), where
        for k in want:
            _assert_same(want[k], got[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), where
        for i, (a, b) in enumerate(zip(want, got)):
            _assert_same(a, b, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert want.dtype == got.dtype and want.shape == got.shape, where
        np.testing.assert_array_equal(want, got, err_msg=where)
    else:
        assert want == got, where


def _assert_same_state(jm, tm):
    _assert_same(_state(jm), _state(tm))


def _assert_search_matches(jm, tm, queries, sp=SP, **kw):
    jids, jd = jm.search(jnp.asarray(queries), JSearchParams(**sp), **kw)
    tids, td = tm.search(queries, SearchParams(**sp), **kw)
    assert tids.dtype == torch.int32 and td.dtype == torch.float32
    assert tids.device == tm.device and tids.shape == (len(queries), sp["k"])
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=DIST_RTOL,
                               atol=DIST_ATOL)
    _assert_ids_equal_up_to_distance_ties(jids, tids.numpy(), jd)
    return tids.numpy(), td.numpy()


def _both(jm, tm, fn):
    """Apply ``fn(mut)`` to both indexes; its results (other than the index
    itself, which ``compact`` returns) must be equal."""
    jr, tr = fn(jm), fn(tm)
    if jr is not jm:
        _assert_same(jr, tr)
    return tr


# -- streaming equivalence ---------------------------------------------------


def test_streamed_equals_fresh_build_after_compact(dataset):
    data, queries = dataset
    jm, tm = _pair(buffer_capacity=300, max_segments=4)
    ids_a = _both(jm, tm, lambda m: m.insert(data[:1200]))
    _both(jm, tm, lambda m: m.delete(ids_a[50:150]))
    ids_b = _both(jm, tm, lambda m: m.insert(data[1200:]))
    _assert_same_state(jm, tm)
    _assert_search_matches(jm, tm, queries)
    _both(jm, tm, lambda m: m.compact())
    _assert_same_state(jm, tm)
    assert tm.n_segments == 1 and tm.n_live == N - 100

    live_mask = np.ones(N, bool)
    live_mask[50:150] = False
    fresh = HilbertIndex.build(data[live_mask], CFG, device="cpu")
    fids, fd2 = fresh.search(queries, SearchParams(**SP))
    mids, md2 = _assert_search_matches(jm, tm, queries)
    assert np.array_equal(md2, fd2.numpy())
    live_ids = np.concatenate([ids_a, ids_b])[live_mask]
    assert np.array_equal(live_ids[fids.numpy()], mids)


def test_multisegment_recall_at_least_fresh(dataset):
    data, queries = dataset
    jm, tm = _pair(buffer_capacity=300, max_segments=6)
    ids = _both(jm, tm, lambda m: m.insert(data))
    dead = np.random.default_rng(1).choice(N, 200, replace=False)
    _both(jm, tm, lambda m: m.delete(ids[dead]))
    _both(jm, tm, lambda m: m.insert(data[:100]))
    assert tm.n_segments > 1
    _assert_same_state(jm, tm)
    mids, _ = _assert_search_matches(jm, tm, queries)

    live_mask = np.ones(N, bool)
    live_mask[dead] = False
    live_ids = np.concatenate([ids[live_mask], np.arange(N, N + 100)])
    live_pts = np.concatenate([data[live_mask], data[:100]])
    gt, _ = ann_datasets.exact_knn(live_pts, queries, SP["k"])
    pos_of = {int(e): i for i, e in enumerate(live_ids)}
    pos = np.vectorize(lambda e: pos_of.get(int(e), -1))(mids)
    fresh = HilbertIndex.build(live_pts, CFG, device="cpu")
    fpos = fresh.search(queries, SearchParams(**SP))[0].numpy()
    assert ann_datasets.recall_at_k(pos, gt) >= ann_datasets.recall_at_k(fpos, gt)


# -- tombstone edge cases ----------------------------------------------------


def test_delete_then_reinsert(dataset):
    data, _ = dataset
    jm, tm = _pair(buffer_capacity=128)
    ids = _both(jm, tm, lambda m: m.insert(data[:64]))
    assert _both(jm, tm, lambda m: m.delete(ids[:32])) == 32
    assert _both(jm, tm, lambda m: m.delete(ids[:32])) == 0  # idempotent
    ids2 = _both(jm, tm, lambda m: m.insert(data[:32]))
    assert (ids2 > ids.max()).all()
    _assert_same_state(jm, tm)
    # Queries on the point set: ids only (the Gram form's rounding differs).
    sp = dict(SP, k=4)
    jhits = np.asarray(jm.search(jnp.asarray(data[:4]), JSearchParams(**sp))[0])
    hits, d2 = tm.search(data[:4], SearchParams(**sp))
    hits = hits.numpy()
    assert not np.isin(hits, ids[:32]).any()
    assert d2.numpy()[:, 0] == pytest.approx(0.0, abs=1e-3)
    assert (hits[:, 0] == ids2[:4]).all() and (jhits[:, 0] == ids2[:4]).all()


def test_delete_entire_segment_and_compact(dataset):
    data, queries = dataset
    jm, tm = _pair(buffer_capacity=100, max_segments=10)
    ids_a = _both(jm, tm, lambda m: m.insert(data[:100]))
    ids_b = _both(jm, tm, lambda m: m.insert(data[100:200]))
    assert tm.n_segments == 2
    _both(jm, tm, lambda m: m.delete(ids_a))
    hits, _ = _assert_search_matches(jm, tm, queries)
    assert not np.isin(hits, ids_a).any()
    assert np.isin(hits[hits >= 0], ids_b).all()
    # A snapshot shares the segments and compacts apart from its source.
    jsnap, snap = jm.snapshot(), tm.snapshot()
    assert snap.segments[0].index is tm.segments[0].index and snap.wal is None
    _both(jsnap, snap, lambda m: m.compact())
    _assert_same_state(jsnap, snap)
    assert tm.n_segments == 2
    _both(jm, tm, lambda m: m.compact())
    _assert_same_state(jm, tm)
    assert tm.n_segments == 1 and tm.segments[0].n_points == 100
    assert np.array_equal(tm.segments[0].ids, ids_b)


def test_search_k_exceeds_live_points(dataset):
    data, queries = dataset
    jm, tm = _pair(buffer_capacity=16)
    ids = _both(jm, tm, lambda m: m.insert(data[:24]))  # 16 sealed + 8 buffered
    _both(jm, tm, lambda m: m.delete(ids[20:]))
    hits, d2 = _assert_search_matches(jm, tm, queries, dict(SP, k=30))
    for row, drow in zip(hits, d2):
        assert set(row[row >= 0].tolist()) == set(ids[:20].tolist())
        assert (row[20:] == -1).all() and np.isinf(drow[20:]).all()
    empty = MutableHilbertIndex(CFG, device="cpu")
    ehits, ed2 = empty.search(queries, SearchParams(**SP))
    assert (ehits == -1).all() and torch.isinf(ed2).all()


def test_flush_drops_dead_buffer_rows(dataset):
    data, _ = dataset
    jm, tm = _pair(buffer_capacity=512)
    ids = _both(jm, tm, lambda m: m.insert(data[:64]))
    _both(jm, tm, lambda m: m.delete(ids))
    assert tm.flush() is None and jm.flush() is None
    assert tm.n_segments == 0 and tm.n_buffered == 0
    _assert_same_state(jm, tm)


def test_heavily_tombstoned_segment_rewritten_on_read(dataset):
    data, queries = dataset
    sp = dict(SP, k2=32, h=1, k=10)  # pool cap = 96
    jm, tm = _pair(buffer_capacity=200)
    ids = _both(jm, tm, lambda m: m.insert(data[:200]))
    gen_before = tm.segments[0].gen
    _both(jm, tm, lambda m: m.delete(ids[:150]))  # dead=150 > cap-k=86
    assert tm.rewrite_pressure(SearchParams(**sp)) == 1
    # allow_rewrite=False leaves the segment as it is, in both packages.
    _assert_search_matches(jm, tm, queries, sp, allow_rewrite=False)
    assert tm.segments[0].gen == gen_before
    hits, _ = _assert_search_matches(jm, tm, queries, sp)
    _assert_same_state(jm, tm)
    assert tm.segments[0].gen != gen_before and tm.segments[0].n_points == 50
    assert tm.rewrite_pressure(SearchParams(**sp)) == 0
    assert np.isin(hits[hits >= 0], ids[150:]).all()
    # store_points=False cannot rewrite: it degrades, it does not crash.
    jslim, slim = _pair(buffer_capacity=200, store_points=False)
    sids = _both(jslim, slim, lambda m: m.insert(data[:200]))
    _both(jslim, slim, lambda m: m.delete(sids[:150]))
    shits, _ = _assert_search_matches(jslim, slim, queries, sp)
    assert not np.isin(shits, sids[:150]).any()


# -- validation and values ---------------------------------------------------


def test_failed_insert_leaves_state_unchanged(dataset):
    data, _ = dataset
    jm, tm = _pair(buffer_capacity=128)
    _both(jm, tm, lambda m: m.insert(data[:10], values=np.arange(10, dtype=np.int32)))
    for m in (jm, tm):
        with pytest.raises(ValueError, match="values must be"):
            m.insert(data[10:20], values=np.arange(7, dtype=np.int32))
        with pytest.raises(ValueError, match="dim mismatch"):
            m.insert(data[10:20, :5], values=np.arange(10, dtype=np.int32))
        with pytest.raises(KeyError):
            m.delete(np.array([3, 99]))
    _assert_same_state(jm, tm)
    assert tm.n_live == 10 and tm._next_id == 10
    ids = _both(jm, tm, lambda m: m.insert(
        data[10:20], values=np.arange(10, 20, dtype=np.int32)))
    assert np.array_equal(ids, np.arange(10, 20))
    assert np.array_equal(tm.values_at(ids).numpy(), np.arange(10, 20))
    # A failed first insert does not pin the values mode.
    fresh = MutableHilbertIndex(CFG, device="cpu")
    with pytest.raises(ValueError, match="values must be"):
        fresh.insert(data[:10], values=np.arange(3))
    fresh.insert(data[:10])
    assert fresh._track_values is False


def test_values_tracking_is_all_or_nothing(dataset):
    data, _ = dataset
    mut = MutableHilbertIndex(CFG, device="cpu")
    mut.insert(data[:8], values=np.arange(8))
    with pytest.raises(ValueError, match="values"):
        mut.insert(data[8:16])
    hits = torch.tensor([[3, -1], [7, 0]], dtype=torch.int32)
    assert mut.values_at(hits, fill=-5).tolist() == [[3, -5], [7, 0]]
    assert mut.values_dense().tolist() == list(range(8))
    plain = MutableHilbertIndex(CFG, device="cpu")
    plain.insert(data[:8])
    with pytest.raises(ValueError, match="values"):
        plain.insert(data[8:16], values=np.arange(8))
    with pytest.raises(ValueError, match="values"):
        plain.values_at(np.array([0]))


def test_store_points_false_serves_but_cannot_compact(dataset):
    data, queries = dataset
    jm, tm = _pair(buffer_capacity=100, max_segments=2, store_points=False)
    _both(jm, tm, lambda m: m.insert(data[:500]))  # past max_segments: no merge
    assert tm.n_segments >= 2 and all(s.index.points is None for s in tm.segments)
    _assert_same_state(jm, tm)
    _assert_search_matches(jm, tm, queries)
    with pytest.raises(ValueError, match="store_points"):
        tm.compact()
    fat = MutableHilbertIndex(CFG, buffer_capacity=100, device="cpu")
    fat.insert(data[:500])
    assert tm.memory_report()["segments_bytes"] < fat.memory_report()["segments_bytes"]


def test_from_index_adoption(dataset):
    data, queries = dataset
    jbase = JIndex.build(jnp.asarray(data[:500]), _cfgs()[0])
    base = HilbertIndex.build(data[:500], CFG, device="cpu")
    jm = JMutable.from_index(jbase, buffer_capacity=64)
    tm = MutableHilbertIndex.from_index(base, buffer_capacity=64)
    assert tm.device == base.device and tm.n_live == 500 and tm.n_segments == 1
    new_ids = _both(jm, tm, lambda m: m.insert(data[500:550]))
    _both(jm, tm, lambda m: m.delete(np.arange(10)))
    _assert_same_state(jm, tm)
    hits, _ = _assert_search_matches(jm, tm, queries)
    assert not np.isin(hits, np.arange(10)).any()
    assert tm.n_live == 540 and (new_ids >= 500).all()
    with pytest.raises(ValueError, match="values"):  # valueless mode pinned
        MutableHilbertIndex.from_index(base).insert(data[:3], values=np.arange(3))


def test_memory_report_and_repr(dataset):
    data, _ = dataset
    jm, tm = _pair(buffer_capacity=256)
    _both(jm, tm, lambda m: m.insert(data[:600], values=np.arange(600, dtype=np.int32)))
    rep = tm.memory_report()
    assert rep == jm.memory_report()
    assert rep["segments_bytes"] == sum(rep["per_segment"]) and rep["buffer_bytes"] > 0
    assert rep["values_bytes"] == 600 * 4 and rep["tombstone_bytes"] == 600
    assert rep["total_bytes"] == (rep["segments_bytes"] + rep["buffer_bytes"]
                                  + rep["values_bytes"] + rep["tombstone_bytes"])
    assert "n_segments=2" in repr(tm) and "n_live=600" in repr(tm)
    assert "n_points=256" in repr(tm.segments)
    assert tm.maintenance_stats() == jm.maintenance_stats()


def test_seal_pow2_pads_seals_and_compact_unpads(dataset):
    data, queries = dataset
    jm, tm = _pair(buffer_capacity=24, max_segments=3, seal_pow2=True)
    ids = _both(jm, tm, lambda m: m.insert(data[:24]))  # one exact flush
    assert tm.segments[0].n_real == 24 and tm.segments[0].n_points == 32
    got = tm.search(data[:6], SearchParams(**SP))[0].numpy()
    assert (got[:, 0] == ids[:6]).all()
    for row in got:  # padding never duplicates ids
        assert len(set(row[row >= 0].tolist())) == len(row[row >= 0])
    # Tier merges pad too, and pick the same two segments in both packages.
    _both(jm, tm, lambda m: m.delete(ids[::5]))
    _both(jm, tm, lambda m: m.insert(data[24:130]))
    assert any(s.n_pad for s in tm.segments[1:])
    _assert_same_state(jm, tm)
    _assert_search_matches(jm, tm, queries)
    _both(jm, tm, lambda m: m.compact())
    assert tm.segments[0].n_pad == 0
    _assert_same_state(jm, tm)


# -- persistence ---------------------------------------------------------------


def _churn(m, data):
    ids = m.insert(data[:700], values=np.arange(700, dtype=np.int32) % 17)
    m.delete(ids[::7])
    m.bulk_load(data[700:1000], values=np.arange(700, 1000, dtype=np.int32) % 17)
    m.insert(data[1000:1100], values=np.arange(1000, 1100, dtype=np.int32) % 17)
    m.delete(ids[1:30:3])


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_mutable_bundles_load_across_packages(tmp_path, dataset, saver):
    data, queries = dataset
    jm, tm = _pair(buffer_capacity=300, max_segments=3)
    _both(jm, tm, lambda m: _churn(m, data))
    assert tm.n_segments > 1 and tm.n_buffered > 0
    path = str(tmp_path / "m")
    (jm if saver == "jax" else tm).save(path)
    jl = JMutable.load(path)
    tl = MutableHilbertIndex.load(path, device="cpu")
    _assert_same_state(jm, tl)
    _assert_same_state(jm, jl)
    _assert_search_matches(jl, tl, queries)
    assert ([s.content_uid() for s in tl.segments]
            == [s.content_uid() for s in jm.segments])
    # A re-save by the other package skips the segment bundles it finds.
    steps = {name: sorted(os.listdir(os.path.join(path, "segments", name)))
             for name in os.listdir(os.path.join(path, "segments"))}
    (tl if saver == "jax" else jl).save(path)
    for name, want in steps.items():
        assert sorted(os.listdir(os.path.join(path, "segments", name))) == want
    _assert_same_state(jm, MutableHilbertIndex.load(path, device="cpu"))


def test_save_load_roundtrip_and_continue(tmp_path, dataset):
    data, queries = dataset
    mut = MutableHilbertIndex(CFG, buffer_capacity=300, max_segments=4, device="cpu")
    _churn(mut, data)
    h1, d1 = mut.search(queries, SearchParams(**SP))
    path = str(tmp_path / "m")
    mut.save(path)
    loaded = MutableHilbertIndex.load(path, device="cpu")
    assert loaded.config == mut.config and loaded.device == torch.device("cpu")
    _assert_same(_state(mut), _state(loaded))
    h2, d2 = loaded.search(queries, SearchParams(**SP))
    assert torch.equal(h1, h2) and torch.equal(d1, d2)
    assert torch.equal(loaded.values_at(h1), mut.values_at(h1))
    # Mutations after load work (restored state is writable).
    assert loaded.delete(np.asarray([5, 9], np.int32)) == 2
    loaded.insert(data[1100:1200], values=np.arange(1100, 1200, dtype=np.int32) % 17)
    loaded.compact()
    assert loaded.n_segments == 1
    with pytest.raises(ValueError, match="kind"):
        tmutable.load_mutable_bundle(path, kind="retrieval_store", device="cpu")
    with pytest.raises(FileNotFoundError):
        MutableHilbertIndex.load(str(tmp_path / "missing"), device="cpu")


def test_resave_is_nondestructive_and_foreign_saves_keep_no_stale_segments(
        tmp_path, dataset):
    data, queries = dataset
    sp = SearchParams(**SP)
    path = str(tmp_path / "m")
    mut = MutableHilbertIndex(CFG, buffer_capacity=200, max_segments=8, device="cpu")
    ids = mut.insert(data[:500])
    mut.save(path)
    h1, d1 = mut.search(queries, sp)
    manifest_v1 = (tmp_path / "m" / "mutable_manifest.json").read_bytes()
    mut.delete(ids[:250])
    mut.insert(data[500:900])
    mut.compact()
    mut.save(path)
    h2, _ = mut.search(queries, sp)
    assert torch.equal(MutableHilbertIndex.load(path, device="cpu").search(queries, sp)[0], h2)
    # A crash before the second manifest's rename: the first one's bundles
    # are all still there.
    (tmp_path / "m" / "mutable_manifest.json").write_bytes(manifest_v1)
    loaded1 = MutableHilbertIndex.load(path, device="cpu")
    assert loaded1.n_live == 500 and loaded1.n_deleted == 0
    l1 = loaded1.search(queries, sp)
    assert torch.equal(l1[0], h1) and torch.equal(l1[1], d1)

    # Same gen, size and ids but other points: rewritten, not skipped.
    other = str(tmp_path / "o")
    a = MutableHilbertIndex(CFG, buffer_capacity=512, device="cpu")
    a.bulk_load(data[:200])
    a.save(other)
    b = MutableHilbertIndex(CFG, buffer_capacity=512, device="cpu")
    b.bulk_load(data[200:400])
    b.save(other)
    hb, db = b.search(queries, sp)
    hl, dl = MutableHilbertIndex.load(other, device="cpu").search(queries, sp)
    assert torch.equal(hb, hl) and torch.equal(db, dl)


def test_saves_prune_unreferenced_bundles(tmp_path, dataset):
    data, _ = dataset
    path = str(tmp_path / "m")
    mut = MutableHilbertIndex(CFG, buffer_capacity=100, max_segments=10, device="cpu")
    for i in range(4):
        mut.insert(data[i * 100 : (i + 1) * 100])
        mut.compact()
        mut.save(path)
    state_steps = [n for n in os.listdir(os.path.join(path, "state"))
                   if n.startswith("step_")]
    assert len(state_steps) <= 2 and len(os.listdir(os.path.join(path, "segments"))) <= 2
    assert MutableHilbertIndex.load(path, device="cpu").n_live == 400


# -- durability ----------------------------------------------------------------


def _wal_churn(m, data, path, wal_config, *, save_midway=True):
    m.enable_wal(path, wal_config)
    m.insert(data[:40], np.arange(40, dtype=np.int32))
    m.delete(np.asarray([1, 17, 33], np.int32))
    if save_midway:
        m.save(path)
    m.insert(data[40:61], np.arange(40, 61, dtype=np.int32))
    m.delete(np.asarray([0, 45], np.int32))


def test_mutable_wal_recovery_bit_equal(tmp_path, dataset):
    """Reload after an unsaved tail == the index that never went down, and
    both packages log the same bytes and recover each other's tails."""
    data, queries = dataset
    jm, tm = _pair(buffer_capacity=16, max_segments=4)
    jpath, tpath = str(tmp_path / "j"), str(tmp_path / "t")
    _wal_churn(jm, data, jpath, JWalConfig(sync_every=4))
    _wal_churn(tm, data, tpath, WalConfig(sync_every=4))
    jm.wal.sync()
    tm.wal.sync()
    with open(os.path.join(jpath, "wal.log"), "rb") as a, \
            open(os.path.join(tpath, "wal.log"), "rb") as b:
        assert a.read() == b.read()
    rec = MutableHilbertIndex.load(tpath, device="cpu")
    _assert_same(_state(tm), _state(rec))
    ids_a, d_a = tm.search(queries, SearchParams(**SP))
    ids_b, d_b = rec.search(queries, SearchParams(**SP))
    assert torch.equal(ids_a, ids_b) and d_a.numpy().tobytes() == d_b.numpy().tobytes()
    # The port recovers the JAX package's checkpoint + tail, and back.
    _assert_same_state(jm, MutableHilbertIndex.load(jpath, device="cpu"))
    _assert_same_state(JMutable.load(tpath), tm)


def test_save_truncates_wal_and_load_recovers_writes_after(tmp_path, dataset):
    data, _ = dataset
    path = str(tmp_path / "ckpt")
    mut = MutableHilbertIndex(CFG, buffer_capacity=16, max_segments=4, device="cpu")
    _wal_churn(mut, data, path, WalConfig(sync_every=4), save_midway=False)
    mut.save(path)
    from repro_torch.checkpoint import wal as twal

    assert twal.read_records(twal.wal_path(path))[0] == []
    mut.insert(data[61:66], np.arange(61, 66, dtype=np.int32))  # post-save tail
    rec = MutableHilbertIndex.load(path, device="cpu")
    _assert_same(_state(mut), _state(rec))
    with pytest.raises(ValueError, match="already"):
        rec.enable_wal(path)


def test_entry_points_raise_without_gpu_unless_cpu_is_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MutableHilbertIndex(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MutableHilbertIndex.load(str(tmp_path))
