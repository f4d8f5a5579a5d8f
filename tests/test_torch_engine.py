"""Port parity: ``repro_torch.serve.RetrievalEngine`` against ``repro``'s.

Both packages serve the same bundle (``repro`` saves it, each loads it;
the port on the CPU) through the same operations:

* step-mode results within the contract of
  ``tests/test_kernels_integration.py``, and bit-equal to the port's own
  direct search;
* inserts, deletes and a forced maintenance (with writes landing while
  the shadow compacts) leave the state bit-equal to ``repro``'s — in
  thread mode, and in subprocess mode with the port's child;
* every ``engine.maint.*`` fault point fails a cycle that serving never
  sees; the deadline, queue-full, degraded and ``WalWriteError`` paths
  behave as in ``repro``;
* concurrent readers, a writer and forced swaps: every result equals a
  direct search on the epoch that served it.
"""

import threading
import time

import numpy as np
import pytest

from repro.checkpoint import WalConfig as JWalConfig
from repro.serve import engine as jengine
from repro.testing import faults as jfaults
from repro_torch.checkpoint.wal import WalConfig as TWalConfig
from repro_torch.serve import engine as tengine
from repro_torch.testing import faults as tfaults
from _torch_parity import (JSP, TSP, Q, D, assert_within_contract, dataset, host,
                           mutable_pair, static_pair)
from test_torch_mutable import _assert_same, _state

PKG = {
    "jax": (jengine, JSP, jfaults, JWalConfig),
    "torch": (tengine, TSP, tfaults, TWalConfig),
}


@pytest.fixture(scope="module")
def data():
    return dataset()


@pytest.fixture(autouse=True)
def _no_fault_plans():
    jfaults.reset()
    tfaults.reset()
    yield
    jfaults.reset()
    tfaults.reset()


@pytest.fixture(scope="module")
def statics(data, tmp_path_factory):
    return static_pair(str(tmp_path_factory.mktemp("static")), data[0])


# -- step mode --------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["static", "mutable"])
def test_step_mode_results_match_repro(data, statics, tmp_path, layout):
    """Ragged submissions, micro-batched, split back: the port's tickets
    equal its own direct search bit for bit, and ``repro``'s within the
    contract."""
    d, queries = data
    jidx, tidx = (statics if layout == "static"
                  else mutable_pair(str(tmp_path / "m"), d))
    cuts = [0, 5, 8, 20, 21, 37, Q]
    out = {}
    for name, idx in (("jax", jidx), ("torch", tidx)):
        mod, sp, _, _ = PKG[name]
        eng = mod.RetrievalEngine(idx, sp, max_batch=16)
        tickets = [eng.submit(queries[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]
        while eng.step():
            pass
        assert eng.metrics.counter("batches") < len(tickets)
        assert all(t.epoch == 0 for t in tickets)
        out[name] = (np.concatenate([t.ids for t in tickets]),
                     np.concatenate([t.dists for t in tickets]))
    ti, td = tidx.search(queries, TSP, query_chunk=16)
    assert isinstance(out["torch"][0], np.ndarray)
    np.testing.assert_array_equal(out["torch"][0], host(ti))
    np.testing.assert_array_equal(out["torch"][1], host(td))
    assert_within_contract(*out["jax"], *out["torch"])


def test_params_heterogeneity_splits_batches(statics, data):
    _, tidx = statics
    _, queries = data
    other = tengine.SearchParams(k1=16, k2=64, h=1, k=5)
    eng = tengine.RetrievalEngine(tidx, TSP, max_batch=64)
    t1, t2 = eng.submit(queries[:8], TSP), eng.submit(queries[8:16], other)
    while eng.step():
        pass
    assert eng.metrics.counter("batches") == 2
    assert t2.ids.shape == (8, 5)
    np.testing.assert_array_equal(t1.ids, host(tidx.search(queries[:8], TSP)[0]))


# -- maintenance: state bit-equal to repro ----------------------------------------


@pytest.mark.parametrize("mode", ["thread", "subprocess"])
def test_maintenance_state_bit_equal_to_repro(data, tmp_path, monkeypatch, mode):
    """The same writes through both engines, then a forced maintenance
    during which more writes land in the replay log: the swapped-in index
    is bit-equal to ``repro``'s (``repro`` in thread mode; its own tests
    hold its two modes equal), and so are the searches after it."""
    d, queries = data
    jm, tm = mutable_pair(str(tmp_path / "m"), d, n=1200)
    engines = {}
    for name, idx in (("jax", jm), ("torch", tm)):
        mod, sp, _, _ = PKG[name]
        eng = mod.RetrievalEngine(
            idx, sp, compaction=mode if name == "torch" else "thread",
            compaction_dir=str(tmp_path / f"work_{name}"))
        eng.insert(d[1200:1500])
        eng.delete(np.arange(0, 1200, 11))
        eng.insert(d[1500:1700])
        engines[name] = eng

    def during(eng):  # writes that land while the shadow compacts
        eng.insert(d[1700:1760])
        eng.delete(np.arange(1, 100, 5))

    jeng, teng = engines["jax"], engines["torch"]
    j_snapshot = jeng.index.snapshot

    def j_snap():
        shadow = j_snapshot()
        inner = shadow.compact

        def compact():
            inner()
            during(jeng)
        shadow.compact = compact
        return shadow

    jeng.index.snapshot = j_snap
    if mode == "thread":
        t_snapshot = teng.index.snapshot

        def t_snap():
            shadow = t_snapshot()
            inner = shadow.compact

            def compact():
                inner()
                during(teng)
            shadow.compact = compact
            return shadow

        teng.index.snapshot = t_snap
    else:
        inner_child = tengine.compact_in_child

        def child(shadow, workdir, **kw):
            out = inner_child(shadow, workdir, **kw)
            during(teng)
            return out

        monkeypatch.setattr(tengine, "compact_in_child", child)
    assert jeng.maintain_once(force=True) and teng.maintain_once(force=True)
    assert teng.last_swap_timeline["log_depth"] == 2
    assert teng.last_swap_timeline["compaction"] == mode
    _assert_same(_state(jeng.index), _state(teng.index))
    assert teng.index.n_segments == 1
    assert_within_contract(*jeng.search(queries), *teng.search(queries))


def test_engine_rejects_inserts_with_values_mismatch_like_repro(data, tmp_path):
    """A rejected write raises before touching the index in both packages."""
    d, _ = data
    jm, tm = mutable_pair(str(tmp_path / "m"), d, n=300)
    for name, idx in (("jax", jm), ("torch", tm)):
        mod, sp, _, _ = PKG[name]
        eng = mod.RetrievalEngine(idx, sp)
        with pytest.raises(ValueError):
            eng.insert(d[:4], np.arange(4))
        assert eng.maintenance_stats()["n_live"] == 300 - 43


# -- fault points of the maintenance cycle ----------------------------------------


@pytest.mark.parametrize("point", ["engine.maint.pre_compact",
                                   "engine.maint.post_compact",
                                   "engine.maint.pre_replay",
                                   "engine.maint.pre_swap"])
def test_maintenance_fault_aborts_cycle_invisibly(data, tmp_path, point):
    """A fault before the swap fails the cycle: same index object, epoch 0,
    same answers, the replay log closed, the WAL still on the serving
    index, and the next cycle swaps.  (``repro`` left the replay log open
    after a fault at pre_compact, post_compact or pre_replay, and moved
    the WAL to the abandoned shadow before pre_swap.)"""
    d, queries = data
    _, tm = mutable_pair(str(tmp_path / "m"), d, n=900)
    tm.enable_wal(str(tmp_path / "m"), TWalConfig(sync_every=1))
    eng = tengine.RetrievalEngine(tm, TSP)
    eng.insert(d[900:1000])
    want = eng.search(queries)
    tfaults.install_plan({point: (1, "raise")})
    with pytest.raises(tfaults.FaultInjected):
        eng.maintain_once(force=True)
    tfaults.reset()
    assert eng.index is tm and eng.epoch == 0 and eng._write_log is None
    assert tm.wal is not None
    got = eng.search(queries)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    eng.insert(d[1000:1010])
    assert eng._write_log is None
    assert eng.maintain_once(force=True) and eng.epoch == 1
    assert eng.index.wal is not None and eng.index.n_live == tm.n_live


def test_post_swap_fault_leaves_a_complete_swap(data, tmp_path):
    d, queries = data
    _, tm = mutable_pair(str(tmp_path / "m"), d, n=900)
    eng = tengine.RetrievalEngine(tm, TSP)
    tfaults.install_plan({"engine.maint.post_swap": (1, "raise")})
    with pytest.raises(tfaults.FaultInjected):
        eng.maintain_once(force=True)
    tfaults.reset()
    assert eng.epoch == 1 and eng.index.n_segments == 1
    assert eng.index.n_live == tm.n_live and eng._write_log is None
    got = eng.search(queries)
    want = eng.index.search(queries, TSP)
    assert all(np.array_equal(a, host(b)) for a, b in zip(got, want))


# -- admission, deadlines, degraded mode (both packages) ---------------------------


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_queue_full_and_deadline_paths(pkg, statics, data):
    _, queries = data
    mod, sp, _, _ = PKG[pkg]
    idx = statics[0 if pkg == "jax" else 1]
    eng = mod.RetrievalEngine(idx, sp, max_queue=2)
    eng.submit(queries[:1])
    eng.submit(queries[:1])
    with pytest.raises(mod.QueueFull):
        eng.submit(queries[:1], block=False)
    with pytest.raises(mod.QueueFull):
        eng.submit(queries[:1], timeout=0.02)
    assert eng.metrics.counter("rejected") == 2
    assert eng.step() > 0
    while eng.step():
        pass
    late = eng.submit(queries[:4], deadline_ms=1.0)
    time.sleep(0.02)
    assert eng.step() == 0  # expired: shed before dispatch
    with pytest.raises(mod.DeadlineExceeded):
        late.result(timeout=0)
    assert eng.metrics.snapshot()["counters"]["deadline_expired"] == 1
    ok = eng.submit(queries[:4])
    assert eng.step() == 1 and ok.result(0)[0].shape == (4, sp.k)
    eng.stop(drain=False)
    with pytest.raises(mod.EngineClosed):
        eng.submit(queries[:1])


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_enters_degraded_on_wal_failure(pkg, data, tmp_path):
    d, queries = data
    mod, sp, faults, wal_config = PKG[pkg]
    _, tm = mutable_pair(str(tmp_path / "m"), d, n=300, deletes=False)
    idx = (tm if pkg == "torch"
           else __import__("repro.index", fromlist=["x"]).MutableHilbertIndex.load(
               str(tmp_path / "m")))
    idx.enable_wal(str(tmp_path / f"ckpt_{pkg}"), wal_config(sync_every=1))
    eng = mod.RetrievalEngine(idx, sp, maintenance=None)
    faults.install_plan({"wal.append.pre_write": (1, "raise")})
    with pytest.raises(mod.EngineDegraded):
        eng.insert(d[300:304])
    faults.reset()
    assert eng.degraded and "fault injected" in eng.degraded_reason
    with pytest.raises(mod.EngineDegraded):  # fail-fast, no index touch
        eng.delete(np.asarray([0], np.int32))
    assert eng.search(queries[:2])[0].shape == (2, sp.k)  # reads serve
    eng.reset_degraded()
    eng.insert(d[300:304])
    c = eng.metrics.snapshot()["counters"]
    assert c["degraded_entered"] == 1 and c["writes_rejected_degraded"] == 1
    assert eng.maintenance_stats()["n_live"] == 304


def test_static_layout_serves_read_only(statics):
    eng = tengine.RetrievalEngine(statics[1], TSP)
    assert eng.maintain_once(force=True) is False
    assert eng.maintenance_stats() == {}
    with pytest.raises(TypeError, match="immutable"):
        eng.insert(np.zeros((1, D), np.float32))


def test_maintenance_policy_triggers():
    pol = tengine.MaintenancePolicy(max_segments=4, max_tombstone_ratio=0.25)
    jpol = jengine.MaintenancePolicy(max_segments=4, max_tombstone_ratio=0.25)
    base = {"n_live": 100, "mergeable_segments": 2}
    for stats in ({**base, "n_segments": 4, "tombstone_ratio": 0.1},
                  {**base, "n_segments": 5, "tombstone_ratio": 0.1},
                  {**base, "n_segments": 2, "tombstone_ratio": 0.3},
                  {**base, "n_segments": 1, "rewrite_pressure": 1},
                  {"n_live": 0, "n_segments": 9, "mergeable_segments": 9},
                  {"n_live": 100, "n_segments": 9, "mergeable_segments": 0}):
        assert pol.triggered(stats) == jpol.triggered(stats)


def test_edf_order_is_visible_in_step_mode(data, tmp_path):
    d, queries = data
    _, tm = mutable_pair(str(tmp_path / "m"), d, n=600, deletes=False)
    eng = tengine.RetrievalEngine(tm, TSP, maintenance=None, max_batch=8)
    bulk = eng.submit(queries[:8], deadline_ms=60_000.0)
    urgent = eng.submit(queries[8:16], deadline_ms=500.0)
    assert eng.step() > 0 and urgent.done and not bulk.done
    assert eng.step() > 0 and bulk.done


# -- threads ------------------------------------------------------------------------


def test_threaded_drain_close_and_context_manager(statics, data, deadlock_watchdog):
    deadlock_watchdog(120.0)
    tidx = statics[1]
    _, queries = data
    eng = tengine.RetrievalEngine(tidx, TSP, max_batch=8, start=True)
    tickets = [eng.submit(queries[i : i + 3]) for i in range(0, 45, 3)]
    eng.stop(drain=True)
    assert not eng.running
    got = np.concatenate([t.result(0)[0] for t in tickets])
    np.testing.assert_array_equal(got, host(tidx.search(queries[:45], TSP)[0]))
    with tengine.RetrievalEngine(tidx, TSP, start=True) as eng2:
        t = eng2.submit(queries[:4])
    np.testing.assert_array_equal(t.result(0)[0],
                                  host(tidx.search(queries[:4], TSP)[0]))


def test_concurrent_maintenance_cycles_serialize_and_lose_no_writes(
        data, tmp_path, deadlock_watchdog):
    deadlock_watchdog(180.0)
    d, _ = data
    _, tm = mutable_pair(str(tmp_path / "m"), d, n=1000, deletes=False)
    eng = tengine.RetrievalEngine(tm, TSP)
    overlap, inside = [], threading.Semaphore(1)
    orig = eng._maintain_cycle

    def tracked(force):
        if not inside.acquire(blocking=False):
            overlap.append(True)
        try:
            return orig(force)
        finally:
            inside.release()

    eng._maintain_cycle = tracked
    stop, inserted = threading.Event(), []

    def writer():
        s = 1000
        while not stop.is_set() and s < 2000:
            inserted.append(eng.insert(d[s : s + 25]))
            s += 25

    wth = threading.Thread(target=writer)
    cycles = [threading.Thread(target=eng.maintain_once, kwargs={"force": True})
              for _ in range(2)]
    wth.start()
    for th in cycles:
        th.start()
    for th in cycles:
        th.join(120)
    stop.set()
    wth.join(60)
    assert not any(t.is_alive() for t in cycles + [wth])
    assert not overlap and eng._write_log is None
    ids = np.concatenate(inserted)
    np.testing.assert_array_equal(ids, np.arange(1000, 1000 + ids.size))
    assert eng.maintenance_stats()["n_live"] == 1000 + ids.size


def test_stress_readers_writer_and_epoch_swaps(data, tmp_path, deadlock_watchdog):
    """Barrier-started readers + a paced writer + three forced swaps, with
    two serve threads: every admitted ticket completes, and every probe
    ticket equals a direct search on the epoch that served it."""
    deadlock_watchdog(300.0)
    d, queries = data
    _, tm = mutable_pair(str(tmp_path / "m"), d, n=1000, deletes=False)
    extra = np.random.default_rng(42).normal(size=(900, D)).astype(np.float32)
    eng = tengine.RetrievalEngine(tm, TSP, maintenance=None, serve_threads=2,
                                  max_batch=16, start=True)
    stop, errors = threading.Event(), []
    counts = [0] * 3
    barrier = threading.Barrier(len(counts) + 1)

    def reader(i):
        r = np.random.default_rng(i)
        try:
            barrier.wait(timeout=30)
            while not stop.is_set():
                a = int(r.integers(0, Q - 8))
                ids, dists = eng.submit(queries[a : a + 8]).result(timeout=120)
                assert ids.shape == (8, TSP.k) and dists.shape == (8, TSP.k)
                counts[i] += 1
                time.sleep(0.002)
        except BaseException as e:
            errors.append(e)
            stop.set()

    threads = [threading.Thread(target=reader, args=(i,), daemon=True)
               for i in range(len(counts))]
    for t in threads:
        t.start()
    barrier.wait(timeout=30)
    probes, off = [], 0
    try:
        for _ in range(3):
            for _ in range(2):
                new_ids = eng.insert(extra[off : off + 150])
                off += 150
                eng.delete(new_ids[::5])
            epoch_index, epoch = eng.index, eng.epoch
            for a in range(0, 40, 8):
                t = eng.submit(queries[a : a + 8])
                t.result(timeout=120)
                probes.append((t, epoch, epoch_index))
            assert eng.maintain_once(force=True) and eng.epoch == epoch + 1
    finally:
        stop.set()
        for t in threads:
            t.join(60)
        eng.stop()
    assert not errors, errors[:1]
    assert not any(t.is_alive() for t in threads)
    assert all(c > 0 for c in counts)
    m = eng.metrics
    assert m.counter("completed") == m.counter("admitted")
    assert m.counter("swaps") == 3 and eng._write_log is None
    for t, epoch, epoch_index in probes:
        assert t.epoch == epoch
        want_i, want_d = epoch_index.search(t.queries, TSP, allow_rewrite=False)
        np.testing.assert_array_equal(t.ids, host(want_i))
        np.testing.assert_array_equal(t.dists, host(want_d))
    assert eng._serve_lock.stats()["read_acquisitions"] > 0


def test_threaded_swap_under_load_is_epoch_consistent(data, tmp_path,
                                                      deadlock_watchdog):
    deadlock_watchdog(240.0)
    d, queries = data
    _, tm = mutable_pair(str(tmp_path / "m"), d, n=1500)
    tm.insert(d[1500:])
    eng = tengine.RetrievalEngine(tm, TSP, maintenance=None, serve_threads=2,
                                  start=True)
    old = eng.index
    tickets, lock, stop = [], threading.Lock(), threading.Event()

    def submitter():
        i = 0
        while not stop.is_set():
            t = eng.submit(queries[i % 40 : i % 40 + 4])
            with lock:
                tickets.append((i % 40, t))
            i += 4
            time.sleep(0.02)  # paced: the check replays every ticket

    threads = [threading.Thread(target=submitter) for _ in range(2)]
    for th in threads:
        th.start()
    try:
        assert eng.maintain_once(force=True)
        time.sleep(0.2)
    finally:
        stop.set()
        for th in threads:
            th.join(60)
        eng.stop(drain=True)
    new = eng.index
    assert new is not old
    want = {}  # one direct search per (epoch, query slice)
    for a, t in tickets:
        ids, dists = t.result(5)
        if (t.epoch, a) not in want:
            want[t.epoch, a] = [host(x) for x in (old if t.epoch == 0 else new)
                                .search(t.queries, TSP, allow_rewrite=False)]
        np.testing.assert_array_equal(ids, want[t.epoch, a][0])
        np.testing.assert_array_equal(dists, want[t.epoch, a][1])
    assert {0, 1} <= {e for e, _ in want}


def test_idle_maintenance_poll_takes_only_the_shared_side(data, tmp_path):
    """A poll that finds nothing to do leaves the exclusive side alone in
    the port; ``repro``'s takes it on every poll, stalling new searches
    behind in-flight ones each time."""
    d, _ = data
    jm, tm = mutable_pair(str(tmp_path / "m"), d, n=600, deletes=False)
    writes = {}
    for name, idx in (("jax", jm), ("torch", tm)):
        mod, sp, _, _ = PKG[name]
        eng = mod.RetrievalEngine(idx, sp)
        before = eng._serve_lock.stats()["write_acquisitions"]
        assert eng.maintain_once() is False  # nothing triggered
        writes[name] = eng._serve_lock.stats()["write_acquisitions"] - before
        assert eng.maintain_once(force=True) and eng.epoch == 1
    assert writes == {"jax": 1, "torch": 0}


def test_serve_thread_waiting_to_launch_holds_no_read_side(data, tmp_path,
                                                           deadlock_watchdog):
    """A serve thread that waits for its turn to launch holds nothing: a
    write goes through while it waits, instead of queueing behind every
    serve thread's search."""
    deadlock_watchdog(120.0)
    d, queries = data
    _, tm = mutable_pair(str(tmp_path / "m"), d, n=600, deletes=False)
    eng = tengine.RetrievalEngine(tm, TSP, maintenance=None, start=True)
    try:
        with eng._launch_lock:  # another batch's search is launching
            ticket = eng.submit(queries[:4])
            while ticket.batched_at is None:
                time.sleep(0.01)
            time.sleep(0.2)  # the serve thread now waits on the launch lock
            writer = threading.Thread(target=eng.insert, args=(d[600:650],))
            writer.start()
            writer.join(30.0)
            assert not writer.is_alive(), "a write waited for a queued search"
        ids, _ = ticket.result(30.0)
        assert ids.shape == (4, TSP.k)
        assert tm.n_live == 650
    finally:
        eng.stop(drain=False)


def test_warm_search_leaves_the_shadow_unrewritten(data, tmp_path):
    """Deletes replayed onto the compacted shadow push its segment past
    the stage-2 pool.  ``repro``'s warm search then rewrites that segment
    on the shadow (with ``seal_pow2``, into pow2 padding, whose repeated
    rows crowd the candidate pools); the port's warm search, like a
    served one, does not rewrite, so the swapped-in index keeps its
    tombstones and ``rewrite_pressure`` calls the next cycle.  A second
    cycle leaves both packages bit-equal again."""
    d, queries = data
    jm, tm = mutable_pair(str(tmp_path / "m"), d, n=1200, deletes=False)
    engines = {}
    for name, idx in (("jax", jm), ("torch", tm)):
        mod, sp, _, _ = PKG[name]
        eng = mod.RetrievalEngine(idx, sp, maintenance=None)
        eng.submit(queries[:8])
        assert eng.step() == 1  # one batch shape for the warm pass
        snapshot = eng.index.snapshot

        def snap(eng=eng, snapshot=snapshot):
            shadow = snapshot()
            inner = shadow.compact

            def compact():
                inner()
                eng.delete(np.arange(0, 1200, 4))  # 300 dead: past the 192 pool
            shadow.compact = compact
            return shadow

        eng.index.snapshot = snap
        assert eng.maintain_once(force=True)
        engines[name] = eng
    jeng, teng = engines["jax"], engines["torch"]
    assert jeng.index.rewrite_pressure(JSP) == 0  # rewritten by the warm search
    assert teng.index.rewrite_pressure(TSP) == 1  # left for the next cycle
    np.testing.assert_array_equal(jeng.index._alive, teng.index._alive)
    np.testing.assert_array_equal(host(teng.search(queries)[0]),
                                  host(teng.index.search(queries, TSP,
                                                         allow_rewrite=False)[0]))
    for eng in (jeng, teng):
        assert eng.maintain_once(force=True)

    def built_alike(st):  # segment generations count builds: repro ran one more
        st = dict(st, segments=[seg[1:] for seg in st["segments"]])
        del st["gen"]
        return st

    assert jeng.index._gen == teng.index._gen + 1
    _assert_same(built_alike(_state(jeng.index)), built_alike(_state(teng.index)))
    assert_within_contract(*jeng.search(queries), *teng.search(queries))


# -- the engine over the static sharded layout (4 logical shards) -----------------


@pytest.mark.parametrize("merge", ["tree", "gather"])
def test_static_sharded_step_mode_batches_equal_a_direct_search(data, merge):
    """``repro``'s ``scripts/serving_check.py`` section [1] on the port:
    ragged submissions over a ``ShardedHilbertIndex`` of 4 logical shards,
    micro-batched and split back, equal a direct search bit for bit; the
    index serves read-only."""
    import dataclasses

    from repro_torch.index import ShardedHilbertIndex
    from _torch_parity import TCFG

    d, queries = data
    idx = ShardedHilbertIndex.build(d, dataclasses.replace(TCFG, shards=4, merge=merge),
                                    n_shards=4, device="cpu")
    direct_i, direct_d = idx.search(queries, TSP)
    eng = tengine.RetrievalEngine(idx, TSP, max_batch=16)
    cuts = [0, 5, 8, 20, 21, 37, Q]
    tickets = [eng.submit(queries[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]
    while eng.step():
        pass
    np.testing.assert_array_equal(np.concatenate([t.ids for t in tickets]), host(direct_i))
    np.testing.assert_array_equal(np.concatenate([t.dists for t in tickets]),
                                  host(direct_d))
    assert eng.metrics.counter("batches") < len(tickets)
    ids, dists = eng.search(queries[:7])
    np.testing.assert_array_equal(ids, host(direct_i[:7]))
    assert eng.maintain_once(force=True) is False
    with pytest.raises(TypeError, match="immutable"):
        eng.insert(d[:4])


# -- the engine over the sharded-mutable layout (4 logical shards) -----------------


def sharded_mutable(d, n=900, deletes=True):
    """A 4-shard streaming index: a 600-row base, inserted rows sealed into
    generations and still buffered, and (by default) every 7th id dead."""
    from repro_torch.index import ShardedMutableHilbertIndex
    from _torch_parity import TCFG

    idx = ShardedMutableHilbertIndex.build(d[:600], TCFG, n_shards=4, buffer_capacity=64,
                                           max_segments=4, device="cpu")
    for s in range(600, n, 100):
        idx.insert(d[s : min(s + 100, n)])
    if deletes:
        idx.delete(np.arange(0, n, 7))
    return idx


def test_sharded_mutable_step_mode_batches_equal_their_snapshots(data):
    """Ragged batches served between writes and a forced maintenance: every
    batch equals a search of the snapshot it was served on (the probe keeps
    all of them), and each epoch's answers equal a direct search."""
    from repro_torch.obs.recall import RecallProbeConfig

    d, queries = data
    idx = sharded_mutable(d)
    assert idx.n_buffered > 0 and idx.n_segments >= 2
    eng = tengine.RetrievalEngine(idx, TSP, max_batch=16,
                                  recall=RecallProbeConfig(fraction=1.0, max_pending=64))
    served = []
    for a, b, write in ((0, 5, None), (5, 20, d[900:950]), (20, 37, np.arange(1, 60, 3)),
                        (37, Q, None)):
        tickets = [eng.submit(queries[a:b])]
        while eng.step():
            pass
        served += tickets
        if write is not None and write.ndim == 2:
            eng.insert(write)
        elif write is not None:
            eng.delete(write)
    assert all(t.epoch == 0 for t in served)
    pending = list(eng.recall_probe._pending)
    assert len(pending) == eng.metrics.counter("batches") >= 4
    for q, ids, k, shadow in pending:
        got, _ = shadow.search(q, TSP, query_chunk=16, allow_rewrite=False)
        np.testing.assert_array_equal(ids, host(got))
    assert eng.maintain_once(force=True) and eng.epoch == 1
    assert eng.index.n_segments == 1 and eng.index.n_shards == 4
    got = eng.search(queries)
    want = eng.index.search(queries, TSP, query_chunk=16, allow_rewrite=False)
    assert all(np.array_equal(a, host(b)) for a, b in zip(got, want))
    assert eng.score_recall() > 0


@pytest.mark.parametrize("point", ["engine.maint.pre_compact",
                                   "engine.maint.post_compact",
                                   "engine.maint.pre_replay",
                                   "engine.maint.pre_swap"])
def test_sharded_mutable_maintenance_fault_aborts_cycle_invisibly(data, tmp_path, point):
    """The checks of ``test_maintenance_fault_aborts_cycle_invisibly`` on
    the sharded-mutable layout."""
    d, queries = data
    tm = sharded_mutable(d)
    tm.save(str(tmp_path / "m"))
    tm.enable_wal(str(tmp_path / "m"), TWalConfig(sync_every=1))
    eng = tengine.RetrievalEngine(tm, TSP)
    eng.insert(d[900:1000])
    want = eng.search(queries)
    tfaults.install_plan({point: (1, "raise")})
    with pytest.raises(tfaults.FaultInjected):
        eng.maintain_once(force=True)
    tfaults.reset()
    assert eng.index is tm and eng.epoch == 0 and eng._write_log is None
    assert tm.wal is not None
    got = eng.search(queries)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    eng.insert(d[1000:1010])
    assert eng._write_log is None
    assert eng.maintain_once(force=True) and eng.epoch == 1
    assert eng.index.wal is not None and eng.index.n_live == tm.n_live
    eng.index.detach_wal().close()


def test_sharded_mutable_serve_thread_waiting_to_launch_holds_no_read_side(
        data, deadlock_watchdog):
    """The check of ``test_serve_thread_waiting_to_launch_holds_no_read_side``
    on the sharded-mutable layout."""
    deadlock_watchdog(120.0)
    d, queries = data
    tm = sharded_mutable(d, n=600, deletes=False)
    eng = tengine.RetrievalEngine(tm, TSP, maintenance=None, start=True)
    try:
        with eng._launch_lock:  # another batch's search is launching
            ticket = eng.submit(queries[:4])
            while ticket.batched_at is None:
                time.sleep(0.01)
            time.sleep(0.2)  # the serve thread now waits on the launch lock
            writer = threading.Thread(target=eng.insert, args=(d[600:650],))
            writer.start()
            writer.join(30.0)
            assert not writer.is_alive(), "a write waited for a queued search"
        ids, _ = ticket.result(30.0)
        assert ids.shape == (4, TSP.k)
        assert tm.n_live == 650
    finally:
        eng.stop(drain=False)


def test_sharded_mutable_warm_search_leaves_the_shadow_unrewritten(data):
    """The check of ``test_warm_search_leaves_the_shadow_unrewritten`` on
    the sharded-mutable layout: deletes replayed onto the compacted shadow
    push its generation past the stage-2 pool, the warm pass does not
    rewrite it, and ``rewrite_pressure`` calls the next cycle."""
    from _jax_sharded_mutable_4dev import state_arrays

    d, queries = data
    tm = sharded_mutable(d, n=1200, deletes=False)
    eng = tengine.RetrievalEngine(tm, TSP, maintenance=None)
    eng.submit(queries[:8])
    assert eng.step() == 1  # one batch shape for the warm pass
    snapshot = eng.index.snapshot

    def snap():
        shadow = snapshot()
        inner = shadow.compact

        def compact():
            inner()
            # 900 of 1200 dead: ~225 a shard, past the 192 - 10 pool
            eng.delete(np.setdiff1d(np.arange(1200), np.arange(0, 1200, 4)))
        shadow.compact = compact
        return shadow

    eng.index.snapshot = snap
    assert eng.maintain_once(force=True)
    swapped = eng.index
    assert swapped.rewrite_pressure(TSP) == 1 and swapped.n_segments == 1
    gen = swapped._gen
    got = eng.search(queries)
    want = swapped.search(queries, TSP, query_chunk=16, allow_rewrite=False)
    assert all(np.array_equal(a, host(b)) for a, b in zip(got, want))
    assert swapped._gen == gen  # served searches rewrote nothing
    assert eng.maintain_once(force=True)
    assert eng.index.rewrite_pressure(TSP) == 0
    fresh = sharded_mutable(d, n=1200, deletes=False)
    fresh.delete(np.setdiff1d(np.arange(1200), np.arange(0, 1200, 4)))
    fresh.compact()
    want_state, got_state = state_arrays(fresh), state_arrays(eng.index)
    for key in [k for k in want_state if k.endswith("gen") or k == "buf_pts"]:
        del want_state[key], got_state[key]  # generations count builds; stale rows
    assert sorted(want_state) == sorted(got_state)
    for key in want_state:
        np.testing.assert_array_equal(want_state[key], got_state[key], err_msg=key)
