"""Port parity: the serve primitives of ``repro_torch.serve``.

* ``form_batch`` picks the same batch and sheds the same tickets as
  ``repro``'s over seeded ticket sequences;
* ``ReadWriteLock`` (both packages) shares reads, excludes and prefers
  writers, re-enters writes and refuses upgrades;
* ``pipelined_search`` is bit-identical to ``index.search`` (several
  chunks, a ragged last chunk, an empty batch);
* ``snapshot()`` keeps searching bit-equal while every write path runs on
  the original: no write path writes into a shared segment tensor;
* the out-of-process compactor (the port's child, on the CPU here): a
  fault at any of its points fails the cycle, and serving never sees it.
"""

import itertools
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from repro.serve import batching as jbatching
from repro.serve.rwlock import ReadWriteLock as JLock
from repro_torch.checkpoint.wal import WalConfig
from repro_torch.index import MutableHilbertIndex, SearchParams
from repro_torch.serve import (CompactionChildError, EngineMetrics, RetrievalEngine,
                               pipelined_search)
from repro_torch.serve import batching as tbatching
from repro_torch.serve.rwlock import ReadWriteLock as TLock
from _torch_parity import TCFG, TSP, dataset, host, mutable_pair, static_pair

LOCKS = {"jax": JLock, "torch": TLock}


@pytest.fixture(scope="module")
def data():
    return dataset()


# -- EDF batching ---------------------------------------------------------------


class _Q:
    def __init__(self, rows):
        self.shape = (rows, 4)


class Ticket:
    _seq = itertools.count()

    def __init__(self, rows, params, deadline, submitted_mono):
        self.queries = _Q(rows)
        self.params = params
        self.deadline = deadline
        self.submitted_mono = submitted_mono
        self.seq = next(self._seq)


def _tickets(rng, n):
    out = []
    for _ in range(n):
        deadline = (None if rng.random() < 0.3
                    else float(rng.uniform(-50.0, 150.0)))
        if rng.random() < 0.1 and out:  # deadline ties break by seq
            deadline = out[-1].deadline
        out.append(Ticket(int(rng.integers(1, 9)), str(rng.choice(["a", "b"])),
                          deadline, float(rng.uniform(0.0, 100.0))))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_form_batch_selects_and_sheds_like_repro(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        pending = _tickets(rng, int(rng.integers(0, 25)))
        max_rows = int(rng.integers(1, 17))
        now = float(rng.uniform(0.0, 120.0))
        horizon = float(rng.choice([1.0, 60.0]))
        kw = dict(max_rows=max_rows, now=now, no_deadline_horizon=horizon)
        j, t = jbatching.form_batch(pending, **kw), tbatching.form_batch(pending, **kw)
        assert [x.seq for x in t.batch] == [x.seq for x in j.batch]
        assert [x.seq for x in t.expired] == [x.seq for x in j.expired]
        assert t.rows == j.rows
        for x in pending:
            assert (tbatching.effective_deadline(x, horizon)
                    == jbatching.effective_deadline(x, horizon))


def test_form_batch_validates_max_rows():
    with pytest.raises(ValueError):
        tbatching.form_batch([], max_rows=0, now=0.0)


# -- ReadWriteLock ----------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_rwlock_readers_share_and_writer_excludes(pkg):
    lock = LOCKS[pkg]()
    inside = threading.Barrier(3)

    def reader():
        with lock.read_locked():
            inside.wait(timeout=10)  # all 3 hold the read side at once

    threads = [threading.Thread(target=reader) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads) and lock.readers == 0

    observed, entered, release = [], threading.Event(), threading.Event()

    def writer():
        with lock.write_locked():
            entered.set()
            release.wait(10)
            observed.append("write-exit")

    def late():
        entered.wait(10)
        with lock.read_locked():
            observed.append("read")

    tw, tr = threading.Thread(target=writer), threading.Thread(target=late)
    tw.start()
    tr.start()
    entered.wait(10)
    time.sleep(0.05)
    assert observed == []
    release.set()
    tw.join(10)
    tr.join(10)
    assert observed == ["write-exit", "read"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_rwlock_writer_preference_gates_new_readers(pkg, deadlock_watchdog):
    deadlock_watchdog(60.0)
    lock = LOCKS[pkg]()
    r1_in, r1_go = threading.Event(), threading.Event()
    order = []

    def long_reader():
        with lock.read_locked():
            r1_in.set()
            r1_go.wait(10)
            with lock.read_locked():  # re-entrant: bypasses the writer gate
                order.append("reentrant-read")

    def writer():
        with lock.write_locked():
            order.append("write")

    def late_reader():
        with lock.read_locked():
            order.append("late-read")

    t1 = threading.Thread(target=long_reader)
    t1.start()
    r1_in.wait(10)
    tw = threading.Thread(target=writer)
    tw.start()
    while lock.stats()["pending_writers"] == 0:
        time.sleep(0.001)
    t3 = threading.Thread(target=late_reader)
    t3.start()
    time.sleep(0.05)
    assert "late-read" not in order
    r1_go.set()
    for t in (t1, tw, t3):
        t.join(10)
    assert not any(t.is_alive() for t in (t1, tw, t3))
    assert order.index("write") < order.index("late-read")
    assert "reentrant-read" in order


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_rwlock_reentrancy_upgrade_and_stats(pkg):
    lock = LOCKS[pkg]()
    with lock.write_locked():
        with lock.write_locked():
            with lock.read_locked():
                assert lock.write_held()
        time.sleep(0.01)
    assert not lock.write_held() and lock.readers == 0
    with lock.read_locked():
        with pytest.raises(RuntimeError, match="upgrade"):
            lock.acquire_write()
    s = lock.stats()
    assert s["read_acquisitions"] >= 1 and s["write_acquisitions"] >= 1
    assert s["write_held_ms"] >= 5.0


# -- pipelined search -----------------------------------------------------------


@pytest.mark.parametrize("layout", ["static", "mutable"])
@pytest.mark.parametrize("rows", [48, 45, 0, 16])
def test_pipelined_search_is_bit_identical(data, tmp_path_factory, layout, rows):
    """3 chunks, a ragged last chunk (16+16+13), an empty batch, one chunk."""
    d, queries = data
    path = str(tmp_path_factory.mktemp(layout))
    _, idx = (static_pair(path, d) if layout == "static"
              else mutable_pair(path, d, n=700))
    q = queries[:rows]
    want_i, want_d = idx.search(q, TSP, query_chunk=16)
    got_i, got_d = pipelined_search(idx, q, TSP, query_chunk=16)
    assert got_i.shape == (rows, TSP.k) and got_i.dtype == torch.int32
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)
    got_i, got_d = pipelined_search(idx, torch.from_numpy(q), TSP, query_chunk=16)
    assert torch.equal(got_i, want_i) and torch.equal(got_d, want_d)


def test_engine_metrics_mirror_into_registry():
    from repro_torch.obs import MetricsRegistry

    reg = MetricsRegistry()
    m = EngineMetrics(registry=reg)
    m.bump("admitted", 3)
    m.latency.record(4.0)
    m.queue_wait.record(1.0)
    assert m.counter("admitted") == 3
    snap = reg.snapshot()
    assert snap["engine_admitted_total"] == 3
    assert snap["engine_request_ms"]["count"] == 1.0
    m2 = EngineMetrics(registry=reg)
    m2.bump("admitted")
    assert m2.counter("admitted") == 1
    assert reg.snapshot()["engine_admitted_total"] == 4


# -- snapshot isolation -------------------------------------------------------------


def test_snapshot_searches_unchanged_while_every_write_path_runs(data, tmp_path):
    """The snapshot shares segment tensors with the original (torch
    tensors are mutable, JAX arrays were not): after inserts, seals, tier
    merges, deletes, a read-triggered rewrite, bulk_load, flush, WAL
    appends and compaction on the original, the snapshot's search and the
    shared tensors are bit-equal to before."""
    d, queries = data
    mut = MutableHilbertIndex(TCFG, buffer_capacity=128, max_segments=3,
                              device="cpu")
    mut.insert(d[:700])
    mut.delete(np.arange(0, 700, 9))
    snap = mut.snapshot()
    shared = [t.clone() for seg in snap.segments
              for t in seg.index._tensors().values()]
    want = snap.search(queries, TSP)
    mut.enable_wal(str(tmp_path / "wal"), WalConfig(sync_every=1))
    mut.insert(d[700:1100])                 # buffer, seals, tier merges
    mut.delete(np.arange(1, 1100, 2))       # half of everything
    mut.search(queries, SearchParams(k1=16, k2=8, h=1, k=10))  # rewrites
    mut.bulk_load(d[1100:1300])
    mut.insert(d[1300:1350])
    mut.flush()
    mut.compact()
    got = snap.search(queries, TSP)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    now = [t for seg in snap.segments for t in seg.index._tensors().values()]
    assert all(torch.equal(a, b) for a, b in zip(shared, now))
    mut.detach_wal().close()


# -- out-of-process compaction ----------------------------------------------------


def _engine_with_writes(data, tmp_path, mode="subprocess"):
    d, queries = data
    _, tm = mutable_pair(str(tmp_path / "m"), d, n=900)
    eng = RetrievalEngine(tm, TSP, compaction=mode,
                          compaction_dir=str(tmp_path / "work"))
    eng.insert(d[900:1000])
    eng.delete(np.arange(5, 50, 3))
    return eng


@pytest.mark.parametrize("point", ["compactor.child.loaded",
                                   "compactor.child.compacted",
                                   "compactor.child.pre_marker",
                                   "compactor.child.post_marker"])
def test_compactor_child_fault_fails_the_cycle_invisibly(data, tmp_path,
                                                         monkeypatch, point):
    """A child killed at any of its points fails the cycle with
    CompactionChildError; the serving index, its epoch, its writes and
    its answers are untouched, and a later cycle succeeds."""
    d, queries = data
    eng = _engine_with_writes(data, tmp_path)
    before = eng.index
    want = eng.search(queries)
    stats = eng.maintenance_stats()
    monkeypatch.setenv("REPRO_COMPACTOR_FAULTS", f"{point}=kill")
    with pytest.raises(CompactionChildError):
        eng.maintain_once(force=True)
    assert eng.index is before and eng.epoch == 0
    assert eng._write_log is None
    assert eng.maintenance_stats() == stats
    got = eng.search(queries)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    monkeypatch.delenv("REPRO_COMPACTOR_FAULTS")
    eng.insert(d[1000:1010])
    assert eng.maintain_once(force=True) and eng.epoch == 1
    assert eng.index.n_segments == 1 and eng.index.n_live == stats["n_live"] + 10


def test_compactor_child_of_a_cuda_index_never_compacts_on_the_cpu(tmp_path):
    """The child is told the index's device; asked for cuda on a host
    without a GPU it refuses, and the parent raises."""
    import subprocess
    import sys

    from repro_torch.serve import compactor

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the refusal needs one without")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve.compactor", str(tmp_path / "in"),
         str(tmp_path / "out"), "--device", "cuda"],
        env=compactor._child_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 3 and "no GPU" in out.stderr
    assert not os.path.exists(tmp_path / "out")


# -- the sharded-mutable layout (4 logical shards) ---------------------------------


def _sharded_mutable(d, n=900):
    from repro_torch.index import ShardedMutableHilbertIndex

    idx = ShardedMutableHilbertIndex.build(d[:600], TCFG, n_shards=4, buffer_capacity=64,
                                           max_segments=4, device="cpu")
    for s in range(600, n, 100):
        idx.insert(d[s : s + 100])
    idx.delete(np.arange(0, n, 7))
    return idx


def test_sharded_mutable_compaction_thread_and_child_bit_equal_to_fresh_build(data,
                                                                               tmp_path):
    """``maintain_once(force=True)`` with the shadow compacted in a thread
    and in the child (``python -m repro_torch.serve.compactor IN OUT
    --device cpu`` on a format-4 bundle): the two swapped-in indexes are
    bit-equal to each other, and search bit-equal to a fresh sharded build
    over the live rows."""
    from repro_torch.index import ShardedHilbertIndex
    from _jax_sharded_mutable_4dev import state_arrays

    d, queries = data
    out = {}
    for mode in ("thread", "subprocess"):
        eng = RetrievalEngine(_sharded_mutable(d), TSP, compaction=mode,
                              compaction_dir=str(tmp_path / mode))
        eng.insert(d[900:1000])
        eng.delete(np.arange(5, 950, 3))
        assert eng.maintain_once(force=True) and eng.epoch == 1
        assert eng.last_swap_timeline["compaction"] == mode
        out[mode] = eng
    with open(tmp_path / "subprocess" / "out" / "compact_result.json") as f:
        assert json.load(f)["layout"] == "sharded_mutable"
    a, b = (state_arrays(out[m].index) for m in ("thread", "subprocess"))
    a["buf_pts"] = b["buf_pts"]  # the thread's index keeps stale buffer rows
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    idx = out["thread"].index
    assert idx.n_segments == 1 and idx.n_shards == 4 and idx.n_buffered == 0
    live = np.flatnonzero(idx._lsm.alive)
    fresh = ShardedHilbertIndex.build(d[live], TCFG, n_shards=4, device="cpu")
    fi, fd = fresh.search(queries, TSP)
    fi = torch.where(fi >= 0, torch.from_numpy(live.astype(np.int32))[fi.long()], -1)
    for eng in out.values():
        got = eng.index.search(queries, TSP)
        assert torch.equal(got[0], fi) and torch.equal(got[1], fd)


@pytest.mark.parametrize("rows", [48, 45, 0, 16])
def test_pipelined_search_is_bit_identical_on_sharded_mutable(data, rows):
    d, queries = data
    idx = _sharded_mutable(d)
    q = queries[:rows]
    ids, d2 = pipelined_search(idx, q, TSP, query_chunk=16, allow_rewrite=False)
    want = idx.search(q, TSP, query_chunk=16, allow_rewrite=False)
    assert torch.equal(ids, want[0]) and torch.equal(d2, want[1])


def test_sharded_mutable_snapshot_unchanged_while_every_write_path_runs(data, tmp_path):
    """The sharded-mutable snapshot shares its generations' stacked tensors
    with the original: every write path on the original leaves them and
    the snapshot's search bit-equal to before."""
    d, queries = data
    idx = _sharded_mutable(d, n=700)
    snap = idx.snapshot()
    shared = [t.clone() for seg in snap.segments for t in list(seg.stack) + [seg.points]]
    want = snap.search(queries, TSP)
    idx.enable_wal(str(tmp_path / "wal"), WalConfig(sync_every=1))
    idx.insert(d[700:1100])                 # buffers, seals, tier merges
    idx.delete(np.arange(1, 1100, 2))       # half of everything
    idx.search(queries, SearchParams(k1=16, k2=8, h=1, k=10))  # rewrites
    idx.bulk_load(d[1100:1300])
    idx.insert(d[1300:1350])
    idx.flush()
    idx.compact()
    got = snap.search(queries, TSP)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    now = [t for seg in snap.segments for t in list(seg.stack) + [seg.points]]
    assert all(torch.equal(a, b) for a, b in zip(shared, now))
    idx.detach_wal().close()
