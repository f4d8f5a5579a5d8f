"""Port parity: ``repro_torch.obs`` against ``repro.obs``.

The same operations give the same Prometheus and JSON exposition, the
same spans, and the same per-site dispatch counts in both packages (times
are compared by sample count only).  The recall probe samples the same
batches from the same seed and scores them the same; the port's exact
top-k runs in float64 where the points live, in column chunks, and equals
``repro``'s dense host scorer up to runs of distances tied within 1e-9
relative.
"""

import json
import threading
import urllib.error
import urllib.request
from collections import Counter

import numpy as np
import pytest

import repro.obs as jobs
from repro.obs import recall as jrecall
from repro.serve import RetrievalEngine as JEngine
import repro_torch.obs as tobs
from repro_torch.obs import dispatch as tdispatch
from repro_torch.obs import recall as trecall
from repro_torch.serve import RetrievalEngine as TEngine
from _torch_parity import (JSP, TSP, Q, D, dataset, host, mutable_pair,
                           static_pair)

PKGS = {"jax": jobs, "torch": tobs}


@pytest.fixture(scope="module")
def data():
    return dataset()


@pytest.fixture(scope="module")
def statics(data, tmp_path_factory):
    return static_pair(str(tmp_path_factory.mktemp("static")), data[0])


def _registry_ops(reg):
    reg.counter("reqs_total", site="s").inc(3)
    reg.counter("reqs_total", site="t").inc()
    reg.gauge("depth").set(2.5)
    reg.gauge("live", fn=lambda: 7.0)
    reg.gauge("dead", fn=lambda: 1 / 0)
    lat = reg.latency("lat_ms")
    for v in (4.0, 1.0, 3.0, 2.0, 9.5):
        lat.record(v)
    reg.latency("empty_ms")
    return reg


def test_registry_exposition_is_identical():
    j = _registry_ops(jobs.MetricsRegistry())
    t = _registry_ops(tobs.MetricsRegistry())
    assert t.prometheus_text() == j.prometheus_text()
    assert t.to_json() == j.to_json()


@pytest.mark.parametrize("p", [50.0, 99.0, 99.9, 99.99, 99.5, 0.5])
def test_percentile_labels_and_values_match(p):
    samples = np.random.default_rng(int(p * 100)).exponential(3.0, 1000)
    assert tobs.percentile_label(p) == jobs.percentile_label(p)
    assert (tobs.percentiles(samples, (p,))
            == jobs.percentiles(samples, (p,)))


def test_registry_type_guard_and_callback_replacement():
    reg = tobs.MetricsRegistry()
    c = reg.counter("x_total", site="a")
    assert reg.counter("x_total", site="a") is c
    with pytest.raises(TypeError):
        reg.gauge("x_total", site="a")
    g = reg.gauge("depth", fn=lambda: 7.0)
    reg.gauge("depth", fn=lambda: 9.0)
    assert g.value == 9.0


def test_registry_snapshot_consistent_under_concurrent_writers():
    reg = tobs.MetricsRegistry()
    n_threads, n_incs = 4, 500
    lat = reg.latency("lat_ms", capacity=n_threads * n_incs)
    start = threading.Barrier(n_threads + 1)

    def writer(i):
        c = reg.counter("hits_total", worker=str(i))
        start.wait()
        for j in range(n_incs):
            c.inc()
            reg.counter("all_total").inc()
            lat.record(float(j))

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    start.wait()
    for _ in range(50):
        assert 0 <= reg.snapshot().get("all_total", 0) <= n_threads * n_incs
        reg.prometheus_text()
    for t in threads:
        t.join(timeout=60)
    snap = reg.snapshot()
    assert snap["all_total"] == n_threads * n_incs
    assert snap["lat_ms"]["count"] == n_threads * n_incs


# -- spans ---------------------------------------------------------------------


def _span_ops(tr):
    with tr.span("outer", phase="a"):
        with tr.span("mid", rows=3):
            with tr.span("inner"):
                pass
        with tr.span("mid2"):
            pass
    with tr.span("root2", k=1):
        pass
    return tr


def _shape(tr):
    """Span names, attrs and parent names: the trace minus its clocks."""
    by_id = {s.span_id: s for s in tr.spans()}
    return [(s.name, dict(s.attrs),
             None if s.parent_id is None else by_id[s.parent_id].name)
            for s in tr.spans()]


def test_span_tree_and_chrome_trace_match():
    j = _span_ops(jobs.Tracer(enabled=True))
    t = _span_ops(tobs.Tracer(enabled=True))
    assert _shape(t) == _shape(j)
    jt, tt = j.chrome_trace(), t.chrome_trace()
    strip = lambda doc: [(e["name"], e["ph"], e["pid"],
                          {k: v for k, v in e["args"].items() if k != "parent"})
                         for e in doc["traceEvents"]]
    assert strip(tt) == strip(jt)
    json.loads(json.dumps(tt))
    ts = [e["ts"] for e in tt["traceEvents"]]
    assert ts == sorted(ts)


def test_noop_span_and_the_device_clock_off_the_card():
    """A disabled tracer hands out the shared no-op span and records
    nothing; an enabled one gives a span opened on the CPU, or on no
    device, no device clock."""
    off = tobs.Tracer(enabled=False)
    s = off.span("never", device="cpu", rows=3)
    assert s is off.span("other")
    with s as inner:
        assert inner.set(k=1) is inner and inner.device_ms is None
    assert off.spans() == [] and off.dropped == 0
    tr = tobs.Tracer(enabled=True)
    with tr.span("cpu", device="cpu") as a:
        assert a.device_ms is None
        with tr.span("plain"):
            pass
    assert [(s.name, s.device_ms) for s in tr.spans()] == [("plain", None), ("cpu", None)]
    assert a.attrs == {}  # ``device`` is not an attribute


# -- dispatch accounting ------------------------------------------------------


def _dispatch_delta(mod, fn):
    before = mod.accounting_snapshot()
    fn()
    return mod.accounting_delta(before, mod.accounting_snapshot())["dispatches_by_site"]


def test_dispatch_counts_match_repro(data, tmp_path):
    """Builds, static searches, LSM inserts (seals), deletes, mutable
    searches and a compaction: the same per-site dispatch counts."""
    from repro.index import HilbertIndex as JIndex
    from repro.index import MutableHilbertIndex as JMutable
    from repro_torch.index import HilbertIndex, MutableHilbertIndex
    from _torch_parity import JCFG, TCFG

    d, queries = data

    def run(index_cls, mut_cls, cfg, sp, **dev):
        def go():
            idx = index_cls.build(d[:512], cfg, **dev)
            idx.search(queries, sp)          # 3 chunks of 16
            idx.search(queries[:5], sp)      # one padded chunk
            m = mut_cls(cfg, buffer_capacity=256, max_segments=1, **dev)
            ids = m.insert(d[:600])          # 2 seals and a tier merge
            m.delete(ids[::3])
            m.search(queries[:16], sp)
            m.compact()
            m.search(queries[:7], sp)
        return go

    jd = _dispatch_delta(jobs, run(JIndex, JMutable, JCFG, JSP))
    td = _dispatch_delta(tobs, run(HilbertIndex, MutableHilbertIndex, TCFG, TSP,
                                   device="cpu"))
    assert td == jd
    assert {"hilbert.search", "lsm.segment_build", "lsm.buffer_search",
            "lsm.merge", "build.forest"} <= set(td)


def test_kernel_library_load_is_a_compile_event_of_the_calling_thread(monkeypatch):
    """A kernel library load counts once, in the dispatch scope of the
    thread that triggered it; a scope open on another thread sees none."""
    import ctypes.util

    from repro_torch.kernels import _build

    libc = ctypes.util.find_library("c") or "libc.so.6"
    monkeypatch.setattr(_build, "build", lambda names=(): {})
    monkeypatch.setattr(_build, "_target", lambda name: libc)
    loaded, entered = threading.Event(), threading.Event()

    def loader():
        entered.wait(10)
        with tdispatch.dispatch_scope("obs.test.loader"):
            _build.library("obs_test_fake")
        loaded.set()

    th = threading.Thread(target=loader)
    r0, c0 = tobs.recompile_counts(), tobs.compiles_total()
    try:
        th.start()
        with tdispatch.dispatch_scope("obs.test.bystander"):
            entered.set()
            assert loaded.wait(30)
        th.join(timeout=30)
    finally:
        _build.library.cache_clear()
    r1 = tobs.recompile_counts()
    assert tobs.compiles_total() - c0 == 1
    assert r1.get("obs.test.loader", 0) - r0.get("obs.test.loader", 0) == 1
    assert r1.get("obs.test.bystander", 0) == r0.get("obs.test.bystander", 0)
    assert tobs.default_registry().snapshot()["index_last_dispatch_recompiled"] in (0.0, 1.0)


# -- HTTP ---------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_metrics_http_endpoint_serves_all_three_views(pkg):
    mod = PKGS[pkg]
    reg = _registry_ops(mod.MetricsRegistry())
    tr = _span_ops(mod.Tracer(enabled=True))
    with mod.MetricsServer(port=0, registry=reg, tracer=tr) as srv:
        assert srv.port > 0
        text = urllib.request.urlopen(srv.url + "/metrics", timeout=10).read().decode()
        assert text == reg.prometheus_text()
        snap = json.loads(urllib.request.urlopen(srv.url + "/metrics.json",
                                                 timeout=10).read())
        assert snap["reqs_total{site=\"s\"}"] == 3
        doc = json.loads(urllib.request.urlopen(srv.url + "/trace", timeout=10).read())
        assert [e["name"] for e in doc["traceEvents"]] == [
            e["name"] for e in tr.chrome_trace()["traceEvents"]]
        assert urllib.request.urlopen(srv.url + "/healthz", timeout=10).status == 200
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(srv.url + "/nope", timeout=10)


# -- recall -------------------------------------------------------------------


def _assert_topk_ids_match(q, ids, pts, want, got, rel=1e-9):
    """ids equal, except inside runs of distances tied within ``rel``."""
    q, pts = np.asarray(q, np.float64), np.asarray(pts, np.float64)
    pos = {int(i): r for r, i in enumerate(ids)}
    for r in range(want.shape[0]):
        if np.array_equal(want[r], got[r]):
            continue
        dist = lambda i: float(((q[r] - pts[pos[int(i)]]) ** 2).sum())
        assert sorted(want[r] >= 0) == sorted(got[r] >= 0)
        for c in np.flatnonzero(want[r] != got[r]):
            a, b = dist(want[r, c]), dist(got[r, c])
            assert abs(a - b) <= rel * max(abs(a), 1e-30), (r, c, a, b)


@pytest.mark.parametrize("k", [1, 10, 40])
def test_exact_topk_ids_match_repro(data, k):
    d, queries = data
    rng = np.random.default_rng(k)
    ids = rng.permutation(5000)[: d.shape[0]].astype(np.int64)
    want = jrecall.exact_topk(queries, ids, d, k)
    got = trecall.exact_topk(queries, ids, d, k)
    assert got.dtype == np.int64 and got.shape == want.shape
    _assert_topk_ids_match(queries, ids, d, want, got)


def test_exact_topk_pads_past_the_live_count():
    pts = np.array([[0.0, 0.0], [1.0, 0.0], [2.0, 0.0], [3.0, 0.0]])
    ids = np.array([10, 11, 12, 13], dtype=np.int64)
    q = np.array([[0.1, 0.0]])
    for mod in (jrecall, trecall):
        np.testing.assert_array_equal(mod.exact_topk(q, ids, pts, k=2), [[10, 11]])
        np.testing.assert_array_equal(mod.exact_topk(q, ids[:1], pts[:1], k=3),
                                      [[10, -1, -1]])


@pytest.mark.parametrize("chunk", [1, 7, 64, 333, 1 << 16])
def test_chunked_scorer_equals_one_shot(data, tmp_path_factory, chunk):
    """Per-part, per-column-chunk running top-k == one dense pass over the
    concatenated live points, whatever the chunk."""
    d, queries = data
    _, tm = mutable_pair(str(tmp_path_factory.mktemp(f"c{chunk}")), d)
    parts = trecall.live_parts(tm)
    assert len(parts) >= 3  # segments and the write buffer
    ids, pts = trecall.live_points(tm)
    one_shot = trecall.exact_topk(queries, ids, pts, 10, chunk=ids.size)
    got = trecall.exact_topk_parts(queries, parts, 10, chunk=chunk)
    np.testing.assert_array_equal(got, one_shot)


def test_live_points_match_repro_and_mask_tombstones(data, tmp_path):
    d, _ = data
    jm, tm = mutable_pair(str(tmp_path / "m"), d)
    jids, jpts = jrecall.live_points(jm)
    tids, tpts = trecall.live_points(tm)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(tpts, jpts)
    assert np.intersect1d(tids, np.arange(0, 1500, 7)).size == 0


def test_live_parts_leave_out_pow2_padding(data):
    """``repro``'s live_points counts a pow2-padded segment's repeated rows
    again, so its ground truth can hold one id twice; the port's parts
    stop at each segment's real rows."""
    from repro.index import MutableHilbertIndex as JMutable
    from repro_torch.index import MutableHilbertIndex
    from _torch_parity import JCFG, TCFG
    import dataclasses

    d, queries = data
    jm = JMutable(dataclasses.replace(JCFG, seal_pow2=True), buffer_capacity=100)
    tm = MutableHilbertIndex(dataclasses.replace(TCFG, seal_pow2=True),
                             buffer_capacity=100, device="cpu")
    for m in (jm, tm):
        m.insert(d[:100])
        m.delete(np.arange(0, 100, 4))
        m.compact()
        m.insert(d[100:180])
        m.flush()  # 80 rows sealed into a segment padded to 128
    assert tm.segments[-1].n_pad == 48
    jids, _ = jrecall.live_points(jm)
    tids, _ = trecall.live_points(tm)
    assert jids.size == tids.size + 48 and np.unique(tids).size == tids.size
    exact = trecall.exact_topk_parts(queries, trecall.live_parts(tm), 10)
    assert all(np.unique(r).size == r.size for r in exact)


def test_recall_at_k_is_identical():
    rng = np.random.default_rng(3)
    a = rng.integers(-1, 50, (20, 10))
    e = rng.integers(-1, 50, (20, 10))
    np.testing.assert_array_equal(trecall.recall_at_k(a, e), jrecall.recall_at_k(a, e))


def test_recall_probe_samples_and_scores_like_repro(data, tmp_path):
    """Same seed: the same offers are kept and dropped, and the kept
    batches score the same recall, in both packages."""
    d, queries = data
    jm, tm = mutable_pair(str(tmp_path / "m"), d)
    jp = jrecall.RecallProbe(jrecall.RecallProbeConfig(fraction=0.4, max_pending=3,
                                                       seed=7),
                             registry=jobs.MetricsRegistry())
    tp = trecall.RecallProbe(trecall.RecallProbeConfig(fraction=0.4, max_pending=3,
                                                       seed=7),
                             registry=tobs.MetricsRegistry())
    kept = {"jax": [], "torch": []}
    for i in range(12):
        q = queries[(4 * i) % Q : (4 * i) % Q + 4]
        ji, _ = jm.search(q, JSP)
        ti, _ = tm.search(q, TSP)
        kept["jax"].append(jp.offer(q, np.asarray(ji), JSP.k, jm))
        kept["torch"].append(tp.offer(q, host(ti), TSP.k, tm))
        if i % 5 == 4:
            assert tp.score_pending() == jp.score_pending()
    assert kept["torch"] == kept["jax"] and any(kept["torch"])
    assert tp.score_pending() == jp.score_pending()
    assert list(tp._window) == list(jp._window)
    assert tp.recall() == jp.recall()


def test_online_recall_matches_offline(data, tmp_path):
    """The engine's probe (100% sample) equals an offline exact evaluation
    of the same served results."""
    d, queries = data
    _, tm = mutable_pair(str(tmp_path / "m"), d)
    eng = TEngine(tm, TSP, max_batch=16,
                  recall=tobs.RecallProbeConfig(fraction=1.0, max_pending=16, seed=0))
    direct_i, _ = tm.search(queries, TSP)
    for a, b in [(0, 16), (16, 48)]:
        eng.submit(queries[a:b])
    while eng.step():
        pass
    assert eng.score_recall() == Q
    ids, pts = trecall.live_points(tm)
    offline = float(trecall.recall_at_k(host(direct_i),
                                        jrecall.exact_topk(queries, ids, pts, TSP.k)).mean())
    assert abs(eng.recall_probe.recall() - offline) <= 1e-12
    assert 0.0 < offline <= 1.0


@pytest.mark.parametrize("drain", [True, False])
def test_stopped_engine_releases_its_probe_and_snapshots(data, tmp_path, drain):
    """The process-global registry binds the probe's gauges through a
    weakref: once a stopped engine is dropped, its probe and every snapshot
    the probe kept are collectable, and the probe's gauges read nan."""
    import gc
    import weakref

    d, queries = data
    _, tm = mutable_pair(str(tmp_path / "m"), d)
    eng = TEngine(tm, TSP, max_batch=16,
                  recall=tobs.RecallProbeConfig(fraction=1.0, max_pending=16, seed=0))
    eng.submit(queries[:16])
    while eng.step():
        pass
    probe = eng.recall_probe
    assert len(probe._pending) == 1
    snap = probe._pending[0][3]
    assert snap is not tm and snap.segments[0].index is tm.segments[0].index
    refs = [weakref.ref(probe), weakref.ref(snap)]
    del probe, snap
    eng.stop(drain=drain)
    del eng
    gc.collect()
    assert [r() for r in refs] == [None, None]
    snap = tobs.default_registry().snapshot()
    assert np.isnan(snap["engine_recall_at_k"])
    assert np.isnan(snap["engine_recall_pending_batches"])


def test_step_mode_bit_identical_with_observability_enabled(statics, data):
    _, tidx = statics
    _, queries = data
    direct_i, direct_d = tidx.search(queries, TSP)
    tracer = tobs.default_tracer()
    prev = tracer.enabled
    try:
        tobs.enable()
        eng = TEngine(tidx, TSP, max_batch=16,
                      recall=tobs.RecallProbeConfig(fraction=1.0, max_pending=16,
                                                    seed=0))
        cuts = [0, 5, 8, 20, 21, 37, Q]
        tickets = [eng.submit(queries[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]
        while eng.step():
            pass
        eng.score_recall()
    finally:
        tracer.enabled = prev
    np.testing.assert_array_equal(np.concatenate([t.ids for t in tickets]),
                                  host(direct_i))
    np.testing.assert_array_equal(np.concatenate([t.dists for t in tickets]),
                                  host(direct_d))
    snap = tobs.default_registry().snapshot()
    assert not np.isnan(snap["engine_recall_at_k"])


ENGINE_GAUGES = (
    "engine_queue_depth", "engine_epoch", "engine_segments",
    "engine_tombstone_ratio", "engine_live_rows", "engine_buffered_rows",
    "engine_buffer_fill", "engine_degraded", "engine_rwlock_readers",
    "engine_rwlock_pending_writers", "engine_rwlock_write_held_ms",
    "engine_recall_at_k", "engine_recall_pending_batches",
    "engine_maint_last_log_depth",
)


def test_engine_spans_and_series_match_repro(data, tmp_path):
    """The same step-mode engine run (batched searches with a 100% recall
    probe, writes, a forced maintenance) records the same span names,
    nesting and attributes, and exposes the same engine_* series with the
    same counter deltas and latency sample counts."""
    d, queries = data
    jm, tm = mutable_pair(str(tmp_path / "m"), d, n=600)
    shapes, views = {}, {}
    for name, mod, eng_cls, mut, sp in (("jax", jobs, JEngine, jm, JSP),
                                        ("torch", tobs, TEngine, tm, TSP)):
        tracer, reg = mod.default_tracer(), mod.default_registry()
        prev = tracer.enabled
        mod.enable()
        tracer.clear()
        before = reg.snapshot()
        try:
            eng = eng_cls(mut, sp, max_batch=16,
                          recall=mod.RecallProbeConfig(fraction=1.0, seed=0))
            for a in range(0, Q, 12):
                eng.submit(queries[a : a + 12])
            while eng.step():
                pass
            eng.insert(d[600:700])
            eng.delete(np.arange(30, 60))
            eng.maintain_once(force=True)
            eng.search(queries[:16])
            eng.score_recall()
            shapes[name] = _shape(tracer)
            if name == "torch":
                by_id = {s.span_id: s.name for s in tracer.spans()}
                stage_parents = Counter(by_id.get(s.parent_id)
                                        for s in tracer.stage_spans())
        finally:
            tracer.enabled = prev
            tracer.clear()
        after = reg.snapshot()
        # The registries are process-wide: compare what this run created
        # or moved, whatever other tests left there.
        view = {}
        for key, v in after.items():
            if not key.startswith("engine_"):
                continue
            if key in ("engine_request_ms", "engine_search_ms",
                       "engine_queue_wait_ms"):
                view[key] = v["count"]  # a new engine installs fresh ones
            elif key.startswith("engine_rwlock_"):
                # the snapshot's own gauge callbacks take the read side of
                # whichever engine, maybe an earlier test's, the gauges
                # are bound to: present, counts not comparable
                view[key] = None
            elif isinstance(v, dict):
                view[key] = v["count"] - (before.get(key) or {"count": 0})["count"]
            elif key.endswith("_total"):
                view[key] = v - before.get(key, 0)
        views[name] = {k: v for k, v in view.items() if v != 0}
        # gauges are live state: the ones an engine binds must be there
        assert set(ENGINE_GAUGES) <= set(after), (name, set(ENGINE_GAUGES) - set(after))
        eng.stop()
    # The port's stage spans have no counterpart in ``repro``; they keep to
    # a ring of their own, so the compared ring is ``repro``'s span for span.
    assert shapes["torch"] == shapes["jax"]
    assert stage_parents["engine.search"] > 0
    assert set(stage_parents) <= {"engine.search", "maint.prewarm", "lsm.segment_build",
                                  "lsm.compact", "build.forest", "build.master_sort"}
    names = {n for n, _, _ in shapes["torch"]}
    assert {"engine.batch", "engine.search", "maint.cycle", "maint.swap",
            "lsm.compact", "lsm.segment_build", "build.forest",
            "engine.recall_score"} <= names
    assert views["torch"] == views["jax"]
    assert views["torch"]["engine_swaps_total"] == 1


@pytest.mark.parametrize("chunk", [1, 3, 50, 499, 700])
def test_chunked_scorer_breaks_exact_ties_by_position(chunk):
    """Duplicated points tie exactly at the k-th distance: every chunk size
    keeps the lowest positions, as one dense stable pass does."""
    rng = np.random.default_rng(0)
    p = rng.normal(size=(500, 8))
    p = np.concatenate([p, p, p])
    ids = np.arange(1500, dtype=np.int64)
    q = rng.normal(size=(20, 8))
    want = trecall.exact_topk(q, ids, p, 7, chunk=1500)
    np.testing.assert_array_equal(trecall.exact_topk(q, ids, p, 7, chunk=chunk), want)
    assert (want[:, :3] % 500 == want[:, :1] % 500).all()  # the three copies first


# -- live_parts of the sharded layouts, against repro on 4 devices -----------------


@pytest.fixture(scope="module")
def sharded_ref(tmp_path_factory):
    """repro's live_points of its sharded layouts, from the 4-device run of
    ``tests/_jax_sharded_mutable_4dev.py`` (once per pytest run)."""
    import os

    from _jax_sharded_mutable_4dev import reference

    return np.load(os.path.join(reference(tmp_path_factory), "ref.npz"))


@pytest.fixture(scope="module")
def sharded_indexes():
    """The port's sharded-mutable index as the script's stage ``stream``
    left it, and a static 4-shard index over the script's first rows."""
    import _jax_sharded_mutable_4dev as script
    from repro_torch.data import ann_datasets
    from repro_torch.index import (ForestConfig, IndexConfig, SearchParams,
                                   ShardedHilbertIndex, ShardedMutableHilbertIndex)

    cfg = IndexConfig(forest=ForestConfig(**script.FOREST), seal_pow2=script.SEAL_POW2)
    data, queries = ann_datasets.lowrank_dataset_with_queries(script.N, script.Q, script.D,
                                                              n_clusters=8, seed=0)
    got = {}

    def on_stage(name, idx):
        # the script's searches rewrite over-tombstoned generations
        idx.search(queries, SearchParams(**script.SEARCH))
        if name == "stream":
            got["sharded_mutable"] = idx.snapshot()

    script.run_script(lambda rows: ShardedMutableHilbertIndex.build(
        rows, cfg, n_shards=script.SHARDS, buffer_capacity=script.BUFFER,
        max_segments=script.MAX_SEGMENTS, device="cpu"), data, on_stage)
    got["sharded"] = ShardedHilbertIndex.build(data[: script.BASE], cfg,
                                               n_shards=script.SHARDS, device="cpu")
    return got


@pytest.mark.parametrize("layout", ["sharded_mutable", "sharded"])
def test_live_parts_of_sharded_layouts_match_repro(sharded_ref, sharded_indexes, layout):
    """One part per (generation, shard) and per buffer slice, or per shard:
    the live set once each, no padding copies, in repro's order."""
    idx = sharded_indexes[layout]
    parts = trecall.live_parts(idx)
    tids, tpts = trecall.live_points(idx)
    assert np.unique(tids).size == tids.size
    if layout == "sharded_mutable":
        assert len(parts) == idx.n_segments * idx.n_shards + int(
            np.count_nonzero(idx._buf_count))
        np.testing.assert_array_equal(np.sort(tids), np.flatnonzero(idx._lsm.alive))
    else:
        assert len(parts) == idx.n_shards
        np.testing.assert_array_equal(np.sort(tids), np.arange(idx.n_points))
    prefix = "lp_mut" if layout == "sharded_mutable" else "lp_static"
    np.testing.assert_array_equal(tids, sharded_ref[prefix + "_ids"])
    np.testing.assert_array_equal(tpts, sharded_ref[prefix + "_pts"])


def test_sharded_parts_score_like_the_concatenation(sharded_indexes):
    import _jax_sharded_mutable_4dev as script
    from repro_torch.data import ann_datasets

    _, queries = ann_datasets.lowrank_dataset_with_queries(script.N, script.Q, script.D,
                                                           n_clusters=8, seed=0)
    for idx in sharded_indexes.values():
        ids, pts = trecall.live_points(idx)
        one_shot = trecall.exact_topk(queries, ids, pts, 10, chunk=ids.size)
        got = trecall.exact_topk_parts(queries, trecall.live_parts(idx), 10, chunk=7)
        np.testing.assert_array_equal(got, one_shot)
