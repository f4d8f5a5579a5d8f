"""Stage spans of the port's search, graph and build.

With the tracer on, ``HilbertIndex.build``, ``.search`` and ``.knn_graph``
record a stage span around each step that a benchmark metric reads: the
keys, directory search and merge of each tree in a search, the keys of
each Hilbert sort, and the merge of each graph order.  Stage spans land in
a ring of their own, so they never evict the engine's spans from the ring
the export shows.  Each span is also a host op of a running
``torch.profiler`` and never a user annotation (those are mirrored onto
the device timeline).  With the tracer off nothing is recorded and every
answer is bit-identical.  On a card (marker ``cuda``) the device clock of
a span is two timing events, never a synchronize:
``python -m pytest -q -m cuda tests/test_torch_spans.py``.
The file imports torch and repro_torch only, so it runs without jax.
"""

import warnings
from collections import Counter
from contextlib import contextmanager

import pytest
import torch

from repro_torch.core import search as search_lib
from repro_torch.core.types import (ForestConfig, GraphParams, QuantizerConfig,
                                    SearchParams)
from repro_torch.index import HilbertIndex, IndexConfig
from repro_torch.obs import trace

N, D, TREES, CHUNK = 512, 32, 4, 16
CFG = IndexConfig(
    forest=ForestConfig(n_trees=TREES, bits=4, key_bits=64, leaf_size=16, seed=0),
    quantizer=QuantizerConfig(bits=4, sample_limit=N), store_points=True,
    query_chunk=CHUNK)
SP = SearchParams(k1=32, k2=16, h=1, k=5)
GP = GraphParams(n_orders=2, k1=8, k2=6, k=4, seed=0)
QUERIES = 2 * CHUNK  # two full chunks

TREE_STAGES = ("search.keys", "search.directory", "search.merge")


def _inputs(device="cpu"):
    g = torch.Generator().manual_seed(0)
    pts = torch.randn(N, D, generator=g)
    return pts.to(device), torch.randn(QUERIES, D, generator=g).to(device)


@contextmanager
def _tracing(on=True):
    """The default tracer on (or off) and emptied, restored after."""
    tr = trace.default_tracer()
    prev = tr.enabled
    tr.clear()
    tr.enabled = on
    try:
        yield tr
    finally:
        tr.enabled = prev


def _edges(tr):
    """Counts of (span name, parent name, ring) over both rings."""
    rings = {"main": tr.spans(), "stage": tr.stage_spans()}
    by_id = {s.span_id: s for ring in rings.values() for s in ring}
    return Counter((s.name, by_id[s.parent_id].name if s.parent_id in by_id else None, r)
                   for r, ring in rings.items() for s in ring)


def _run(path, index, queries, tr):
    if path == "build":
        HilbertIndex.build(index.points, CFG, device=index.points.device)
    elif path == "search":
        index.search(queries, SP)
    else:
        index.knn_graph(GP)
    return tr.stage_spans()


@pytest.fixture(scope="module")
def cpu_index():
    pts, queries = _inputs()
    with _tracing(False):
        return HilbertIndex.build(pts, CFG, device="cpu"), queries


EXPECTED = {
    "build": {
        ("build.quantization", None, "main"): 1, ("build.sketches", None, "main"): 1,
        ("build.forest", None, "main"): 1, ("build.master_sort", None, "main"): 1,
        ("hilbert.keys", "build.forest", "stage"): TREES,
        ("hilbert.keys", "build.master_sort", "stage"): 1,
    },
    "search": {(s, None, "stage"): 2 * TREES for s in TREE_STAGES},
    "graph": {
        ("hilbert.keys", None, "stage"): GP.n_orders,
        ("graph.merge", None, "stage"): GP.n_orders,
    },
}


@pytest.mark.parametrize("path", ["build", "search", "graph"])
def test_span_tree_of_each_path(cpu_index, path):
    """Names, rings, nesting and counts: per chunk and tree, per sort, per order."""
    index, queries = cpu_index
    with _tracing() as tr:
        spans = _run(path, index, queries, tr)
        assert _edges(tr) == Counter(EXPECTED[path])
        assert tr.dropped == 0 and tr.stage_dropped == 0
    # Attributes are plain ints, in the order the stages ran.
    if path == "search":
        assert [s.name for s in spans] == list(TREE_STAGES) * (2 * TREES)
        assert all(s.attrs == {} for s in spans)
    elif path == "graph":
        assert [s.attrs for s in spans if s.name == "graph.merge"] == [
            dict(order=o, rows=N, k1=GP.k1, k2=GP.k2) for o in range(GP.n_orders)]
        assert [s.attrs for s in spans if s.name == "hilbert.keys"] == [
            dict(rows=N)] * GP.n_orders
    else:
        assert [s.attrs for s in spans] == [dict(rows=N)] * (TREES + 1)
    for s in spans:
        assert all(type(v) is int for v in s.attrs.values()), (s.name, s.attrs)
        assert s.wall_ms is not None and s.wall_ms >= 0


def test_tracer_off_records_nothing_and_answers_match(cpu_index):
    index, queries = cpu_index
    outs = {}
    for on in (False, True):
        with _tracing(on) as tr:
            built = HilbertIndex.build(index.points, CFG, device="cpu")
            outs[on] = (built.master_order, built.forest.orders,
                        built.forest.directories, built.codes_master,
                        *built.search(queries, SP), *built.knn_graph(GP))
            assert bool(tr.spans()) is on and bool(tr.stage_spans()) is on
            assert tr.dropped == 0 and tr.stage_dropped == 0
    for a, b in zip(outs[False], outs[True]):
        assert torch.equal(a, b)


def test_spans_are_host_ops_on_the_profiler_clock(cpu_index):
    """Every span of either ring is one host ``cpu_op`` of the profiler,
    named as the span, none a user annotation, and the ranges nest as the
    spans do."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    index, queries = cpu_index
    with _tracing() as tr:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            HilbertIndex.build(index.points, CFG, device="cpu")
            index.search(queries, SP)
        spans = tr.spans() + tr.stage_spans()
    names = Counter(s.name for s in spans)
    events = [ev for ev in prof.profiler.kineto_results.events() if ev.name() in names]
    assert Counter(ev.name() for ev in events) == names
    assert all(ev.device_type() == DeviceType.CPU for ev in events)
    assert not any(ev.is_user_annotation() for ev in events)
    sorts = [(ev.start_ns(), ev.end_ns()) for ev in events
             if ev.name() in ("build.forest", "build.master_sort")]
    for ev in events:
        if ev.name() == "hilbert.keys":
            assert any(a <= ev.start_ns() and ev.end_ns() <= b for a, b in sorts)


def test_dropped_counts_evictions_and_clear_resets_it():
    tr = trace.Tracer(capacity=3, enabled=True)
    for i in range(5):
        with tr.span(f"s{i}"):
            pass
    assert [s.name for s in tr.spans()] == ["s2", "s3", "s4"]
    assert tr.dropped == 2 and tr.chrome_trace()["otherData"] == {"dropped": 2}
    tr.clear()
    assert tr.dropped == 0 and tr.spans() == []
    with tr.span("again"):
        pass
    assert tr.dropped == 0 and len(tr.spans()) == 1


def test_stage_spans_never_evict_the_exported_spans():
    """However many stage spans a call records, the spans of the ring the
    export shows stay, and only the stage ring counts evictions."""
    tr = trace.Tracer(capacity=4, stage_capacity=2, enabled=True)
    for _ in range(3):
        with tr.span("engine.search"):
            for _ in range(5):
                with tr.stage("search.keys"):
                    pass
    assert [s.name for s in tr.spans()] == ["engine.search"] * 3
    assert (tr.dropped, tr.stage_dropped, len(tr.stage_spans())) == (0, 13, 2)
    doc = tr.chrome_trace()
    assert [e["name"] for e in doc["traceEvents"]] == ["engine.search"] * 3
    assert doc["otherData"] == {"dropped": 0}
    parent = {s.span_id for s in tr.spans()}
    assert all(s.parent_id in parent for s in tr.stage_spans())
    tr.clear()
    assert (tr.dropped, tr.stage_dropped, tr.stage_spans()) == (0, 0, [])


def test_device_ms_is_none_without_a_cuda_device(cpu_index):
    index, queries = cpu_index
    with _tracing() as tr:
        index.search(queries, SP)
        index.knn_graph(GP)
        spans = tr.stage_spans()
        doc = tr.chrome_trace()
    assert spans and all(s.device_ms is None for s in spans)
    assert not any("device_ms" in e["args"] for e in doc["traceEvents"])


# -- on the card --------------------------------------------------------------


@pytest.mark.cuda
def test_spans_on_the_card_keep_off_the_device_timeline_and_never_sync():
    """No CUDA-typed profiler event carries a span's name; a device span
    issues no synchronizing operation, so a traced search chunk issues just
    those the untraced one does; a child's device time is within its
    parent's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the device clock is CUDA events)")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pts, queries = _inputs("cuda")
    with _tracing(False):
        index = HilbertIndex.build(pts, CFG, device="cuda")
        index.search(queries, SP)  # kernels built and loaded
    f, fc, q = index.forest, CFG.forest, queries[:CHUNK].contiguous()
    torch.cuda.synchronize()

    def chunk():
        return search_lib.fused_search_chunk(
            q, f.orders, f.directories, f.lo, f.hi, f.perms, f.flips,
            index.master_rank, index.sketches_master, index.codes_master,
            index.master_order, index.quant, bits=fc.bits, key_bits=fc.key_bits,
            leaf_size=fc.leaf_size, k1=SP.k1, k2=SP.k2, h=SP.h, k=SP.k,
            use_kernels=True)

    def syncs(fn, on):
        """The synchronizing operations ``fn`` issues, by sync-debug warnings."""
        with _tracing(on) as tr, warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            names = Counter(s.name for s in tr.spans() + tr.stage_spans())
        return [str(w.message) for w in caught
                if "synchronizing CUDA operation" in str(w.message)], names

    x = torch.ones(1024, device="cuda")

    def nested():
        with trace.span("outer", device=x.device):
            with trace.stage("inner", device=x.device, rows=1024):
                return x * 2

    assert syncs(nested, True) == ([], Counter(outer=1, inner=1))
    tr = trace.default_tracer()
    (outer,), (inner,) = tr.spans(), tr.stage_spans()
    assert 0 <= inner.device_ms <= outer.device_ms
    off, _ = syncs(chunk, False)
    on, names = syncs(chunk, True)
    assert len(on) == len(off) and names["search.keys"] == TREES
    with _tracing() as tr:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            index.search(queries, SP)
            index.knn_graph(GP)
            torch.cuda.synchronize()
        spans = tr.spans() + tr.stage_spans()
    names = {s.name for s in spans}
    events = [ev for ev in prof.profiler.kineto_results.events() if ev.name() in names]
    assert events and not any(ev.device_type() == DeviceType.CUDA for ev in events)
    timed = {s.name for s in spans if s.device_ms is not None}
    assert timed == {"graph.merge", "hilbert.keys"}
