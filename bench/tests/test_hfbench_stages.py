"""The stage metrics' readers on a hand-made trace and a fake tracer: each
gives its number on the card, and nothing off the card, when the stage
ring dropped spans, or where the program records no stage spans."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import pytest

from hfbench import kind, profile
from hfbench.spec import Spec

REPO = Path(__file__).resolve().parents[2]


def _span(name, wall_ms=0.0, device_ms=None):
    return SimpleNamespace(name=name, wall_ms=wall_ms, device_ms=device_ms)


# One traced unit of 2.0 s: two query chunks' keys (0.2 s each), directory
# searches (0.5 + 0.4 s) and merges (0.1 s each); two Hilbert sorts whose
# keys spanned 0.25 and 0.35 s on the card, and two graph orders whose
# merges spanned 0.3 and 0.2 s.
RING = [_span("search.keys", 200.0), _span("search.keys", 200.0),
        _span("search.directory", 500.0), _span("search.directory", 400.0),
        _span("search.merge", 100.0), _span("search.merge", 100.0),
        _span("hilbert.keys", 10.0, 250.0), _span("hilbert.keys", 10.0, 350.0),
        _span("graph.merge", 5.0, 300.0), _span("graph.merge", 5.0, 200.0)]
HOST = [("search.directory", 100, 200), ("search.directory", 400, 500),
        ("cudaLaunchKernel", 100, 101), ("cudaLaunchKernel", 150, 160),
        ("cuLaunchKernelEx", 199, 210), ("cudaLaunchKernelExC", 450, 452),
        ("cudaLaunchKernel", 250, 251),  # between the ranges
        ("cudaLaunchKernel", 501, 502),  # just after the second
        ("aten::lt", 120, 130)]
DEVICE = [("k", 100, 300)]

EXPECTED = {
    "keys_pct.search": 20.0,
    "directory_pct.search": 45.0,
    "merge_pct.search": 10.0,
    "directory_launches_per_query.search": 4 / 8,
    "keys_pct.graph": 30.0,
    "keys_pct.build": 30.0,
    "merge_pct.graph": 25.0,
}


def _ctx(on_card=True, host=HOST):
    trace = profile.Trace(DEVICE, host, (0, 1000), [], 2.0)
    return SimpleNamespace(on_card=on_card, trace=trace, trace_count=8, config={},
                           traffic={}, units=[], counts=[], window_s=2.0, peak_bytes=None)


@pytest.fixture
def tracer(monkeypatch):
    fake = SimpleNamespace(spans=lambda: [], stage_spans=lambda: list(RING), dropped=0,
                           stage_dropped=0)
    monkeypatch.setattr(kind, "program", lambda: SimpleNamespace(tracer=fake))
    return fake


def _read(name, ctx):
    return Spec(REPO).reader(name).read(ctx)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_gives_its_number_on_the_card(tracer, name):
    assert _read(name, _ctx()) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_nothing_off_the_card_or_after_drops(tracer, name):
    assert _read(name, _ctx(on_card=False)) is None
    tracer.stage_dropped = 3
    assert _read(name, _ctx()) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_nothing_from_a_program_without_the_spans(monkeypatch, name):
    old = SimpleNamespace(spans=lambda: [_span("build.forest")])  # no stage ring
    monkeypatch.setattr(kind, "program", lambda: SimpleNamespace(tracer=old))
    ctx = _ctx(host=[ev for ev in HOST if not ev[0].startswith("search.")])
    assert _read(name, ctx) is None


def test_device_share_needs_every_span_timed(tracer):
    tracer.stage_spans = lambda: [_span("hilbert.keys", 1.0, 250.0), _span("hilbert.keys")]
    assert _read("keys_pct.graph", _ctx()) is None


def test_each_stage_metric_lists_its_own_cell_only():
    spec = Spec(REPO)
    cells = {m["name"]: m["workloads"] for m in spec.bench["per_layer"]}
    for name in EXPECTED:
        kind_ = name.rsplit(".", 1)[1]
        assert len(cells[name]) == 1 and cells[name][0].endswith("." + kind_)
