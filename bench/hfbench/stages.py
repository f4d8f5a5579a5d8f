"""Readers of the program's stage spans, shared by the stage metrics in ``bench/metrics``.

The program records a stage span around each step of its core routines
when its tracer is on (a tree's ``search.keys``, ``search.directory`` and
``search.merge`` in a search, each Hilbert sort's ``hilbert.keys``, each
graph order's ``graph.merge``), in a ring of the tracer's own
(``tracer.stage_spans()``).  ``profile.traced`` empties the tracer, switches
it on for the traced unit alone and off again, so that ring holds that
unit's stage spans; each is also a host range of the profiler, named as the
span, in ``ctx.trace.host_events``.  A span's wall time is its host time;
where the span was opened on the card it also has ``device_ms``: the time
between two timing events recorded on the stream at its open and its close,
so the stream's idle time inside the span counts too.

Every reader returns ``None`` off the card, where the program runs its plain
routes, when the stage ring evicted spans (a share would read too low), and
where the program records no such span (a program without a stage ring reads
nothing, and the line leaves the metric out).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from hfbench import kind

# The host calls that launch a kernel, as the profiler names them.
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def _stage_spans(ctx) -> Optional[list]:
    """The traced unit's stage spans, or ``None`` off the card, when the stage
    ring dropped spans, or for a program whose tracer has no stage ring."""
    if not ctx.on_card:
        return None
    tracer = kind.program().tracer
    read = getattr(tracer, "stage_spans", None)
    if read is None or tracer.stage_dropped:
        return None
    return read()


def wall_pct(ctx, name: str) -> Optional[float]:
    """Summed wall time of the stage spans named ``name`` over the traced unit's wall time."""
    spans = _stage_spans(ctx)
    if spans is None or ctx.trace.wall_s <= 0:
        return None
    ms = [s.wall_ms for s in spans if s.name == name]
    return 100.0 * sum(ms) * 1e-3 / ctx.trace.wall_s if ms else None


def device_pct(ctx, name: str) -> Optional[float]:
    """Summed stream intervals of the stage spans named ``name`` (idle time
    inside them included) over the traced unit's wall time."""
    spans = _stage_spans(ctx)
    if spans is None or ctx.trace.wall_s <= 0:
        return None
    ms: List[Optional[float]] = [s.device_ms for s in spans if s.name == name]
    if not ms or any(m is None for m in ms):
        return None
    return 100.0 * sum(ms) * 1e-3 / ctx.trace.wall_s


def launches_inside(ctx, name: str) -> Optional[int]:
    """Host kernel-launch events that start inside the profiler's ranges named ``name``."""
    if _stage_spans(ctx) is None:
        return None
    ranges = sorted((s, e) for n, s, e in ctx.trace.host_events if n == name)
    if not ranges:
        return None
    starts = np.array([s for s, _ in ranges], dtype=np.int64)
    ends = np.array([e for _, e in ranges], dtype=np.int64)
    t = np.array([s for n, s, _ in ctx.trace.host_events if n in LAUNCHES], dtype=np.int64)
    j = np.searchsorted(starts, t, side="right") - 1
    inside = (j >= 0) & (t <= ends[np.maximum(j, 0)])
    return int(inside.sum())


def launches_per(ctx, name: str) -> Optional[float]:
    """:func:`launches_inside` per query or row of the traced unit."""
    n = launches_inside(ctx, name)
    return None if n is None or ctx.trace_count <= 0 else n / ctx.trace_count
