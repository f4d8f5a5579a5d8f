"""Hierarchical spans: wall time, device time, and Chrome-trace export.

Port of ``repro.obs.trace``: the same span tree, ring buffer and
Chrome-trace JSON.  A span is one timed region of work —
``with span("compact"):`` — that nests: spans opened inside it become its
children, across function-call boundaries, because the current span is
carried in a ``contextvars`` context variable.  Each thread starts with
no current span, so the engine's serve threads and maintenance thread
build separate span trees that interleave in the export without
corrupting each other's nesting.

Two clocks per span:

* **host** — ``time.perf_counter()`` around the body gives ``wall_ms``:
  what the thread waited, enqueue time for work it left on a device.
  While the tracer is enabled each span also opens a
  ``torch._C._profiler._RecordFunctionFast`` range of its name, so a
  running ``torch.profiler`` records the span as an ordinary host
  ``cpu_op`` on the profiler's own clock, beside the launches and device
  activity it brackets.  A user annotation (``record_function``) would be
  copied onto the device timeline as well; this range is not.
* **device** — for a span opened with ``device=`` a CUDA device: a
  timing event recorded on that device's current stream at open and
  another at close, never a synchronize.  ``device_ms`` is the time
  between the two on the device, the stream's idle time between them
  included, resolved when it is first read (by
  :meth:`Tracer.spans` readers or the export), not on the hot path.
  Spans without a CUDA device keep ``device_ms`` ``None``.

Completed spans land in a bounded in-memory ring owned by a
:class:`Tracer`; when it is full the oldest span is evicted and counted
in ``Tracer.dropped`` until :meth:`Tracer.clear`.  ``Tracer.chrome_trace()``
exports the ring as Chrome-trace JSON (``chrome://tracing`` / Perfetto
"complete" events, microsecond timestamps on a common epoch, ``dropped``
under ``otherData``).

Stage spans (:func:`stage`) time the steps inside one call of the core
routines (a tree's keys, a graph order's merge): hundreds a search.  They
nest like any span and are ranges of the profiler alike, but land in a
ring of their own (:meth:`Tracer.stage_spans`, evictions in
``Tracer.stage_dropped``), so they never evict the engine's spans from
the ring that the export and ``/trace`` show.

Tracing is OFF by default.  A disabled tracer hands out a shared no-op
span, so an instrumented hot path pays one attribute load + one ``if``
per span, and enters no profiler range and records no event.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import torch
from torch._C._profiler import _RecordFunctionFast as _ProfilerRange

__all__ = ["Span", "Tracer", "default_tracer", "span", "stage", "enable", "disable"]

# Per-context (hence per-thread, absent explicit context propagation)
# innermost open span.  threading.Thread starts callables in a fresh
# context.
_current: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "repro_torch_obs_current_span", default=None
)

_ids = itertools.count(1)


class Span:
    """One timed region.  Use via ``Tracer.span`` or ``Tracer.stage`` — not
    constructed directly.

    Attributes (stable, read by exports and tests):

    * ``name``, ``span_id``, ``parent_id`` (``None`` for a root),
    * ``thread`` — ``threading.get_ident()`` of the opening thread,
    * ``t0`` — start, seconds on the tracer's ``perf_counter`` epoch,
    * ``wall_ms`` — body duration (set at exit),
    * ``device_ms`` — device time between the span's two CUDA timing
      events, or ``None`` for a span opened without a CUDA device,
    * ``attrs`` — user key/values (``set(**kw)``), exported to the
      Chrome-trace ``args`` field.
    """

    __slots__ = ("name", "span_id", "parent_id", "thread", "t0", "wall_ms",
                 "attrs", "_tracer", "_token", "_device", "_events", "_range",
                 "_device_ms", "_stage")

    def __init__(self, tracer: "Tracer", name: str,
                 parent: Optional["Span"], device: Optional[torch.device] = None,
                 stage: bool = False):
        self.name = name
        self.span_id = next(_ids)
        self.parent_id = parent.span_id if parent is not None else None
        self.thread = threading.get_ident()
        self.t0 = 0.0
        self.wall_ms: Optional[float] = None
        self.attrs: Dict[str, Any] = {}
        self._tracer = tracer
        self._token: Optional[contextvars.Token] = None
        self._device = device
        self._events: Optional[tuple] = None
        self._range = None
        self._device_ms: Optional[float] = None
        self._stage = stage

    def set(self, **kw: Any) -> "Span":
        self.attrs.update(kw)
        return self

    @property
    def device_ms(self) -> Optional[float]:
        """Milliseconds between the open and close events on the device.

        Resolved on first read: waits for the close event, which a
        completed traced unit has already passed.
        """
        events = self._events
        if events is not None and len(events) == 2:
            start, end = events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self._events = None
        return self._device_ms

    def _mark(self) -> "torch.cuda.Event":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self._device))
        return ev

    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        self._range = _ProfilerRange(self.name)
        self._range.__enter__()
        if self._device is not None:
            self._events = (self._mark(),)
        self.t0 = time.perf_counter() - self._tracer._epoch
        return self

    def __exit__(self, *exc) -> None:
        self.wall_ms = (
            time.perf_counter() - self._tracer._epoch - self.t0
        ) * 1e3
        if self._events is not None:
            self._events = (self._events[0], self._mark())
        self._range.__exit__(None, None, None)
        self._range = None
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        self._tracer._record(self)


class _NoopSpan:
    """Shared do-nothing span handed out while tracing is disabled."""

    __slots__ = ()
    name = ""
    attrs: Dict[str, Any] = {}
    wall_ms = device_ms = None

    def set(self, **kw: Any) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NOOP = _NoopSpan()


class Tracer:
    """Bounded buffer of completed spans + the enable/disable switch."""

    def __init__(self, capacity: int = 4096, enabled: bool = False,
                 stage_capacity: int = 4096):
        if capacity < 1 or stage_capacity < 1:
            raise ValueError(f"capacities must be >= 1, got {capacity}, {stage_capacity}")
        self._buf: deque = deque(maxlen=int(capacity))
        self._stage_buf: deque = deque(maxlen=int(stage_capacity))
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        self.enabled = bool(enabled)
        self.dropped = 0  # spans evicted from the ring since the last clear()
        self.stage_dropped = 0  # the same for the stage ring

    def span(self, name: str, *, device: Any = None, **attrs: Any):
        """Open a span as a context manager.  No-op when disabled.

        ``device``: where the body queues its work; a CUDA device gives the
        span a device clock (``device_ms``), anything else is ignored.
        The enabled check happens at open time: a span already open when
        the tracer is disabled still records at exit (its close must
        balance its open).
        """
        if not self.enabled:
            return _NOOP
        return self._open(name, device, attrs, stage=False)

    def stage(self, name: str, *, device: Any = None, **attrs: Any):
        """Open a stage span: as :meth:`span`, kept in the stage ring."""
        if not self.enabled:
            return _NOOP
        return self._open(name, device, attrs, stage=True)

    def _open(self, name: str, device: Any, attrs: Dict[str, Any], stage: bool) -> Span:
        if device is not None:
            device = torch.device(device)
            if device.type != "cuda":
                device = None
        s = Span(self, name, _current.get(), device, stage)
        if attrs:
            s.attrs.update(attrs)
        return s

    def current(self) -> Optional[Span]:
        """The innermost open span in this thread, or ``None``."""
        return _current.get()

    def _record(self, s: Span) -> None:
        with self._lock:
            if s._stage:
                if len(self._stage_buf) == self._stage_buf.maxlen:
                    self.stage_dropped += 1
                self._stage_buf.append(s)
            else:
                if len(self._buf) == self._buf.maxlen:
                    self.dropped += 1
                self._buf.append(s)

    def spans(self) -> List[Span]:
        """Copy of the retained (completed) spans, oldest first."""
        with self._lock:
            return list(self._buf)

    def stage_spans(self) -> List[Span]:
        """Copy of the retained stage spans, oldest first."""
        with self._lock:
            return list(self._stage_buf)

    def clear(self) -> None:
        """Empty both rings and reset their eviction counts."""
        with self._lock:
            self._buf.clear()
            self._stage_buf.clear()
            self.dropped = self.stage_dropped = 0

    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome-trace JSON (``chrome://tracing`` "complete" events).

        Timestamps are microseconds on the tracer's ``perf_counter``
        epoch — monotonic and comparable across threads of this process.
        ``tid`` is the OS thread ident so serve/maintenance threads land
        on separate tracks; device time is exported as an ``args`` field
        (Chrome has no second duration axis).
        """
        events = []
        for s in self.spans():
            args = dict(s.attrs)
            if s.device_ms is not None:
                args["device_ms"] = round(s.device_ms, 3)
            if s.parent_id is not None:
                args["parent"] = s.parent_id
            events.append({
                "name": s.name,
                "ph": "X",
                "ts": round(s.t0 * 1e6, 1),
                "dur": round((s.wall_ms or 0.0) * 1e3, 1),
                "pid": 0,
                "tid": s.thread,
                "args": args,
            })
        events.sort(key=lambda e: e["ts"])
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped": self.dropped}}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


_default = Tracer()


def default_tracer() -> Tracer:
    """The process-global tracer that library instrumentation uses."""
    return _default


def span(name: str, *, device: Any = None, **attrs: Any):
    """Open a span on the default tracer (no-op unless :func:`enable` d)."""
    return _default.span(name, device=device, **attrs)


def stage(name: str, *, device: Any = None, **attrs: Any):
    """Open a stage span on the default tracer (no-op unless enabled)."""
    return _default.stage(name, device=device, **attrs)


def enable(capacity: Optional[int] = None) -> Tracer:
    """Turn on the default tracer (optionally resizing its buffer)."""
    if capacity is not None and capacity != _default._buf.maxlen:
        with _default._lock:
            _default.dropped += max(0, len(_default._buf) - int(capacity))
            _default._buf = deque(_default._buf, maxlen=int(capacity))
    _default.enabled = True
    return _default


def disable() -> None:
    _default.enabled = False
