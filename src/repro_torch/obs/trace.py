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

* **wall** — ``time.perf_counter()`` around the body: what the thread
  waited.
* **device** — optional: call ``Span.block(tensors)`` with the body's
  result tensors before it exits, and the span additionally records the
  time to synchronize the current stream of every CUDA device they lie
  on, i.e. the tail of device work still queued when the host-side body
  finished.  CPU tensors are complete on return and add ~0.

Completed spans land in a bounded in-memory ring (oldest evicted) owned
by a :class:`Tracer`.  ``Tracer.chrome_trace()`` exports the buffer as
Chrome-trace JSON (``chrome://tracing`` / Perfetto "complete" events,
microsecond timestamps on a common epoch).

Tracing is OFF by default.  A disabled tracer hands out a shared no-op
span, so an instrumented hot path pays one attribute load + one ``if``
per span.
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

__all__ = ["Span", "Tracer", "default_tracer", "span", "enable", "disable"]

# Per-context (hence per-thread, absent explicit context propagation)
# innermost open span.  threading.Thread starts callables in a fresh
# context.
_current: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "repro_torch_obs_current_span", default=None
)

_ids = itertools.count(1)


def _cuda_devices(obj: Any, out: set) -> set:
    """The CUDA devices of every tensor in a (nested) tuple/list/dict."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cuda":
            out.add(obj.device)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _cuda_devices(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _cuda_devices(x, out)
    return out


class Span:
    """One timed region.  Use via ``Tracer.span`` — not constructed directly.

    Attributes (stable, read by exports and tests):

    * ``name``, ``span_id``, ``parent_id`` (``None`` for a root),
    * ``thread`` — ``threading.get_ident()`` of the opening thread,
    * ``t0`` — start, seconds on the tracer's ``perf_counter`` epoch,
    * ``wall_ms`` — body duration (set at exit),
    * ``device_ms`` — ``block()`` duration, or ``None`` if never called,
    * ``attrs`` — user key/values (``set(**kw)``), exported to the
      Chrome-trace ``args`` field.
    """

    __slots__ = ("name", "span_id", "parent_id", "thread", "t0",
                 "wall_ms", "device_ms", "attrs", "_tracer", "_token")

    def __init__(self, tracer: "Tracer", name: str,
                 parent: Optional["Span"]):
        self.name = name
        self.span_id = next(_ids)
        self.parent_id = parent.span_id if parent is not None else None
        self.thread = threading.get_ident()
        self.t0 = 0.0
        self.wall_ms: Optional[float] = None
        self.device_ms: Optional[float] = None
        self.attrs: Dict[str, Any] = {}
        self._tracer = tracer
        self._token: Optional[contextvars.Token] = None

    def set(self, **kw: Any) -> "Span":
        self.attrs.update(kw)
        return self

    def block(self, tensors: Any) -> Any:
        """Wait for the work queued on the tensors' streams; time it as
        device_ms.

        Synchronizes the current stream of each CUDA device that holds
        one of ``tensors`` (a tensor or a nested tuple/list/dict of them).
        Returns ``tensors`` so it drops into an existing expression, and
        accumulates across calls (a span may block several times).
        """
        t = time.perf_counter()
        for dev in _cuda_devices(tensors, set()):
            torch.cuda.current_stream(dev).synchronize()
        self.device_ms = (self.device_ms or 0.0) + (
            (time.perf_counter() - t) * 1e3
        )
        return tensors

    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        self.t0 = time.perf_counter() - self._tracer._epoch
        return self

    def __exit__(self, *exc) -> None:
        self.wall_ms = (
            time.perf_counter() - self._tracer._epoch - self.t0
        ) * 1e3
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

    def block(self, tensors: Any) -> Any:
        return tensors

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NOOP = _NoopSpan()


class Tracer:
    """Bounded buffer of completed spans + the enable/disable switch."""

    def __init__(self, capacity: int = 4096, enabled: bool = False):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._buf: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        self.enabled = bool(enabled)

    def span(self, name: str, **attrs: Any):
        """Open a span as a context manager.  No-op when disabled.

        The enabled check happens at open time: a span already open when
        the tracer is disabled still records at exit (its close must
        balance its open).
        """
        if not self.enabled:
            return _NOOP
        s = Span(self, name, _current.get())
        if attrs:
            s.attrs.update(attrs)
        return s

    def current(self) -> Optional[Span]:
        """The innermost open span in this thread, or ``None``."""
        return _current.get()

    def _record(self, s: Span) -> None:
        with self._lock:
            self._buf.append(s)

    def spans(self) -> List[Span]:
        """Copy of the retained (completed) spans, oldest first."""
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

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
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


_default = Tracer()


def default_tracer() -> Tracer:
    """The process-global tracer that library instrumentation uses."""
    return _default


def span(name: str, **attrs: Any):
    """Open a span on the default tracer (no-op unless :func:`enable` d)."""
    return _default.span(name, **attrs)


def enable(capacity: Optional[int] = None) -> Tracer:
    """Turn on the default tracer (optionally resizing its buffer)."""
    if capacity is not None and capacity != _default._buf.maxlen:
        with _default._lock:
            _default._buf = deque(_default._buf, maxlen=int(capacity))
    _default.enabled = True
    return _default


def disable() -> None:
    _default.enabled = False
