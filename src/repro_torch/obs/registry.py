"""Process-global metrics registry: counters, gauges, latency recorders.

Copy of ``repro.obs.registry``: the same series names, labels and
exposition, so one scrape config reads either package.

One registry per process (``default_registry()``) collects every metric
the library emits — engine lifecycle counters, per-site dispatch and
recompile counters, LSM gauges, latency recorders — and exports them two
ways: a JSON ``snapshot()`` for programmatic consumers (benchmarks, the
``/metrics.json`` endpoint) and Prometheus text exposition
(``prometheus_text()``) for scraping through
:class:`repro_torch.obs.http.MetricsServer`.

Naming follows Prometheus convention: ``snake_case``, counters end in
``_total``, label sets are written ``name{key="value"}``.  Metrics are
get-or-create: ``registry.counter("x")`` returns the same object on
every call, so instrumentation sites don't coordinate creation order.

``LatencyRecorder`` keeps raw samples (bounded ring) so percentiles are
exact over the retained window rather than histogram-bucketed — tail
latency (p999) is the whole point of the serving engine, so the last
thing the metrics layer should do is quantize it away.  It lives here
(not ``serve/metrics.py``) because core/index instrumentation needs it
without importing the serving layer; ``serve.metrics`` re-exports it.
"""

from __future__ import annotations

import json
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "percentile_label", "percentiles", "Counter", "Gauge",
    "LatencyRecorder", "MetricsRegistry", "default_registry",
]


def percentile_label(p: float) -> str:
    """Stable metric-key label for a percentile point.

    Integral points keep their value (``50 -> "p50"``); fractional
    points drop the dot so the label stays a valid identifier/JSON key
    with a fixed reading — digits after the implied two-integer-digit
    prefix are fraction digits (``99.9 -> "p999"``, ``99.99 -> "p9999"``,
    ``99.5 -> "p995"``).  This generalizes the old special-cased
    ``"p99.9" -> "p999"`` replace, which collapsed e.g. 9.99 and 99.9
    onto the same label only by luck of the inputs used.
    """
    return f"p{p:g}".replace(".", "")


def percentiles(samples_ms, points=(50.0, 99.0, 99.9)) -> Dict[str, float]:
    """``{"p50": ..., "p99": ..., "p999": ...}`` over a sample list (ms).

    Uses the nearest-rank method on the sorted samples (what a latency SLO
    means operationally); returns an empty dict for no samples.
    """
    s = np.sort(np.asarray(list(samples_ms), np.float64))
    if s.size == 0:
        return {}
    out = {}
    for p in points:
        idx = min(s.size - 1, int(np.ceil(p / 100.0 * s.size)) - 1)
        out[percentile_label(p)] = float(s[max(idx, 0)])
    return out


def _fmt_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{v}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


class Counter:
    """Monotonic integer counter.  ``inc()`` is one locked add."""

    __slots__ = ("name", "labels", "_v", "_lock")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = dict(labels)
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, by: int = 1) -> None:
        with self._lock:
            self._v += int(by)

    @property
    def value(self) -> int:
        with self._lock:
            return self._v


class Gauge:
    """Point-in-time value: either set explicitly or computed on read.

    A callback gauge (``fn=``) is evaluated at snapshot time — the right
    shape for values that already live somewhere (queue depth, segment
    count): no write on the hot path, always current at scrape.  A
    callback that raises reports ``nan`` rather than poisoning the
    snapshot (the gauge's owner may have been torn down).
    """

    __slots__ = ("name", "labels", "_v", "_fn", "_lock")

    def __init__(self, name: str, labels: Dict[str, str],
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.labels = dict(labels)
        self._v = 0.0
        self._fn = fn
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._v = float(value)

    @property
    def value(self) -> float:
        fn = self._fn
        if fn is not None:
            try:
                return float(fn())
            except Exception:
                return float("nan")
        with self._lock:
            return self._v


class LatencyRecorder:
    """Bounded ring of latency samples with exact percentile snapshots."""

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._cap = int(capacity)
        self._buf = np.zeros((self._cap,), np.float64)
        self._n = 0          # total ever recorded
        self._lock = threading.Lock()

    def record(self, latency_ms: float) -> None:
        with self._lock:
            self._buf[self._n % self._cap] = float(latency_ms)
            self._n += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    def _consistent(self) -> Tuple[int, np.ndarray]:
        """One ``(total count, retained window)`` pair under the lock.

        ``snapshot()`` used to read ``self._n`` after ``samples()``
        released the lock — a racing ``record()`` could make the reported
        count disagree with the window it supposedly described.
        """
        with self._lock:
            return self._n, self._buf[: min(self._n, self._cap)].copy()

    def samples(self) -> np.ndarray:
        """Copy of the retained window (oldest-sample order not preserved)."""
        return self._consistent()[1]

    def snapshot(self, points=(50.0, 99.0, 99.9)) -> Dict[str, float]:
        n, s = self._consistent()
        out = percentiles(s, points)
        out["count"] = float(n)
        if s.size:
            out["mean"] = float(s.mean())
            out["max"] = float(s.max())
        return out


class MetricsRegistry:
    """Get-or-create home for every metric in the process.

    Keys are ``(name, sorted label items)``.  Re-registering a callback
    gauge replaces its callback (the newest owner wins — an engine
    restart re-binds ``engine_segments`` to the live engine rather than
    the dead one).  ``snapshot()``/``prometheus_text()`` copy the metric
    map under the lock, then read values lock-free per metric.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple], Any] = {}

    def _key(self, name: str, labels: Dict[str, str]) -> Tuple[str, Tuple]:
        return name, tuple(sorted(labels.items()))

    def counter(self, name: str, **labels: str) -> Counter:
        key = self._key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = Counter(name, labels)
            elif not isinstance(m, Counter):
                raise TypeError(f"{name}{labels} registered as {type(m).__name__}")
            return m

    def gauge(self, name: str, fn: Optional[Callable[[], float]] = None,
              **labels: str) -> Gauge:
        key = self._key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = Gauge(name, labels, fn)
            elif not isinstance(m, Gauge):
                raise TypeError(f"{name}{labels} registered as {type(m).__name__}")
            elif fn is not None:
                m._fn = fn
            return m

    def latency(self, name: str, capacity: int = 65536,
                **labels: str) -> LatencyRecorder:
        key = self._key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = LatencyRecorder(capacity)
                m.name, m.labels = name, dict(labels)  # type: ignore[attr-defined]
            elif not isinstance(m, LatencyRecorder):
                raise TypeError(f"{name}{labels} registered as {type(m).__name__}")
            return m

    def replace_latency(self, name: str, capacity: int = 65536,
                        **labels: str) -> LatencyRecorder:
        """Install a fresh recorder under the key (reset for benchmarks)."""
        key = self._key(name, labels)
        with self._lock:
            m = LatencyRecorder(capacity)
            m.name, m.labels = name, dict(labels)  # type: ignore[attr-defined]
            self._metrics[key] = m
            return m

    def _items(self) -> List[Tuple[Tuple[str, Tuple], Any]]:
        with self._lock:
            return sorted(self._metrics.items(), key=lambda kv: kv[0])

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able view: one entry per metric, labels folded into the key."""
        out: Dict[str, Any] = {}
        for (name, litems), m in self._items():
            key = name + _fmt_labels(dict(litems))
            if isinstance(m, LatencyRecorder):
                out[key] = m.snapshot()
            else:
                out[key] = m.value
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format, version 0.0.4.

        Latency recorders export as summaries: ``<name>{quantile="0.5"}``
        series plus ``<name>_count`` (no ``_sum`` — the ring holds a
        window, so a cumulative sum would lie).
        """
        lines: List[str] = []
        seen_types: Dict[str, str] = {}

        def header(name: str, mtype: str) -> None:
            if seen_types.get(name) != mtype:
                lines.append(f"# TYPE {name} {mtype}")
                seen_types[name] = mtype

        for (name, litems), m in self._items():
            labels = dict(litems)
            if isinstance(m, Counter):
                header(name, "counter")
                lines.append(f"{name}{_fmt_labels(labels)} {m.value}")
            elif isinstance(m, Gauge):
                header(name, "gauge")
                v = m.value
                val = str(v) if v == v else "NaN"
                lines.append(f"{name}{_fmt_labels(labels)} {val}")
            elif isinstance(m, LatencyRecorder):
                header(name, "summary")
                n, s = m._consistent()
                for q in (0.5, 0.99, 0.999):
                    ql = dict(labels)
                    ql["quantile"] = f"{q:g}"
                    if s.size:
                        idx = min(s.size - 1,
                                  max(0, int(np.ceil(q * s.size)) - 1))
                        v = float(np.partition(s, idx)[idx])
                        lines.append(f"{name}{_fmt_labels(ql)} {v}")
                    else:
                        lines.append(f"{name}{_fmt_labels(ql)} NaN")
                lines.append(f"{name}_count{_fmt_labels(labels)} {n}")
        return "\n".join(lines) + "\n"

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), indent=2, sort_keys=True)


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-global registry that library instrumentation uses."""
    return _default
