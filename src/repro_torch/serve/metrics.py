"""Serving metrics: the engine's view over the process metrics registry.

Copy of ``repro.serve.metrics``.

``LatencyRecorder`` and ``percentiles`` now live in
:mod:`repro_torch.obs.registry` (core/index instrumentation needs them without
importing the serving layer) and are re-exported here unchanged for
compatibility.  ``EngineMetrics`` remains the engine's own view — its
counters and recorders are plain attributes the engine bumps with one
lock each — but every bump is mirrored into the process-global registry
(``engine_<name>_total`` counters, ``engine_request_ms`` /
``engine_search_ms`` / ``engine_queue_wait_ms`` recorders), so the
``/metrics`` endpoint and the JSON snapshot see the engine without the
engine knowing about exporters.

A latency sample is one float append, a counter bump two integer adds
(local + registry) — still cheap enough to record per request on the
serving path.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..obs.registry import (
    LatencyRecorder,
    MetricsRegistry,
    default_registry,
    percentile_label,
    percentiles,
)

__all__ = [
    "LatencyRecorder", "EngineMetrics", "percentiles", "percentile_label",
]


class EngineMetrics:
    """Counters + gauges + latency recorders for one serving engine.

    * ``latency`` — submit→result wall time per request (queue wait
      included: what a caller experiences).
    * ``queue_wait`` — submit→batch-formation wait per request: the
      admission-to-dispatch slice of ``latency``, the first place to
      look when request p99 diverges from search p99.
    * ``batch_latency`` — search execution wall time per micro-batch
      (timed inside the serve lock: the query path proper).
    * counters — requests admitted/rejected/completed, batches executed,
      rows searched, index swaps, maintenance runs, write ops.

    Registered in the process registry at construction: the latest
    engine owns the ``engine_*`` series (an engine restart re-binds
    them — the registry's replace semantics).
    """

    def __init__(self, capacity: int = 65536,
                 registry: Optional[MetricsRegistry] = None):
        self._registry = registry or default_registry()
        self.latency = self._registry.replace_latency(
            "engine_request_ms", capacity
        )
        self.queue_wait = self._registry.replace_latency(
            "engine_queue_wait_ms", capacity
        )
        self._batch_latency = self._registry.replace_latency(
            "engine_search_ms", capacity
        )
        self._counters: Dict[str, "object"] = {}
        for name in ("admitted", "rejected", "completed", "batches",
                     "rows_searched", "inserts", "deletes", "swaps",
                     "maintenance_runs"):
            self._counters[name] = _LocalCounter(
                self._registry.counter(f"engine_{name}_total")
            )

    # ``batch_latency`` stays assignable: benchmarks install a fresh
    # recorder to scope percentiles to a measurement window.  Keep the
    # registry pointing at whichever recorder is current.
    @property
    def batch_latency(self) -> LatencyRecorder:
        return self._batch_latency

    @batch_latency.setter
    def batch_latency(self, rec: LatencyRecorder) -> None:
        self._batch_latency = rec
        key = self._registry._key("engine_search_ms", {})
        with self._registry._lock:
            self._registry._metrics[key] = rec
        rec.name, rec.labels = "engine_search_ms", {}  # type: ignore[attr-defined]

    def bump(self, name: str, by: int = 1) -> None:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = _LocalCounter(
                self._registry.counter(f"engine_{name}_total")
            )
        c.inc(by)

    def counter(self, name: str) -> int:
        c = self._counters.get(name)
        return 0 if c is None else c.value

    def snapshot(self) -> Dict[str, object]:
        counters = {k: v.value for k, v in sorted(self._counters.items())}
        return {
            "counters": counters,
            "latency_ms": self.latency.snapshot(),
            "queue_wait_ms": self.queue_wait.snapshot(),
            "batch_latency_ms": self.batch_latency.snapshot(),
        }


class _LocalCounter:
    """Engine-local count that mirrors into a registry counter.

    The local value is what ``EngineMetrics.counter()`` reports —
    per-engine, resets with the engine — while the registry counter is
    cumulative across engine restarts (Prometheus counters must be
    monotonic).
    """

    __slots__ = ("_local", "_mirror")

    def __init__(self, mirror):
        self._local = 0
        self._mirror = mirror

    def inc(self, by: int = 1) -> None:
        by = int(by)
        with self._mirror._lock:      # one lock keeps both views in step
            self._mirror._v += by
            self._local += by

    @property
    def value(self) -> int:
        with self._mirror._lock:
            return self._local
