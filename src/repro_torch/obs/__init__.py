"""repro_torch.obs — observability of the port: spans, metrics, recall probes.

Port of ``repro.obs``, under the same names and series:

* :mod:`repro_torch.obs.trace` — hierarchical spans (wall + device time),
  bounded buffer, Chrome-trace export.  Off by default; ``enable()``.
* :mod:`repro_torch.obs.registry` — process-global counters / gauges /
  exact-percentile latency recorders; JSON snapshot + Prometheus text.
* :mod:`repro_torch.obs.dispatch` — per-site dispatch counters and the
  compile-event counter (kernel-library builds and loads), so "no kernel
  build in steady state" is a live gauge.
* :mod:`repro_torch.obs.recall` — sampled online recall@k vs. an exact
  float64 shadow scored on the points' device, off the query path.
* :mod:`repro_torch.obs.http` — ``/metrics`` (Prometheus),
  ``/metrics.json``, ``/trace`` endpoints on a stdlib HTTP server.
"""

from .dispatch import (
    accounting_delta,
    accounting_snapshot,
    compiles_total,
    dispatch_counts,
    dispatch_scope,
    recompile_counts,
)
from .http import MetricsServer, serve_metrics
from .recall import (
    RecallProbe,
    RecallProbeConfig,
    exact_topk,
    exact_topk_parts,
    live_parts,
    live_points,
    recall_at_k,
)
from .registry import (
    Counter,
    Gauge,
    LatencyRecorder,
    MetricsRegistry,
    default_registry,
    percentile_label,
    percentiles,
)
from .trace import Span, Tracer, default_tracer, disable, enable, span, stage

__all__ = [
    "accounting_delta", "accounting_snapshot", "compiles_total",
    "dispatch_counts", "dispatch_scope", "recompile_counts",
    "MetricsServer", "serve_metrics",
    "RecallProbe", "RecallProbeConfig", "exact_topk", "exact_topk_parts",
    "live_parts", "live_points", "recall_at_k",
    "Counter", "Gauge", "LatencyRecorder", "MetricsRegistry",
    "default_registry", "percentile_label", "percentiles",
    "Span", "Tracer", "default_tracer", "disable", "enable", "span", "stage",
]
