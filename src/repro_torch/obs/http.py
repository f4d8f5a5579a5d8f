"""Metrics/trace export over HTTP — stdlib only, one daemon thread.

Copy of ``repro.obs.http``.

``serve_metrics(port)`` starts a ``ThreadingHTTPServer`` exposing the
process-global registry and tracer:

* ``/metrics``      — Prometheus text exposition (scrape target);
* ``/metrics.json`` — the registry's JSON snapshot;
* ``/trace``        — Chrome-trace JSON of the tracer's span buffer
  (load in ``chrome://tracing`` or Perfetto);
* ``/healthz``      — readiness: 200 ``ok`` normally, 503 ``degraded``
  while the serving engine is in degraded read-only mode (its WAL became
  unwritable — the ``engine_degraded`` gauge).  Point the load
  balancer's write-path health check here.

Port 0 binds an ephemeral port; read it back from ``server.port``.
``chip_smoke.py`` (phase ``engine``) scrapes all three views.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from . import trace
from .registry import MetricsRegistry, default_registry

__all__ = ["MetricsServer", "serve_metrics"]


class _Handler(BaseHTTPRequestHandler):
    registry: MetricsRegistry
    tracer: trace.Tracer

    def do_GET(self):  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        if path == "/healthz":
            # Degraded = the engine refuses writes (WAL unwritable) but
            # keeps serving reads; a dead/absent engine's callback gauge
            # reads NaN and counts as healthy (nothing to protect).
            v = self.registry.snapshot().get("engine_degraded", 0.0)
            degraded = isinstance(v, (int, float)) and v == v and v > 0
            body = b"degraded\n" if degraded else b"ok\n"
            self.send_response(503 if degraded else 200)
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if path == "/metrics":
            body = self.registry.prometheus_text().encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif path == "/metrics.json":
            body = self.registry.to_json().encode()
            ctype = "application/json"
        elif path == "/trace":
            body = json.dumps(self.tracer.chrome_trace()).encode()
            ctype = "application/json"
        else:
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # quiet: scrapes aren't events
        pass


class MetricsServer:
    """Owns the HTTP server + its daemon thread.  ``close()`` to stop."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[trace.Tracer] = None):
        handler = type("Handler", (_Handler,), {
            "registry": registry or default_registry(),
            "tracer": tracer or trace.default_tracer(),
        })
        self._httpd = ThreadingHTTPServer((host, int(port)), handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True, name="repro-metrics-http",
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve_metrics(port: int = 0, host: str = "127.0.0.1") -> MetricsServer:
    """Start the metrics endpoint on ``port`` (0 = ephemeral)."""
    return MetricsServer(port=port, host=host)
