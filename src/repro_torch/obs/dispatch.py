"""Dispatch and kernel-build accounting for every instrumented entry point.

Port of ``repro.obs.dispatch``, with the same names, series and blocks:

* ``index_dispatches_total{site=...}`` — one per scoped call;
* ``index_recompiles_total{site=...}`` — how many of those calls
  triggered a compile event on the calling thread.

``repro`` counts XLA backend compiles through a ``jax.monitoring``
listener.  Eager torch compiles nothing per call; the port's compile
events are the kernel-library builds and loads of
:mod:`repro_torch.kernels._build`: one event per ``nvcc`` compile
(``build``) and one per first load of a library into the process
(``library``).  ``_build`` reports them through :func:`record_compile`,
on the thread that triggered them, so :func:`dispatch_scope` attributes
them to the site that thread is dispatching — the engine's maintenance
thread and its serve threads never mix deltas.  "No recompile in steady
state" then reads "no kernel build or load after warm-up".

Usage at a call site::

    with dispatch_scope("hilbert.search"):
        ids, dists = self._search_chunk(...)

The scope is ~two counter bumps; sites stay instrumented unconditionally.
``compiles_total()`` is the process-wide event count (warm-up included),
and the gauge ``index_last_dispatch_recompiled`` is 1 exactly when the
most recent scoped dispatch anywhere in the process compiled.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, Iterator

from .registry import default_registry

__all__ = [
    "record_compile", "compiles_total",
    "dispatch_scope", "dispatch_counts", "recompile_counts",
    "accounting_snapshot", "accounting_delta",
]

_tls = threading.local()
_lock = threading.Lock()
_global_compiles = [0]          # guarded by _lock


def record_compile() -> None:
    """One compile event (a kernel library built or loaded) on this thread."""
    with _lock:
        _global_compiles[0] += 1
    _tls.compiles = getattr(_tls, "compiles", 0) + 1


def compiles_total() -> int:
    """Process-wide kernel-library builds and loads so far."""
    with _lock:
        return _global_compiles[0]


@contextmanager
def dispatch_scope(site: str) -> Iterator[None]:
    """Count one dispatch at ``site``; flag it if it compiled.

    Attribution is by thread-local compile delta across the body, so
    concurrent scopes in other threads (serve vs. maintenance) don't
    steal or leak each other's compiles.  Nested scopes both observe a
    compile that happens in the innermost body.
    """
    reg = default_registry()
    reg.counter("index_dispatches_total", site=site).inc()
    # Created at the site's first dispatch, so a scrape reads an explicit
    # 0 where ``repro`` (whose first dispatch always compiles) shows a 1.
    recompiles = reg.counter("index_recompiles_total", site=site)
    before = getattr(_tls, "compiles", 0)
    try:
        yield
    finally:
        delta = getattr(_tls, "compiles", 0) - before
        gauge = reg.gauge("index_last_dispatch_recompiled")
        if delta > 0:
            # One scoped dispatch = at most one recompile tick, however
            # many libraries it built or loaded.
            recompiles.inc()
            gauge.set(1.0)
        else:
            gauge.set(0.0)


def _by_site(name: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for key, val in default_registry().snapshot().items():
        if key.startswith(name + "{"):
            site = key.split('site="', 1)[1].split('"', 1)[0]
            out[site] = int(val)
    return out


def dispatch_counts() -> Dict[str, int]:
    """``{site: dispatches}`` for every instrumented site so far."""
    return _by_site("index_dispatches_total")


def recompile_counts() -> Dict[str, int]:
    """``{site: recompiles}`` for every instrumented site so far (0 for
    sites that never compiled)."""
    return _by_site("index_recompiles_total")


def accounting_snapshot() -> Dict[str, object]:
    """The dispatch/compile accounting as one JSON-able block."""
    return {
        "dispatches_by_site": dispatch_counts(),
        "recompiles_by_site": recompile_counts(),
        "backend_compiles_total": compiles_total(),
    }


def accounting_delta(
    before: Dict[str, object], after: Dict[str, object]
) -> Dict[str, object]:
    """Per-site difference of two :func:`accounting_snapshot` blocks.

    Sites absent from ``before`` count from zero; zero deltas are dropped.
    """

    def diff(name: str) -> Dict[str, int]:
        b = before.get(name, {}) or {}
        a = after.get(name, {}) or {}
        out = {
            site: int(n) - int(b.get(site, 0)) for site, n in a.items()
        }
        return {site: n for site, n in out.items() if n}

    return {
        "dispatches_by_site": diff("dispatches_by_site"),
        "recompiles_by_site": diff("recompiles_by_site"),
        "backend_compiles_total": (
            int(after.get("backend_compiles_total", 0))
            - int(before.get("backend_compiles_total", 0))
        ),
    }
