"""Shared arithmetic of the per-layer metric files in ``bench/metrics``.

Each reader takes the traced run's context and returns a number, or
``None`` where it finds nothing to read; a device figure is ``None`` off
the card.  A roofline share is never made up as 0: without the kernels'
device time it is ``None``.
"""

from __future__ import annotations

from typing import Optional, Sequence


def idle_pct(ctx) -> Optional[float]:
    """Share of the traced unit in which no activity ran on the device."""
    if not ctx.on_card or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def launches_per(ctx) -> Optional[float]:
    """Device kernels launched in the traced unit, per query or row it served."""
    n = ctx.trace.launches() if ctx.on_card else 0
    return n / ctx.trace_count if n else None


def peak_gib(ctx) -> Optional[float]:
    """``max_memory_allocated`` over the window, reset when it opened."""
    return None if ctx.peak_bytes is None else ctx.peak_bytes / 2**30


def roofline_pct(ctx, kernels: Sequence[str], least_s: float) -> Optional[float]:
    """The least time of the work, over the device time of the named kernels."""
    t = ctx.trace.kernel_seconds(kernels) if ctx.on_card else 0.0
    return 100.0 * least_s / t if t > 0 else None
