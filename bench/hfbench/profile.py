"""One traced unit: the profiler's device activity, the program's spans, and what they give.

``traced(fn, device)`` runs ``fn`` once under ``torch.profiler`` (CPU and,
on a card, CUDA activity) inside a named annotation, with the program's
span tracer switched on, and returns a :class:`Trace`.  Nothing is written
to disk: events are read from memory and dropped.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

ANNOTATION = "hfbench.traced_unit"
_NAME_CHARS = 96


class Trace:
    """Device activities (name, start_ns, end_ns) inside the traced unit's
    annotation, host events for labelling idle gaps, and the spans."""

    def __init__(self, device_events, host_events, window: Tuple[int, int],
                 spans: List[Tuple[str, float]], wall_s: float):
        self.device_events = device_events
        self.host_events = host_events
        self.t0, self.t1 = window
        self.spans = spans
        self.wall_s = wall_s
        self.cost_s: Dict[str, float] = {}

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    @property
    def busy_s(self) -> float:
        """Seconds in which some activity ran on the device (intervals merged)."""
        return sum(e - s for s, e in self._merged()) * 1e-9

    def _merged(self) -> List[Tuple[int, int]]:
        iv = sorted((max(s, self.t0), min(e, self.t1)) for _, s, e in self.device_events
                    if e > self.t0 and s < self.t1)
        out: List[List[int]] = []
        for s, e in iv:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def kernels(self) -> List[Tuple[str, int, int]]:
        return [ev for ev in self.device_events
                if not ev[0].startswith(("Memcpy", "Memset"))]

    def kernel_seconds(self, names: Sequence[str]) -> float:
        """Summed device seconds of kernels whose name contains any of ``names``."""
        return sum(e - s for n, s, e in self.kernels()
                   if any(k in n for k in names)) * 1e-9

    def launches(self) -> int:
        return len(self.kernels())

    def span_seconds(self, prefix: str) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, sec in self.spans:
            if name.startswith(prefix):
                out[name] = out.get(name, 0.0) + sec
        return out

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the idle time
        between device activities summed by the innermost host event open at
        the middle of each gap ("python" where none was)."""
        by_op: Dict[str, int] = {}
        for n, s, e in self.device_events:
            key = n[:_NAME_CHARS]
            by_op[key] = by_op.get(key, 0) + (e - s)
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        merged = self._merged()
        edges = [self.t0] + [x for iv in merged for x in iv] + [self.t1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        return {"device_ops": [[n, v * 1e-9] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in self._label_gaps(gaps)[:top]]}

    def _label_gaps(self, gaps) -> List[Tuple[str, float]]:
        if not gaps:
            return []
        hs = sorted(self.host_events, key=lambda ev: ev[1])
        starts = np.array([s for _, s, _ in hs], dtype=np.int64)
        ends = np.array([e for _, _, e in hs], dtype=np.int64)
        mids = np.array([(a + b) // 2 for a, b in gaps], dtype=np.int64)
        secs = np.array([(b - a) * 1e-9 for a, b in gaps])
        label = np.full(len(gaps), -1, dtype=np.int64)
        idx = np.searchsorted(starts, mids, side="right") - 1
        open_ = np.ones(len(gaps), dtype=bool)
        for step in range(64):  # innermost open event: latest start still running
            j = idx - step
            ok = open_ & (j >= 0)
            hit = ok.copy()
            hit[ok] = ends[j[ok]] >= mids[ok]
            label[hit] = j[hit]
            open_ &= ~hit
            if not open_.any():
                break
        totals: Dict[str, float] = {}
        for lab, sec in zip(label, secs):
            name = "python" if lab < 0 else hs[lab][0][:_NAME_CHARS]
            totals[name] = totals.get(name, 0.0) + float(sec)
        return sorted(totals.items(), key=lambda kv: -kv[1])


def traced(fn: Callable[[], object], device: torch.device, tracer=None) -> Trace:
    """Run ``fn()`` once under the profiler; ``tracer`` (the program's span
    tracer, optional) is switched on for the call and its spans read.  The
    returned trace's ``cost_s`` holds the seconds the profiler's stop and the
    reading of its events took, apart from the traced call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    if tracer is not None:
        tracer.clear()
        tracer.enabled = True
    try:
        with profile(activities=acts) as prof:
            with record_function(ANNOTATION):
                t = time.perf_counter()
                fn()
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                wall = time.perf_counter() - t
            t_stop = time.perf_counter()
    finally:
        if tracer is not None:
            tracer.enabled = False
    t_read = time.perf_counter()
    spans = [] if tracer is None else [(s.name, (s.wall_ms or 0.0) * 1e-3)
                                       for s in tracer.spans()]
    dev_ev, host_ev = [], []
    window: Optional[Tuple[int, int]] = None
    cuda = DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if name == ANNOTATION:
            if ev.device_type() != cuda:
                window = (ev.start_ns(), ev.end_ns())
            continue
        (dev_ev if ev.device_type() == cuda else host_ev).append(
            (name, ev.start_ns(), ev.end_ns()))
    del prof
    if window is None:
        raise RuntimeError("the profiler recorded no annotation around the traced unit")
    out = Trace(dev_ev, host_ev, window, spans, wall)
    out.cost_s = {"stop": t_read - t_stop, "read": time.perf_counter() - t_read,
                  "events": len(dev_ev) + len(host_ev)}
    return out
