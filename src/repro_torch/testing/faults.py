"""Deterministic, addressable fault injection points (copy of ``repro.testing.faults``).

The same plan grammar, the same point names and the same environment
variables (``REPRO_FAULTS``, ``REPRO_FAULT_TRACE``) as the JAX package, so
one crash plan drives either package.

Durability code is only trustworthy if the crashes it claims to survive
can actually be produced, at exactly the instants that matter: between a
payload write and its manifest commit, between a rename and the parent
directory fsync, mid-way through a WAL append.  This module provides
named *injection points* that production code threads through those
instants::

    from repro_torch.testing.faults import fault_point
    ...
    fault_point("ckpt.manifest.pre_rename", path=tmp_manifest)

A point is a no-op (one dict lookup) unless a *fault plan* is active, so
the call sites stay in the production path permanently — the tested
protocol IS the shipped protocol, with no test-only forks.

Fault plans
-----------
A plan maps point names to an action, armed on the point's N-th hit
(1-based, default 1).  Plans come from the environment — a subprocess
crash matrix (the JAX package's ``scripts/crash_check.py``) sets them per
child — or from :func:`install_plan` for in-process tests::

    REPRO_FAULTS="wal.append.post_write@3=kill;ckpt.manifest.pre_rename=raise"

Actions:

``raise``
    Raise :class:`FaultInjected` (an ``IOError`` subclass), as if the
    underlying syscall failed.
``kill``
    ``SIGKILL`` the current process — no atexit, no flushing, the
    closest userspace approximation of a power cut.
``torn:N``
    Truncate the point's ``path`` to ``N`` bytes, then ``SIGKILL``: a
    write that only partially reached the disk before the crash.
``bitflip``
    Flip one bit in the middle of ``path`` and *continue silently* —
    bit-rot.  Detection must come from CRCs/digests, not from errors.

Tracing
-------
With ``REPRO_FAULT_TRACE=/path`` every hit appends one ``name`` line to
the file (opened/fsynced/closed per hit so a later ``kill`` can't lose
it).  The crash matrix runs a trace pass first to enumerate the points a
workload actually exercises, then replays it once per point with a
``kill`` armed there.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Dict, Optional, Tuple

__all__ = [
    "FaultInjected", "fault_point", "install_plan", "parse_plan",
    "registered_points", "reset",
]


class FaultInjected(IOError):
    """Raised by a ``raise``-mode fault point, as if the I/O failed."""

    def __init__(self, point: str):
        super().__init__(f"fault injected at {point!r}")
        self.point = point


# {name: (hit_number, mode)} — mode is "raise" | "kill" | "torn:N" | "bitflip"
_plan: Optional[Dict[str, Tuple[int, str]]] = None
_trace_path: Optional[str] = None
_hits: Dict[str, int] = {}
_lock = threading.Lock()
_env_loaded = False


def parse_plan(spec: str) -> Dict[str, Tuple[int, str]]:
    """Parse ``"name@hit=mode;name2=mode"`` into a plan dict."""
    plan: Dict[str, Tuple[int, str]] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        name, _, mode = part.partition("=")
        name, _, hit = name.partition("@")
        mode = mode.strip() or "raise"
        if not (mode in ("raise", "kill", "bitflip")
                or mode.startswith("torn:")):
            raise ValueError(f"unknown fault mode {mode!r} in {part!r}")
        plan[name.strip()] = (int(hit) if hit else 1, mode)
    return plan


def install_plan(plan: Optional[Dict[str, Tuple[int, str]]],
                 trace_path: Optional[str] = None) -> None:
    """Arm a fault plan in-process (tests); resets hit counters."""
    global _plan, _trace_path, _env_loaded
    with _lock:
        _plan = dict(plan) if plan else None
        _trace_path = trace_path
        _hits.clear()
        _env_loaded = True     # explicit install overrides the environment


def reset() -> None:
    """Disarm any plan and forget hit counts (environment re-read next hit)."""
    global _plan, _trace_path, _env_loaded
    with _lock:
        _plan = None
        _trace_path = None
        _hits.clear()
        _env_loaded = False


def registered_points() -> Dict[str, int]:
    """``{name: hits_so_far}`` for every point hit in this process."""
    with _lock:
        return dict(_hits)


def _load_env_locked() -> None:
    global _plan, _trace_path, _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    spec = os.environ.get("REPRO_FAULTS", "")
    _plan = parse_plan(spec) if spec.strip() else None
    _trace_path = os.environ.get("REPRO_FAULT_TRACE") or None


def _flip_bit(path: str) -> None:
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if size == 0:
            return
        f.seek(size // 2)
        byte = f.read(1)
        f.seek(size // 2)
        f.write(bytes([byte[0] ^ 0x10]))


def fault_point(name: str, path: Optional[str] = None) -> None:
    """Declare a crash-consistency point; acts only under an armed plan.

    ``path`` names the file a ``torn:N``/``bitflip`` action corrupts;
    pass the file most recently written before this point.
    """
    with _lock:
        _load_env_locked()
        if _plan is None and _trace_path is None:
            return
        _hits[name] = hit = _hits.get(name, 0) + 1
        trace, plan = _trace_path, _plan
    if trace is not None:
        fd = os.open(trace, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, (name + "\n").encode())
            os.fsync(fd)
        finally:
            os.close(fd)
    if plan is None:
        return
    armed = plan.get(name)
    if armed is None or armed[0] != hit:
        return
    mode = armed[1]
    if mode == "raise":
        raise FaultInjected(name)
    if mode == "bitflip":
        if path is not None and os.path.exists(path):
            _flip_bit(path)
        return
    if mode.startswith("torn:"):
        n = int(mode.split(":", 1)[1])
        if path is not None and os.path.exists(path):
            fd = os.open(path, os.O_WRONLY)
            try:
                os.ftruncate(fd, n)
                os.fsync(fd)
            finally:
                os.close(fd)
    # torn falls through to kill: a torn write only exists because the
    # process died before completing it.
    os.kill(os.getpid(), signal.SIGKILL)
