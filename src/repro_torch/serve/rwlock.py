"""Reader-writer lock for the serve path: searches share, writes exclude.

Copy of ``repro.serve.rwlock``.

One re-entrant mutex around EVERY index operation is
correct, but it put concurrent searches behind each other and behind any
in-flight write.  The LSM facades' read paths are now mutation-free under
concurrency (idempotent cache fills only; read-triggered rewrites are
suppressed on the engine path — see ``allow_rewrite`` in
``index/mutable.py``), which is exactly the invariant that lets searches
take a SHARED lock: any number of readers proceed together, while
``insert``/``delete``/seal and the maintenance snapshot + epoch swap take
the lock exclusively.

Semantics:

* **Writer preference** — a waiting writer blocks NEW readers, so a
  steady read stream cannot starve a generation-sealing insert forever.
  Re-entrant readers bypass that gate (a thread already inside a read
  section finishing its work cannot deadlock against a pending writer).
* **Re-entrant writes** — the write holder may re-acquire both the write
  and the read side (the maintenance cycle's snapshot phase calls index
  methods that themselves take the read side through engine helpers).
* **No upgrades** — acquiring the write side while holding only the read
  side raises: two upgrading readers would deadlock symmetrically, so
  the hierarchy is enforced instead of discovered.
* **Observable** — :meth:`stats` exposes acquisition counts, cumulative
  wait and write-hold times; an optional ``observer(kind, wait_ms)``
  callback lets the engine stream contention waits into the metrics
  registry (``engine_rwlock_{read,write}_wait_ms``).

The lock hierarchy this slots into (never acquire leftward while holding
rightward): engine state lock < serve READ < serve WRITE < maintenance
mutex (:mod:`repro_torch.serve.engine`).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Optional

__all__ = ["ReadWriteLock"]


class ReadWriteLock:
    """Shared/exclusive lock with writer preference and write re-entrancy."""

    def __init__(
        self, observer: Optional[Callable[[str, float], None]] = None
    ):
        self._cv = threading.Condition()
        self._readers = 0          # threads currently inside read sections
        self._writer: Optional[int] = None  # ident of the write holder
        self._write_depth = 0      # write re-entrancy (+ reads under write)
        self._pending_writers = 0  # writers queued: gates NEW readers
        self._local = threading.local()
        self._observer = observer
        # counters (under self._cv)
        self._read_acquisitions = 0
        self._write_acquisitions = 0
        self._read_wait_ms = 0.0
        self._write_wait_ms = 0.0
        self._write_held_ms = 0.0
        self._write_t0 = 0.0

    # -- read side -----------------------------------------------------------

    def acquire_read(self) -> None:
        me = threading.get_ident()
        t0 = time.perf_counter()
        with self._cv:
            if self._writer == me:
                # a read section nested under our own write: already
                # exclusive, count it as write depth so release pairs up
                self._write_depth += 1
                return
            depth = getattr(self._local, "rdepth", 0)
            if depth == 0:
                # writer preference: new readers queue behind a pending
                # writer; RE-ENTRANT readers pass (they must finish for
                # the writer to ever get in)
                while self._writer is not None or self._pending_writers:
                    self._cv.wait()
            self._readers += 1
            self._local.rdepth = depth + 1
            self._read_acquisitions += 1
            waited = 1000.0 * (time.perf_counter() - t0)
            self._read_wait_ms += waited
        if self._observer is not None:
            self._observer("read", waited)

    def release_read(self) -> None:
        me = threading.get_ident()
        with self._cv:
            if self._writer == me:
                self._write_depth -= 1
                return
            depth = getattr(self._local, "rdepth", 0)
            if depth <= 0:
                raise RuntimeError("release_read without acquire_read")
            self._local.rdepth = depth - 1
            self._readers -= 1
            if self._readers == 0:
                self._cv.notify_all()

    # -- write side ----------------------------------------------------------

    def acquire_write(self) -> None:
        me = threading.get_ident()
        t0 = time.perf_counter()
        with self._cv:
            if self._writer == me:
                self._write_depth += 1
                return
            if getattr(self._local, "rdepth", 0):
                raise RuntimeError(
                    "read->write upgrade would deadlock: release the read "
                    "section first (lock hierarchy: serve-read < serve-write)"
                )
            self._pending_writers += 1
            try:
                while self._writer is not None or self._readers:
                    self._cv.wait()
            finally:
                self._pending_writers -= 1
            self._writer = me
            self._write_depth = 1
            self._write_acquisitions += 1
            self._write_t0 = time.perf_counter()
            waited = 1000.0 * (self._write_t0 - t0)
            self._write_wait_ms += waited
        if self._observer is not None:
            self._observer("write", waited)

    def release_write(self) -> None:
        me = threading.get_ident()
        with self._cv:
            if self._writer != me:
                raise RuntimeError("release_write by a non-holder")
            self._write_depth -= 1
            if self._write_depth == 0:
                self._writer = None
                self._write_held_ms += 1000.0 * (
                    time.perf_counter() - self._write_t0
                )
                self._cv.notify_all()

    # -- context managers ----------------------------------------------------

    @contextmanager
    def read_locked(self):
        self.acquire_read()
        try:
            yield self
        finally:
            self.release_read()

    @contextmanager
    def write_locked(self):
        self.acquire_write()
        try:
            yield self
        finally:
            self.release_write()

    # -- introspection -------------------------------------------------------

    def write_held(self) -> bool:
        """True iff the CALLING thread holds the write side."""
        with self._cv:
            return self._writer == threading.get_ident()

    @property
    def readers(self) -> int:
        with self._cv:
            return self._readers

    def stats(self) -> Dict[str, float]:
        """Contention accounting (cumulative since construction)."""
        with self._cv:
            held = self._write_held_ms
            if self._writer is not None:
                held += 1000.0 * (time.perf_counter() - self._write_t0)
            return {
                "readers": float(self._readers),
                "pending_writers": float(self._pending_writers),
                "read_acquisitions": float(self._read_acquisitions),
                "write_acquisitions": float(self._write_acquisitions),
                "read_wait_ms": self._read_wait_ms,
                "write_wait_ms": self._write_wait_ms,
                "write_held_ms": held,
            }

    def __repr__(self) -> str:
        s = self.stats()
        return (
            f"ReadWriteLock(readers={int(s['readers'])}, "
            f"pending_writers={int(s['pending_writers'])}, "
            f"writer_held={self._writer is not None})"
        )
