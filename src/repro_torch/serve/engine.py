"""Async retrieval serving engine: admission, micro-batching, background
maintenance with double-buffered index swap.

Port of ``repro.serve.engine`` over the port's indexes
(:class:`~repro_torch.index.HilbertIndex`,
:class:`~repro_torch.index.MutableHilbertIndex` and the sharded
:class:`~repro_torch.index.ShardedMutableHilbertIndex`), with the same
protocol, metrics, spans and fault points.  Searches run on the index's
device through the kernel wrappers (``backend="kernel"``); each batch's
results are copied to the host INSIDE the shared read lock, so the
epoch drain that a swap waits for is also a device drain: once the old
epoch's refcount reaches zero, no queued kernel still reads its segment
tensors.  The shadow compaction runs on the same device and stream as
serving (a side stream would need ``record_stream`` on every tensor that
``snapshot()`` shares).

The index family is fast per call, but a production deployment is a
*request stream*, not an array: callers arrive raggedly, LSM maintenance
(tier merges, the multi-second full ``compact()``) must never run on the
query path, and the dispatch shapes must stay bounded by construction.
``RetrievalEngine`` is that serving loop, layered over ANY index layout
(plain / mutable / sharded / sharded-mutable — anything with
``search(queries, params, backend=, query_chunk=)``):

* **Admission + EDF micro-batching** — :meth:`submit` places a request
  in a BOUNDED queue (backpressure: ``block=False`` raises
  :class:`QueueFull` when the deployment is saturated, instead of
  unbounded memory growth).  The serve loop forms micro-batches
  earliest-deadline-first (the pure
  :func:`repro_torch.serve.batching.form_batch` — deadline-less tickets age
  under a fairness horizon, so nothing starves) of up to ``max_batch``
  rows sharing one :class:`SearchParams`, concatenates them into one
  search, and splits results back per request.  Batches cap at the
  facade's ``query_chunk``, whose pow2 bucket padding then bounds the
  distinct shapes a search sees at ``log2(query_chunk)+1``.
* **Pipelined retrieval** — multi-chunk batches run through
  :func:`repro_torch.serve.pipeline.pipelined_search`: host staging of
  chunk *i+1* overlaps device execution of chunk *i* (double-buffered
  pinned copies), bit-identical to a direct ``index.search``.
* **Background maintenance + atomic swap** — a maintainer thread watches
  :meth:`maintenance_stats` (generation count, tombstone ratio).  When a
  threshold trips it snapshots the serving index (cheap: sealed segments
  are shared, only buffers/bookkeeping copy), runs the expensive
  ``compact()`` on that SHADOW off the query path, replays the writes that
  arrived meanwhile (id assignment is sequential and deterministic, so
  replayed inserts receive identical external ids), and atomically swaps
  the serving pointer.  An epoch/refcount guard lets in-flight batches
  finish on the OLD index — their results stay bit-equal to a direct
  search on the index version that admitted them — and the swap waits for
  the old epoch's refcount to drain before retiring it.

Determinism for tests: construct with ``start=False`` and drive
:meth:`step` / :meth:`maintain_once` by hand — no threads, same code path
(the serve loop calls exactly these).
"""

from __future__ import annotations

import dataclasses
import itertools
import shutil
import subprocess
import tempfile
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.wal import WalWriteError
from repro_torch.core.types import SearchParams
from repro_torch.index.facade import _pow2_bucket
from repro_torch.index.mutable import _host
from repro_torch.obs.recall import RecallProbe, RecallProbeConfig
from repro_torch.obs.registry import default_registry
from repro_torch.obs.trace import span
from repro_torch.serve.batching import form_batch
from repro_torch.serve.compactor import CompactionChildError, compact_in_child
from repro_torch.serve.metrics import EngineMetrics
from repro_torch.serve.pipeline import pipelined_search
from repro_torch.serve.rwlock import ReadWriteLock
from repro_torch.testing.faults import fault_point

__all__ = [
    "CompactionChildError",
    "DeadlineExceeded",
    "EngineClosed",
    "EngineDegraded",
    "MaintenancePolicy",
    "MaintenanceTimeout",
    "QueueFull",
    "RetrievalEngine",
    "SearchTicket",
]


class QueueFull(RuntimeError):
    """Admission queue at capacity: the deployment is saturated (shed load)."""


class EngineClosed(RuntimeError):
    """The engine stopped admitting requests (shutdown in progress/done)."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed while it waited in the queue.

    Expired tickets are dropped at batch-formation time — BEFORE any
    device dispatch — so a saturated deployment sheds stale work instead
    of burning compute on answers nobody is waiting for anymore.
    """


class EngineDegraded(RuntimeError):
    """Writes are refused: the engine is in degraded read-only mode.

    Entered when the index's write-ahead log becomes unwritable
    (:class:`~repro_torch.checkpoint.wal.WalWriteError`): acknowledging writes
    without a durable log would silently reintroduce the crash-loss
    window, so writes fail fast with this error while searches keep
    serving.  ``/healthz`` flips to 503 via the ``engine_degraded``
    gauge; :meth:`RetrievalEngine.reset_degraded` re-admits writes after
    the operator fixes the disk.
    """


class MaintenanceTimeout(RuntimeError):
    """The shadow compact outran the watchdog; the shadow was abandoned."""


@dataclasses.dataclass(frozen=True)
class MaintenancePolicy:
    """When the background maintainer acts, and how often it looks.

    A full ``compact()`` triggers when EITHER threshold trips:
    ``max_segments`` bounds the per-query fan-out cost (every sealed
    generation is an extra search stage), ``max_tombstone_ratio`` bounds wasted
    candidate-pool slots (each segment's k is inflated by its dead count).

    ``max_cycle_s`` is the watchdog: a shadow ``compact()`` that has not
    finished within it is abandoned (the serving index was never touched,
    so nothing is lost but the shadow's work) and the cycle fails with
    :class:`MaintenanceTimeout`.  The maintainer thread then backs off
    exponentially from ``backoff_initial_s`` doubling to at most
    ``backoff_max_s`` between failed cycles, so a persistently failing
    compact (bad disk, poisoned segment) cannot hot-loop the maintainer
    while serving continues.
    """

    max_segments: int = 4          # sealed segments/generations before compact
    max_tombstone_ratio: float = 0.25  # dead/allocated ids before compact
    poll_interval_s: float = 0.05  # maintainer wake period
    max_cycle_s: Optional[float] = 300.0  # shadow-compact watchdog (None=off)
    backoff_initial_s: float = 0.25      # first post-failure delay
    backoff_max_s: float = 30.0          # backoff cap

    def triggered(self, stats: Dict[str, Any]) -> bool:
        if stats.get("n_live", 0) == 0:
            return False
        if stats.get("mergeable_segments", 0) < 1:
            return False  # store_points=False: nothing can be re-sorted
        # rewrite_pressure: segments tombstoned past their candidate pool.
        # The facades used to rewrite these INSIDE search(); the engine's
        # shared-read-lock path suppresses that (reads must not mutate),
        # so the same condition triggers maintenance here instead.
        return (
            int(stats.get("n_segments", 0)) > self.max_segments
            or float(stats.get("tombstone_ratio", 0.0))
            > self.max_tombstone_ratio
            or int(stats.get("rewrite_pressure", 0)) > 0
        )


class SearchTicket:
    """A submitted request's handle: blocks on :meth:`result`.

    ``epoch`` records which index version served the batch (filled at
    completion) — the engine's bit-equality contract is against a direct
    ``search`` on THAT version.  The lifecycle timestamps split a
    request's latency into its operational phases: ``submitted_at`` →
    ``batched_at`` (queue wait) → ``completed_at`` (execution + merge).

    ``deadline`` (a ``time.monotonic()`` instant, or None) marks when the
    caller stops caring: a ticket still queued past it is failed with
    :class:`DeadlineExceeded` at batch-formation time instead of being
    dispatched.  ``submitted_mono`` (same clock) plus ``seq`` (global
    admission order) are what the EDF batcher
    (:func:`repro_torch.serve.batching.form_batch`) schedules on: deadline-less
    tickets age from ``submitted_mono``, and ``seq`` breaks deadline
    ties deterministically.
    """

    _seq_counter = itertools.count()

    def __init__(self, queries: np.ndarray, params: SearchParams,
                 deadline: Optional[float] = None,
                 seq: Optional[int] = None):
        self.queries = queries
        self.params = params
        self.deadline = deadline
        self.seq = next(self._seq_counter) if seq is None else seq
        self.submitted_mono = time.monotonic()
        self.submitted_at = time.perf_counter()
        self.batched_at: Optional[float] = None
        self.completed_at: Optional[float] = None
        self.epoch: Optional[int] = None
        self.ids: Optional[np.ndarray] = None
        self.dists: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self._done = threading.Event()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def expired(self) -> bool:
        return self.deadline is not None and time.monotonic() > self.deadline

    @property
    def latency_ms(self) -> Optional[float]:
        if self.completed_at is None:
            return None
        return 1000.0 * (self.completed_at - self.submitted_at)

    @property
    def queue_wait_ms(self) -> Optional[float]:
        """Admission → batch-formation wait (None until batched)."""
        if self.batched_at is None:
            return None
        return 1000.0 * (self.batched_at - self.submitted_at)

    def result(
        self, timeout: Optional[float] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(ids (m, k), sq-dists (m, k)) — blocks until served.

        Raises ``TimeoutError`` if not served in ``timeout`` seconds, or
        re-raises the serve-side exception (e.g. :class:`EngineClosed` for
        requests failed by a non-draining shutdown).
        """
        if not self._done.wait(timeout):
            raise TimeoutError("search request not served in time")
        if self.error is not None:
            raise self.error
        return self.ids, self.dists

    def _complete(self, ids, dists, epoch) -> None:
        self.ids, self.dists, self.epoch = ids, dists, epoch
        self.completed_at = time.perf_counter()
        self._done.set()

    def _fail(self, err: BaseException) -> None:
        self.error = err
        self.completed_at = time.perf_counter()
        self._done.set()


class _Epoch:
    """One serving-index version with a refcount of in-flight batches."""

    def __init__(self, index, epoch: int):
        self.index = index
        self.epoch = epoch
        self.refs = 0
        self._cv = threading.Condition()

    def checkout(self) -> None:
        with self._cv:
            self.refs += 1

    def checkin(self) -> None:
        with self._cv:
            self.refs -= 1
            self._cv.notify_all()

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        with self._cv:
            return self._cv.wait_for(lambda: self.refs == 0, timeout)


class RetrievalEngine:
    """The async serving loop over one index (any layout).

    Args:
      index: the serving index.  The mutable layouts
        (:class:`~repro_torch.index.MutableHilbertIndex`,
        :class:`~repro_torch.index.ShardedMutableHilbertIndex`)
        additionally get :meth:`insert`/:meth:`delete` routing and
        background maintenance; the static layout serves read-only.
      params: default :class:`SearchParams` for requests that don't carry
        their own.
      max_queue: admission-queue capacity in REQUESTS (backpressure bound).
      max_batch: micro-batch cap in query ROWS (default: the index
        config's ``query_chunk`` — one fused dispatch per batch).
      backend: kernel routing passed through to every search:
        ``"kernel"`` (the kernel wrappers — CUDA kernels for a CUDA index)
        or ``"ref"`` (their plain versions).
      pipeline: double-buffer chunk staging for multi-chunk batches
        (:func:`~repro_torch.serve.pipeline.pipelined_search`).
      maintenance: background-maintenance thresholds; ``None`` disables
        the maintainer thread (maintenance can still be driven manually
        via :meth:`maintain_once`).
      recall: online recall probing — a
        :class:`~repro_torch.obs.recall.RecallProbeConfig` (or a ready
        :class:`~repro_torch.obs.recall.RecallProbe`) samples served batches
        and scores them against an exact shadow OFF the query path: the
        maintainer thread scores between cycles, or call
        :meth:`score_recall` in step mode.  ``None`` (default) disables
        probing entirely.
      compaction: where the shadow ``compact()`` runs.  ``"thread"``
        (default) compacts on a helper thread inside this process;
        ``"subprocess"`` hands the snapshot to a CHILD process on the
        index's device via the format_version-5 bundles
        (:mod:`repro_torch.serve.compactor`) so maintenance never touches
        the serving process's GIL — the child saves, the parent verifies
        and reloads, and the existing replay + swap protocol continues
        unchanged.
      compaction_dir: workdir for subprocess compaction bundles
        (default: a fresh temp dir per cycle, removed afterwards).
      edf_horizon_s: fairness horizon for deadline-less requests — their
        effective deadline is submission + this, which bounds how long a
        stream of urgent arrivals can delay them (see
        :mod:`repro_torch.serve.batching`).
      serve_threads: number of serve-loop workers.  More than one lets
        micro-batches proceed concurrently under the shared read lock:
        one forms, splits and probes its batch on the host while another
        searches.  The searches themselves launch one at a time: every
        torch op releases and retakes the GIL, so two threads launching
        the ~20,000 small kernels of a search at once hand the GIL back
        and forth on each op.  Results stay per-ticket deterministic
        regardless.
      start: spawn the serve (+ maintainer) threads immediately.  With
        ``start=False`` the engine is in deterministic step mode: drive
        :meth:`step` and :meth:`maintain_once` by hand.

    Index access takes a READER-WRITER lock: searches (and other pure
    reads) share it, while ``insert``/``delete``, the maintenance
    snapshot and the epoch swap hold it exclusively — possible because
    the facades' read paths are mutation-free under concurrency (the
    engine searches with ``allow_rewrite=False``; lazy caches are
    idempotent fills).  The expensive shadow ``compact()`` runs with NO
    lock held (in-thread or in a child process — that is the whole
    point).  Lock hierarchy: state lock < serve-read < serve-write <
    maintenance mutex (< launch lock, held around one batch search).
    Used as a context manager, ``__exit__`` performs a draining
    :meth:`stop`.
    """

    def __init__(
        self,
        index,
        params: Optional[SearchParams] = None,
        *,
        max_queue: int = 256,
        max_batch: Optional[int] = None,
        backend: str = "kernel",
        pipeline: bool = True,
        maintenance: Optional[MaintenancePolicy] = MaintenancePolicy(),
        recall: Optional[Any] = None,
        default_deadline_ms: Optional[float] = None,
        compaction: str = "thread",
        compaction_dir: Optional[str] = None,
        edf_horizon_s: float = 60.0,
        serve_threads: int = 1,
        start: bool = False,
    ):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if default_deadline_ms is not None and default_deadline_ms <= 0:
            raise ValueError(
                f"default_deadline_ms must be > 0, got {default_deadline_ms}"
            )
        if compaction not in ("thread", "subprocess"):
            raise ValueError(
                f"compaction must be 'thread' or 'subprocess', "
                f"got {compaction!r}"
            )
        if serve_threads < 1:
            raise ValueError(
                f"serve_threads must be >= 1, got {serve_threads}"
            )
        if edf_horizon_s <= 0:
            raise ValueError(
                f"edf_horizon_s must be > 0, got {edf_horizon_s}"
            )
        self.params = params or SearchParams()
        self.default_deadline_ms = default_deadline_ms
        self.backend = backend
        self.pipeline = pipeline
        self.max_queue = int(max_queue)
        chunk = getattr(getattr(index, "config", None), "query_chunk", 1024)
        self.max_batch = int(max_batch or chunk)
        self.query_chunk = min(chunk, self.max_batch)
        self.maintenance = maintenance
        self.metrics = EngineMetrics()
        if recall is None:
            self.recall_probe: Optional[RecallProbe] = None
        elif isinstance(recall, RecallProbe):
            self.recall_probe = recall
        elif isinstance(recall, RecallProbeConfig):
            self.recall_probe = RecallProbe(recall)
        else:
            raise TypeError(
                "recall must be a RecallProbeConfig or RecallProbe, got "
                f"{type(recall).__name__}"
            )
        self.compaction = compaction
        self.compaction_dir = compaction_dir
        self.edf_horizon_s = float(edf_horizon_s)
        self.serve_threads = int(serve_threads)
        # engine reads must not trigger segment rewrites: searches run
        # under the SHARED lock side, so mutation is off the read path
        # (the rewrite condition surfaces as maintenance `rewrite_pressure`)
        self._search_kwargs = (
            {"allow_rewrite": False}
            if hasattr(index, "rewrite_pressure") else {}
        )
        self.last_swap_timeline: Optional[Dict[str, Any]] = None
        self._register_gauges()

        # Lock hierarchy (acquire left-to-right only):
        #   _state_lock < serve-read < serve-write < _maint_lock
        # (_launch_lock is taken before serve-read, never while holding it)
        self._state_lock = threading.Lock()   # epoch pointer + write log
        reg = default_registry()
        _rw_read = reg.latency("engine_rwlock_read_wait_ms", capacity=4096)
        _rw_write = reg.latency("engine_rwlock_write_wait_ms", capacity=4096)
        self._serve_lock = ReadWriteLock(     # searches share, writes exclude
            observer=lambda kind, ms: (
                _rw_write if kind == "write" else _rw_read
            ).record(ms)
        )
        self._maint_lock = threading.Lock()   # one maintenance cycle at a time
        self._launch_lock = threading.Lock()  # one batch search launches at a time
        # one representative batch per (params, pow2 dispatch bucket) seen,
        # so maintenance pre-warms the shadow for EVERY bucket live traffic
        # uses: eager torch compiles nothing, but the warm search sizes the
        # caching allocator for the new segments before the swap.  Bounded
        # by construction: at most log2(query_chunk)+1 buckets per distinct
        # SearchParams.
        self._warm_queries: Dict[
            Tuple[SearchParams, int], np.ndarray
        ] = {}
        self._current = _Epoch(index, 0)
        self._write_log: Optional[List[Tuple[str, Any, Any]]] = None

        self._cv = threading.Condition()
        self._pending: Deque[SearchTicket] = deque()
        self._closed = False
        self._workers: List[threading.Thread] = []
        self._maintainer: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self.last_maintenance_error: Optional[BaseException] = None
        self._degraded_reason: Optional[str] = None
        if start:
            self.start()

    def _register_gauges(self) -> None:
        """Bind the ``engine_*`` callback gauges to THIS engine.

        Callback gauges read live state at scrape time — no write on the
        serving path.  Bound through a weakref so the process-global
        registry never keeps a stopped engine alive; a dead engine's
        gauges read ``nan`` until the next engine re-binds them.
        """
        import weakref

        wr = weakref.ref(self)
        reg = default_registry()

        def stat(key: str, default: float = 0.0):
            def read() -> float:
                eng = wr()
                if eng is None:
                    return float("nan")
                return float(eng.maintenance_stats().get(key, default))
            return read

        def attr(fn):
            def read() -> float:
                eng = wr()
                return float("nan") if eng is None else float(fn(eng))
            return read

        reg.gauge("engine_queue_depth", fn=attr(lambda e: e.queue_depth))
        reg.gauge("engine_epoch", fn=attr(lambda e: e.epoch))
        reg.gauge("engine_segments", fn=stat("n_segments"))
        reg.gauge("engine_tombstone_ratio", fn=stat("tombstone_ratio"))
        reg.gauge("engine_live_rows", fn=stat("n_live"))
        reg.gauge("engine_buffered_rows", fn=stat("n_buffered"))

        def buffer_fill() -> float:
            eng = wr()
            if eng is None:
                return float("nan")
            cap = getattr(eng.index, "buffer_capacity", 0)
            if not cap:
                return 0.0
            return float(eng.maintenance_stats().get("n_buffered", 0)) / cap

        reg.gauge("engine_buffer_fill", fn=buffer_fill)
        reg.gauge(
            "engine_degraded",
            fn=attr(lambda e: 1.0 if e._degraded_reason else 0.0),
        )

        def lock_stat(key: str):
            def read() -> float:
                eng = wr()
                lock = getattr(eng, "_serve_lock", None)
                if lock is None:
                    return float("nan")
                return float(lock.stats().get(key, 0.0))
            return read

        # rw-lock contention: live reader count, queued writers, and the
        # cumulative exclusive-hold time (how long writes/swaps actually
        # kept readers out)
        reg.gauge("engine_rwlock_readers", fn=lock_stat("readers"))
        reg.gauge("engine_rwlock_pending_writers",
                  fn=lock_stat("pending_writers"))
        reg.gauge("engine_rwlock_write_held_ms",
                  fn=lock_stat("write_held_ms"))

    # -- introspection -------------------------------------------------------

    @property
    def index(self):
        """The CURRENT serving index (the pointer a swap replaces)."""
        with self._state_lock:
            return self._current.index

    @property
    def epoch(self) -> int:
        """Bumps by one on every background swap."""
        with self._state_lock:
            return self._current.epoch

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return len(self._pending)

    @property
    def running(self) -> bool:
        return any(w.is_alive() for w in self._workers)

    @property
    def degraded(self) -> bool:
        """True when writes are refused (WAL unwritable); reads still serve."""
        return self._degraded_reason is not None

    @property
    def degraded_reason(self) -> Optional[str]:
        return self._degraded_reason

    def reset_degraded(self) -> None:
        """Re-admit writes after the operator has fixed the WAL's disk.

        The next write that fails to log re-enters degraded mode, so
        resetting without fixing the underlying fault is safe — just
        noisy.
        """
        self._degraded_reason = None

    def _enter_degraded(self, reason: str) -> None:
        self._degraded_reason = reason
        self.metrics.bump("degraded_entered")

    # -- admission -----------------------------------------------------------

    def submit(
        self,
        queries,
        params: Optional[SearchParams] = None,
        *,
        block: bool = True,
        timeout: Optional[float] = None,
        deadline_ms: Optional[float] = None,
    ) -> SearchTicket:
        """Admit one request ((m, d) queries) into the bounded queue.

        Returns a :class:`SearchTicket`; ``block=False`` raises
        :class:`QueueFull` instead of waiting for space, and a closed
        engine raises :class:`EngineClosed` (both count as rejections in
        the metrics).

        ``deadline_ms`` (default: the engine's ``default_deadline_ms``)
        bounds how long the ticket may WAIT: if it is still queued when
        the deadline passes it fails with :class:`DeadlineExceeded`
        instead of being dispatched.  A batch already executing is never
        aborted — the deadline sheds queue backlog, not in-flight work.
        """
        q = np.asarray(_host(queries), np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        req_deadline = (
            None if deadline_ms is None
            else time.monotonic() + deadline_ms / 1000.0
        )
        ticket = SearchTicket(q, params or self.params, deadline=req_deadline)
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while True:
                if self._closed:
                    self.metrics.bump("rejected")
                    raise EngineClosed("engine is shut down")
                if len(self._pending) < self.max_queue:
                    break
                if not block:
                    self.metrics.bump("rejected")
                    raise QueueFull(
                        f"admission queue at capacity ({self.max_queue})"
                    )
                if deadline is None:
                    self._cv.wait()
                    continue
                # wait against a fixed deadline: wakeups where another
                # submitter won the freed slot must not restart the clock
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self.metrics.bump("rejected")
                    raise QueueFull(
                        f"admission queue still full after {timeout}s"
                    )
                self._cv.wait(remaining)
            self._pending.append(ticket)
            self.metrics.bump("admitted")
            self._cv.notify_all()
        return ticket

    def search(
        self,
        queries,
        params: Optional[SearchParams] = None,
        *,
        timeout: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Synchronous convenience: submit and wait for the result.

        In step mode (no serve thread) the calling thread pumps
        :meth:`step` itself, so results are produced deterministically with
        zero background threads — the mode the bit-equality tests drive.
        """
        ticket = self.submit(queries, params, timeout=timeout)
        if not self.running:
            while not ticket.done:
                if self.step() == 0 and not ticket.done:
                    raise RuntimeError(
                        "step() made no progress on a pending ticket"
                    )
            return ticket.result(0)
        return ticket.result(timeout)

    # -- writes (routed so the maintainer can log + replay them) -------------

    def insert(self, points, values=None) -> np.ndarray:
        """Stream rows into the serving index; returns stable external ids.

        While a shadow compaction is in flight the write is ALSO appended
        to the replay log: id assignment is sequential, so replaying the
        log on the shadow reproduces identical external ids.

        Raises :class:`EngineDegraded` (fast, before touching the index)
        when the engine is in degraded read-only mode, and ENTERS that
        mode if this write's WAL append fails.

        Writes hold the serve lock EXCLUSIVELY: in-flight searches finish
        first (they share the read side), and no search observes a
        half-applied insert or a mid-seal segment list.
        """
        with self._serve_lock.write_locked():
            index = self.index
            if not hasattr(index, "insert"):
                raise TypeError(
                    f"{type(index).__name__} is immutable — the engine "
                    "serves it read-only"
                )
            self._check_writable()
            pts = np.asarray(_host(points), np.float32)
            vals = None if values is None else np.array(_host(values))
            try:
                ids = index.insert(pts, vals)
            except WalWriteError as e:
                self._enter_degraded(str(e))
                raise EngineDegraded(
                    f"write-ahead log unwritable, write refused: {e}"
                ) from e
            with self._state_lock:
                if self._write_log is not None:
                    self._write_log.append(("insert", pts.copy(), vals))
            self.metrics.bump("inserts", int(np.atleast_1d(ids).shape[0]))
            return ids

    def delete(self, ids) -> int:
        """Tombstone external ids on the serving index (logged like insert)."""
        with self._serve_lock.write_locked():
            index = self.index
            if not hasattr(index, "delete"):
                raise TypeError(
                    f"{type(index).__name__} is immutable — the engine "
                    "serves it read-only"
                )
            self._check_writable()
            idn = np.array(_host(ids))
            try:
                n = index.delete(idn)
            except WalWriteError as e:
                self._enter_degraded(str(e))
                raise EngineDegraded(
                    f"write-ahead log unwritable, write refused: {e}"
                ) from e
            with self._state_lock:
                if self._write_log is not None:
                    self._write_log.append(("delete", idn, None))
            self.metrics.bump("deletes", int(n))
            return n

    def _check_writable(self) -> None:
        if self._degraded_reason is not None:
            self.metrics.bump("writes_rejected_degraded")
            raise EngineDegraded(
                "engine is in degraded read-only mode: "
                + self._degraded_reason
            )

    def values_at(self, ids, fill=0):
        """Per-point payload gather on the serving index (kNN-LM tokens).

        A pure read: shares the lock with searches, excludes writes.
        """
        with self._serve_lock.read_locked():
            return self.index.values_at(ids, fill=fill)

    # -- the serve loop ------------------------------------------------------

    def _take_batch_locked(self) -> List[SearchTicket]:
        """Form the next micro-batch earliest-deadline-first.

        Caller holds ``self._cv``.  Scheduling policy lives in the pure
        :func:`repro_torch.serve.batching.form_batch` (the property-tested
        piece); this method owns the side effects: expired tickets are
        failed with :class:`DeadlineExceeded` BEFORE any dispatch, taken
        + shed tickets leave the queue, and submitters blocked on a full
        queue are woken.
        """
        plan = form_batch(
            self._pending,
            max_rows=self.max_batch,
            now=time.monotonic(),
            no_deadline_horizon=self.edf_horizon_s,
        )
        if not plan.batch and not plan.expired:
            return []
        taken = {id(t) for t in plan.batch} | {id(t) for t in plan.expired}
        self._pending = deque(
            t for t in self._pending if id(t) not in taken
        )
        for t in plan.expired:
            # shed BEFORE dispatch: stale work is dropped, not served
            t._fail(DeadlineExceeded(
                "request deadline passed while queued"
            ))
            self.metrics.bump("deadline_expired")
        self._cv.notify_all()  # wake submitters blocked on a full queue
        return list(plan.batch)

    def _execute(self, batch: List[SearchTicket]) -> None:
        with self._state_lock:
            ref = self._current
            ref.checkout()
        now = time.perf_counter()
        for t in batch:
            t.batched_at = now
            self.metrics.queue_wait.record(1000.0 * (now - t.submitted_at))
        try:
            q = np.concatenate([t.queries for t in batch])
            params = batch[0].params
            with span("engine.batch", requests=len(batch),
                      rows=int(q.shape[0]), epoch=ref.epoch):
                m = min(q.shape[0], self.query_chunk)
                warm_key = (params, _pow2_bucket(m, self.query_chunk))
                with self._state_lock:
                    if warm_key not in self._warm_queries:
                        # retained so maintenance can pre-warm the shadow
                        # for every dispatch bucket the live traffic has hit
                        # (state-locked: serve workers run this concurrently)
                        self._warm_queries[warm_key] = q[:m].copy()
                # The launch lock is taken BEFORE the shared side: a serve
                # thread waiting for its turn holds nothing, so a write,
                # snapshot or swap waits for the one search in flight.
                with self._launch_lock, self._serve_lock.read_locked():
                    # SHARED side: concurrent batches (serve_threads > 1)
                    # hold it together; writes/snapshot/swap exclude us.
                    # Timed inside the locks: batch_latency is the search
                    # execution itself; queue + lock wait shows up in the
                    # per-ticket latency instead
                    t0 = time.perf_counter()
                    with span("engine.search", rows=int(q.shape[0])):
                        if self.pipeline:
                            ids, dists = pipelined_search(
                                ref.index, q, params, backend=self.backend,
                                query_chunk=self.query_chunk,
                                **self._search_kwargs,
                            )
                        else:
                            ids, dists = ref.index.search(
                                q, params, backend=self.backend,
                                query_chunk=self.query_chunk,
                                **self._search_kwargs,
                            )
                        # The host copy stays INSIDE the read lock: it
                        # waits for this batch's kernels, so when the
                        # epoch's refcount drains no kernel still reads
                        # the old index's segment tensors.
                        ids = _host(ids)
                        dists = _host(dists)
                    search_ms = 1000.0 * (time.perf_counter() - t0)
                    if self.recall_probe is not None:
                        # under the serve lock: snapshot() must not race
                        # concurrent writes to a mutable layout
                        self.recall_probe.offer(q, ids, params.k, ref.index)
            self.metrics.batch_latency.record(search_ms)
            self.metrics.bump("batches")
            self.metrics.bump("rows_searched", int(q.shape[0]))
            off = 0
            for t in batch:
                m = t.queries.shape[0]
                t._complete(ids[off : off + m], dists[off : off + m],
                            ref.epoch)
                off += m
        except BaseException as e:  # fail the whole batch, keep serving
            for t in batch:
                t._fail(e)
        finally:
            ref.checkin()
        for t in batch:
            if t.latency_ms is not None:
                self.metrics.latency.record(t.latency_ms)
            self.metrics.bump("completed")

    def step(self) -> int:
        """Serve ONE micro-batch synchronously; returns requests served.

        The deterministic single-thread mode: exactly what the serve
        thread runs, minus the waiting.  Returns 0 when the queue is
        empty.
        """
        with self._cv:
            batch = self._take_batch_locked()
        if not batch:
            return 0
        self._execute(batch)
        return len(batch)

    def _serve_loop(self) -> None:
        while True:
            with self._cv:
                while not self._pending and not self._closed:
                    self._cv.wait(0.05)
                if not self._pending and self._closed:
                    return  # drained + closed: clean exit
                batch = self._take_batch_locked()
            if batch:
                self._execute(batch)

    # -- background maintenance + double-buffered swap -----------------------

    def maintenance_stats(self) -> Dict[str, Any]:
        """The serving index's trigger signals (empty for static layouts).

        Adds ``rewrite_pressure`` (segments tombstoned past their
        candidate pool under the engine's default params) — the condition
        the facades used to fix by rewriting inside ``search()``, now a
        maintenance trigger because the engine's read path must not
        mutate (shared read lock).
        """
        with self._serve_lock.read_locked():
            index = self.index
            if not hasattr(index, "maintenance_stats"):
                return {}
            stats = index.maintenance_stats()
            if hasattr(index, "rewrite_pressure"):
                stats["rewrite_pressure"] = index.rewrite_pressure(
                    self.params
                )
            return stats

    def maintain_once(self, force: bool = False) -> bool:
        """One full maintenance cycle; returns True iff an index swap
        happened.

        Protocol (the serve lock is held EXCLUSIVELY only for the cheap
        steps — searches keep flowing through 2 and 3):

        1. snapshot the serving index + open the write replay log  (write lock)
        2. compact the shadow — in-thread or in a child process
           (``compaction="subprocess"``), the expensive part        (NO lock)
        3. catch-up rounds: drain the log so far onto the shadow;
           after the first, run the batch shapes the serve loop has
           actually seen on it once                                 (NO lock)
        4. drain the final log tail, swap the pointer               (write lock)
        5. wait for the old epoch's in-flight refcount to drain

        :attr:`last_swap_timeline` records ``*_locked`` booleans per
        phase — the benchmark asserts from them that the lock was held
        exclusively ONLY at snapshot and swap.

        Step 3 runs every batch shape live traffic has used on the
        shadow before the swap: eager torch compiles nothing, but the
        first search of a compacted index grows the caching allocator for
        its new segment sizes, and that belongs off the query path.  The
        dispatch accounting (:mod:`repro_torch.obs.dispatch`) shows that
        no kernel library is built or loaded after warm-up.

        ``force=True`` skips the threshold check (benchmarks use it).
        Static layouts and layouts whose segments lack stored points
        return False without touching anything.

        Cycles are mutually exclusive: a concurrent caller (the
        maintainer thread vs. a forced ``store.compact()``) blocks on an
        internal mutex until the in-flight cycle finishes, then runs its
        own — two interleaved cycles would clobber each other's replay
        log (silent write loss) and race the epoch swap.
        """
        with self._maint_lock:
            return self._maintain_cycle(force)

    def _maintain_cycle(self, force: bool) -> bool:
        """The body of :meth:`maintain_once`; caller holds ``_maint_lock``.

        Each phase is spanned and timed; the whole cycle's durations land
        in :attr:`last_swap_timeline` (and the registry's
        ``engine_maint_<phase>_ms`` recorders) so a swap can be read as a
        timeline: how long the shadow compact ran, how many logged writes
        each replay round drained, and how long the serve lock was
        actually held for the final tail + pointer swap.
        """
        timeline: Dict[str, Any] = {
            "log_depth": 0,
            "replay_rounds": 0,
            "compaction": self.compaction,
        }

        def clock(phase: str, t0: float) -> None:
            timeline[f"{phase}_ms"] = 1000.0 * (time.perf_counter() - t0)

        policy = self.maintenance or MaintenancePolicy()
        if not force and not policy.triggered(self.maintenance_stats()):
            # An idle poll reads the trigger under the SHARED side.  Taking
            # the exclusive side for it (as ``repro`` does) blocks every new
            # search behind the in-flight ones at each poll, 20 times a
            # second by default.  The trigger is checked again below, under
            # the exclusive side, before anything is snapshotted.
            return False
        cycle = span("maint.cycle")
        cycle.__enter__()
        try:
            t0 = time.perf_counter()
            with self._serve_lock.write_locked(), span("maint.snapshot"):
                # EXCLUSIVE: the snapshot + log-open must be atomic
                # against writes (a write between them would be neither
                # snapshotted nor logged = silently lost on swap)
                timeline["snapshot_locked"] = self._serve_lock.write_held()
                index = self.index
                if not (hasattr(index, "snapshot")
                        and hasattr(index, "compact")):
                    return False
                stats = index.maintenance_stats()
                if hasattr(index, "rewrite_pressure"):
                    stats["rewrite_pressure"] = index.rewrite_pressure(
                        self.params
                    )
                if not force and not policy.triggered(stats):
                    return False
                if force and stats.get("mergeable_segments", 0) < 1:
                    return False  # nothing compactable (store_points=False)
                shadow = index.snapshot()
                with self._state_lock:
                    self._write_log = []
            clock("snapshot", t0)
            self.metrics.bump("maintenance_runs")
            try:
                shadow, replay_ms, prewarm_ms = self._compact_and_catch_up(
                    shadow, policy, stats, timeline, clock)
            except BaseException:
                # Any failure abandons the shadow AND closes the replay
                # log, else the write path keeps copying into a log
                # nobody will drain.  (``repro`` closes it only when the
                # compact or a replay round fails; a fault at
                # pre_compact, post_compact or pre_replay left it open.)
                with self._state_lock:
                    self._write_log = None
                raise
            t0 = time.perf_counter()
            with self._serve_lock.write_locked(), span("maint.swap"):
                timeline["swap_locked"] = self._serve_lock.write_held()
                with self._state_lock:
                    log = self._write_log or []
                    self._write_log = None
                timeline["log_depth"] += len(log)
                timeline["tail_ops"] = len(log)
                self._apply(shadow, log)
                # Before the WAL moves: a failure here must leave it on
                # the serving index (``repro`` moved it first, so a raise
                # at pre_swap left the serving index logging nothing).
                fault_point("engine.maint.pre_swap")
                # Transfer the WAL old -> shadow: the shadow deliberately
                # snapshots WITHOUT one (replay must not re-log), and
                # every op applied to it was logged when the old index
                # acknowledged it — the log is exactly as durable for the
                # shadow as it was for the index it replaces.
                if hasattr(index, "detach_wal"):
                    w = index.detach_wal()
                    if w is not None:
                        shadow._wal = w
                with self._state_lock:
                    old = self._current
                    self._current = _Epoch(shadow, old.epoch + 1)
                self.metrics.bump("swaps")
                fault_point("engine.maint.post_swap")
            clock("swap", t0)
            timeline["replay_ms"] = replay_ms
            timeline["prewarm_ms"] = prewarm_ms
            t0 = time.perf_counter()
            old.wait_drained()  # in-flight batches finish on the old index
            clock("drain", t0)
            timeline["epoch"] = self._current.epoch
            reg = default_registry()
            for phase in ("snapshot", "compact", "replay", "prewarm",
                          "swap", "drain"):
                reg.latency(f"engine_maint_{phase}_ms", capacity=1024).record(
                    timeline.get(f"{phase}_ms", 0.0)
                )
            reg.gauge("engine_maint_last_log_depth").set(
                timeline["log_depth"]
            )
            self.last_swap_timeline = timeline
            return True
        finally:
            cycle.__exit__(None, None, None)

    @staticmethod
    def _apply(shadow, log) -> None:
        for op, a, b in log:
            if op == "insert":
                shadow.insert(a, b)
            else:
                shadow.delete(a)

    def _compact_and_catch_up(self, shadow, policy, stats, timeline, clock):
        """Steps 2-3 of a cycle, with NO serve lock held: compact the
        shadow, then drain the replay log onto it in bounded catch-up
        rounds, each followed by a warm search.  Returns the (possibly
        new, in subprocess mode) shadow and the replay and prewarm ms."""
        fault_point("engine.maint.pre_compact")
        t0 = time.perf_counter()
        # Serving continues while the shadow compacts (in-thread or in a
        # child process).  Subprocess mode returns a NEW object.
        timeline["compact_locked"] = self._serve_lock.write_held()
        shadow = self._compact_shadow(
            shadow, policy, int(stats.get("n_segments", 0)), timeline,
        )
        clock("compact", t0)
        fault_point("engine.maint.post_compact")

        def warm():
            # run the post-swap shapes off-path (results discarded); a
            # failure here would fail identically after the swap, so let
            # it propagate and abandon the shadow
            for (p, _bucket), wq in list(self._warm_queries.items()):
                shadow.search(wq, p, backend=self.backend,
                              query_chunk=self.query_chunk,
                              **self._search_kwargs)

        # catch-up rounds: bounded, so a writer outpacing replay can't
        # starve the swap — the final tail drains under the serve lock.
        fault_point("engine.maint.pre_replay")
        replay_ms = prewarm_ms = 0.0
        timeline["replay_locked"] = self._serve_lock.write_held()
        for _ in range(4):
            with self._state_lock:
                log, self._write_log = self._write_log, []
            timeline["log_depth"] += len(log)
            timeline["replay_rounds"] += 1
            t0 = time.perf_counter()
            with span("maint.replay", ops=len(log)):
                self._apply(shadow, log)
            replay_ms += 1000.0 * (time.perf_counter() - t0)
            if timeline["replay_rounds"] == 1:
                # Once, after the compacted shadow's first catch-up: eager
                # torch has nothing to compile (``repro`` warms after every
                # round for its jit caches), and one pass over the shapes
                # sizes the caching allocator for the new segments.
                t0 = time.perf_counter()
                with span("maint.prewarm", shapes=len(self._warm_queries)):
                    warm()
                prewarm_ms += 1000.0 * (time.perf_counter() - t0)
            if not log:
                break
        return shadow, replay_ms, prewarm_ms

    def _compact_shadow(self, shadow, policy: MaintenancePolicy,
                        n_segments: int,
                        timeline: Optional[Dict[str, Any]] = None):
        """Compact the shadow under the ``max_cycle_s`` watchdog; returns
        the compacted shadow (a NEW object in subprocess mode).

        ``compaction="thread"``: the compact runs on a helper thread so a
        hang (wedged device, pathological merge) can be ABANDONED — the
        serving index was never touched, so dropping the shadow loses
        nothing but the cycle's work.  The orphaned thread finishes (or
        hangs) against an object nobody references anymore.
        ``max_cycle_s=None`` compacts inline.

        ``compaction="subprocess"``: the shadow is saved as a
        format_version-5 bundle and compacted by a CHILD process on the
        index's device (:func:`repro_torch.serve.compactor.compact_in_child`); the verified
        result bundle is reloaded and returned.  A child that dies, hangs
        past the watchdog, or produces an unverifiable bundle fails ONLY
        this cycle (:class:`CompactionChildError` /
        :class:`MaintenanceTimeout`); the maintainer backs off and
        retries.
        """
        budget = policy.max_cycle_s
        with span("maint.compact", segments=n_segments,
                  mode=self.compaction):
            if self.compaction == "subprocess":
                return self._compact_in_subprocess(shadow, budget, timeline)
            if budget is None:
                shadow.compact()
                return shadow
            err: List[BaseException] = []

            def run() -> None:
                try:
                    shadow.compact()
                except BaseException as e:
                    err.append(e)

            th = threading.Thread(
                target=run, name="maint-compact", daemon=True
            )
            th.start()
            th.join(budget)
            if th.is_alive():
                self.metrics.bump("maintenance_timeouts")
                raise MaintenanceTimeout(
                    f"shadow compact exceeded {budget}s; shadow abandoned"
                )
            if err:
                raise err[0]
            return shadow

    def _compact_in_subprocess(self, shadow, budget: Optional[float],
                               timeline: Optional[Dict[str, Any]]):
        """Hand the shadow to ``python -m repro_torch.serve.compactor``."""
        workdir = self.compaction_dir
        scratch = None
        if workdir is None:
            scratch = tempfile.mkdtemp(prefix="repro-compact-")
            workdir = scratch
        try:
            try:
                compacted, phases = compact_in_child(
                    shadow, workdir, timeout=budget,
                )
            except subprocess.TimeoutExpired as e:
                self.metrics.bump("maintenance_timeouts")
                raise MaintenanceTimeout(
                    f"compactor child exceeded {budget}s; shadow abandoned"
                ) from e
            reg = default_registry()
            for key in ("save_in_ms", "child_ms", "load_out_ms"):
                reg.latency(f"engine_maint_{key}", capacity=1024).record(
                    float(phases.get(key, 0.0))
                )
            if timeline is not None:
                timeline["compactor_phases"] = phases
            return compacted
        finally:
            if scratch is not None:
                shutil.rmtree(scratch, ignore_errors=True)

    def score_recall(self) -> int:
        """Score pending recall-probe batches (exact float64 shadow, scored
        on the points' device).

        Runs on the CALLING thread — the maintainer calls it between
        cycles, so scoring never touches the query path; step-mode
        engines (and engines without a maintainer) call it by hand.
        Returns per-query samples produced (0 when probing is off).
        """
        if self.recall_probe is None:
            return 0
        with span("engine.recall_score"):
            return self.recall_probe.score_pending()

    def _maintenance_loop(self) -> None:
        policy = self.maintenance or MaintenancePolicy()
        backoff_gauge = default_registry().gauge("engine_maint_backoff_s")
        failures = 0
        while not self._stop_event.wait(policy.poll_interval_s):
            try:
                if self.maintenance is not None:
                    self.maintain_once()
                self.score_recall()
                failures = 0
                backoff_gauge.set(0.0)
            except BaseException as e:
                # maintenance must never take serving down; surface the
                # error for operators/tests, back off (capped exponential
                # — a persistently failing compact can't hot-loop the
                # maintainer), and keep the loop alive.
                self.last_maintenance_error = e
                self.metrics.bump("maintenance_failures")
                failures += 1
                delay = min(
                    policy.backoff_max_s,
                    policy.backoff_initial_s * (2 ** (failures - 1)),
                )
                backoff_gauge.set(delay)
                if self._stop_event.wait(delay):
                    return

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "RetrievalEngine":
        """Spawn the serve worker(s) (+ maintainer when a policy is set).

        ``serve_threads`` workers run the same loop over the shared
        queue; with more than one, micro-batches execute concurrently
        under the shared read side of the serve lock.
        """
        if self.running:
            return self
        self._closed = False
        self._stop_event.clear()
        self._workers = [
            threading.Thread(
                target=self._serve_loop,
                name=f"retrieval-serve-{i}", daemon=True,
            )
            for i in range(self.serve_threads)
        ]
        for w in self._workers:
            w.start()
        want_maint = (
            self.maintenance is not None and hasattr(self.index, "snapshot")
        )
        # the maintainer doubles as the recall scorer, so a probe-enabled
        # engine needs the loop even over a static (no-snapshot) layout —
        # maintain_once() is then a cheap immediate no-op
        if want_maint or self.recall_probe is not None:
            self._maintainer = threading.Thread(
                target=self._maintenance_loop, name="retrieval-maintenance",
                daemon=True,
            )
            self._maintainer.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Shut down: close admission, then drain or fail pending requests.

        ``drain=True`` (default) serves everything already admitted before
        the serve thread exits; ``drain=False`` fails pending tickets with
        :class:`EngineClosed`.  Always joins both threads.  Idempotent;
        if a join times out, ``TimeoutError`` is raised with the engine
        partially stopped (admission closed, the stuck thread's handle
        retained) and a later ``stop()`` re-attempts the join and drain.
        """
        with self._cv:
            self._closed = True
            if not drain:
                while self._pending:
                    self._pending.popleft()._fail(
                        EngineClosed("engine stopped without draining")
                    )
            self._cv.notify_all()
        self._stop_event.set()
        # on join timeout the handle is RETAINED (and we raise), so a
        # retrying stop() re-joins the same thread instead of behaving as
        # if shutdown had completed
        if self._maintainer is not None:
            self._maintainer.join(timeout)
            if self._maintainer.is_alive():
                raise TimeoutError(
                    "maintenance thread did not stop in time"
                )
            self._maintainer = None
        for w in self._workers:
            w.join(timeout)
            if w.is_alive():
                raise TimeoutError("serve thread did not drain in time")
        self._workers = []
        # step-mode engines (never started) drain synchronously
        if drain:
            while self.step():
                pass
            self.score_recall()  # don't strand sampled batches unscored
        else:
            with self._cv:
                while self._pending:
                    self._pending.popleft()._fail(
                        EngineClosed("engine stopped without draining")
                    )

    def __enter__(self) -> "RetrievalEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.stop(drain=exc[0] is None)

    def __repr__(self) -> str:
        return (
            f"RetrievalEngine(index={type(self.index).__name__}, "
            f"epoch={self.epoch}, queue={self.queue_depth}/{self.max_queue}, "
            f"max_batch={self.max_batch}, running={self.running}, "
            f"maintenance={'on' if self.maintenance else 'off'})"
        )
