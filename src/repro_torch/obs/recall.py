"""Online recall estimation: sampled queries vs. an exact shadow.

Port of ``repro.obs.recall``.  :class:`RecallProbe` keeps a seeded
fraction of served batches (the same ``np.random.RandomState`` coin as
``repro``, so both packages sample the same batches), pins a zero-copy
``snapshot()`` of the index each was served against, and scores them off
the query path: exact top-k by brute force in float64, then
``|approx ∩ exact| / k`` per query into a rolling window exported as the
``engine_recall_at_k`` gauge.

``repro`` copies every live point to the host and builds a dense
(Q, n) float64 matrix there; at 3M rows that is 4.6 GB of points and
5.9 GB per scored batch of 256 queries.  The port scores where the points
live instead: :func:`live_parts` names each segment's rows in place (its
points tensor on the index's device, its host id map and live mask), and
:func:`exact_topk_parts` walks them in column chunks, gathering the live
rows of one chunk at a time in float64 and folding them into a running
top-k ordered by distance, then by position (segments in order, rows in
order, the write buffer last).  The segments are never concatenated.

Ground truth needs raw points: layouts built with ``store_points=False``
report nothing (``engine_recall_unscorable_total`` counts the skips).
The sharded layouts wait for the port of the sharded indexes.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from .registry import MetricsRegistry, default_registry

__all__ = [
    "RecallProbeConfig", "RecallProbe", "live_parts", "live_points",
    "exact_topk", "exact_topk_parts", "recall_at_k", "SCORE_CHUNK",
]

#: Columns (live-row candidates) scored per step of the exact top-k.
SCORE_CHUNK = 1 << 16

# (external ids (n,) int64 host, points (n, d) tensor, live mask (n,) host)
Part = Tuple[np.ndarray, torch.Tensor, np.ndarray]


@dataclass(frozen=True)
class RecallProbeConfig:
    """Sampling policy for the online recall probe.

    * ``fraction`` — probability a served batch is sampled (per batch,
      not per row; a batch is scored whole).
    * ``max_pending`` — bound on unscored sampled batches; offers beyond
      it are dropped (counted), so a stalled scorer can't accumulate
      snapshots without limit.
    * ``window`` — rolling per-query recall samples retained for the
      gauge.
    * ``seed`` — sampling RNG seed (deterministic probes in tests).
    """

    fraction: float = 0.05
    max_pending: int = 8
    window: int = 512
    seed: int = 0

    def __post_init__(self):
        if not (0.0 <= self.fraction <= 1.0):
            raise ValueError(f"fraction must be in [0, 1], got {self.fraction}")
        if self.max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {self.max_pending}")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")


def live_parts(index: Any) -> Optional[List[Part]]:
    """Each source of live rows of ``index``, in place, in search order.

    A mutable index gives one part per segment (its real rows: pow2
    padding repeats rows and is left out) and one for the write buffer; a
    static :class:`~repro_torch.index.HilbertIndex` gives one part whose
    row i is external id i.  ``None`` when the points are not stored.
    """
    if hasattr(index, "_owned_rows") or hasattr(index, "stack"):
        raise NotImplementedError(
            "recall probing of the sharded layouts waits for the port of "
            "the sharded indexes (ROADMAP module 12)"
        )
    if hasattr(index, "_buf_points"):
        alive = index._alive
        parts: List[Part] = []
        for seg in index.segments:
            if seg.index.points is None:
                return None
            ids = seg.ids[: seg.n_real].astype(np.int64)
            parts.append((ids, seg.index.points[: seg.n_real], alive[ids]))
        if index._buf_count:
            bids = index._buf_ids[: index._buf_count].astype(np.int64)
            pts = torch.from_numpy(index._buf_points[: index._buf_count])
            parts.append((bids, pts, alive[bids]))
        return parts
    if hasattr(index, "n_points"):
        if index.points is None:
            return None
        n = index.n_points
        return [(np.arange(n, dtype=np.int64), index.points,
                 np.ones((n,), np.bool_))]
    return None


def live_points(index: Any) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """``(ids, points)`` of every live row of ``index``, on the host.

    The concatenation of :func:`live_parts`; for small indexes and tests
    (the probe itself never concatenates).
    """
    parts = live_parts(index)
    if not parts:
        return None
    ids = np.concatenate([i[k] for i, _, k in parts]).astype(np.int64)
    if ids.size == 0:
        return None
    pts = np.concatenate([p.cpu().numpy()[k] for _, p, k in parts])
    return ids, pts.astype(np.float32)


def exact_topk_parts(queries, parts: List[Part], k: int, *,
                     chunk: int = SCORE_CHUNK,
                     device: Optional[torch.device] = None) -> np.ndarray:
    """Exact L2 top-k external ids per query over ``parts``; (q, k) int64.

    Scores on ``device`` (default: the first part's) in float64, ``chunk``
    rows of a part at a time, keeping a running top-k ordered by distance
    then by position.  Columns past the live count are ``-1``.
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if device is None:
        device = parts[0][1].device if parts else torch.device("cpu")
    q = torch.as_tensor(np.asarray(queries), device=device).to(torch.float64)
    qq = (q * q).sum(1, keepdim=True)
    best_d = torch.full((q.shape[0], k), torch.inf, dtype=torch.float64,
                        device=device)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64, device=device)
    for ids, pts, keep in parts:
        for s in range(0, ids.shape[0], chunk):
            rows = np.flatnonzero(keep[s : s + chunk]) + s
            if rows.size == 0:
                continue
            p = pts[torch.from_numpy(rows).to(pts.device)]
            p = p.to(device=device, dtype=torch.float64)
            # ||q - p||^2 expanded, as repro's host scorer computes it
            d2 = qq - 2.0 * (q @ p.T) + (p * p).sum(1)[None, :]
            cid = torch.from_numpy(ids[rows]).to(device).expand(q.shape[0], -1)
            if rows.size > k:
                d2, cid = _chunk_topk(d2, cid, k)
            # Stable sort: on equal distance, the running best (earlier
            # positions, already in order) stays ahead of this chunk.
            cat_d = torch.cat([best_d, d2], 1)
            order = torch.sort(cat_d, dim=1, stable=True).indices[:, :k]
            best_d = torch.gather(cat_d, 1, order)
            best_i = torch.gather(torch.cat([best_i, cid], 1), 1, order)
    return best_i.cpu().numpy()


def _chunk_topk(d2: torch.Tensor, cid: torch.Tensor, k: int):
    """The k smallest columns of each row, in column order.

    ``torch.topk`` picks any of several columns tied at the k-th distance;
    the lowest positions must win, so a chunk with such a tie keeps all
    its columns for the stable merge instead.
    """
    v, sel = torch.topk(d2, k, dim=1, largest=False, sorted=False)
    kth = v.max(dim=1, keepdim=True).values
    if bool(((d2 <= kth).sum(dim=1) > k).any()):
        return d2, cid
    sel = torch.sort(sel, dim=1).values
    return torch.gather(d2, 1, sel), torch.gather(cid, 1, sel)


def exact_topk(queries, ids, pts, k: int, *, chunk: int = SCORE_CHUNK
               ) -> np.ndarray:
    """Exact L2 top-k ids per query, float64.  (q, k) int64.

    ``pts`` may be a numpy array or a tensor (scored on its device).
    Rows beyond the live count are ``-1`` (the facades' padding
    convention).
    """
    ids = np.asarray(ids, np.int64)
    pts = torch.as_tensor(pts)
    return exact_topk_parts(queries, [(ids, pts, np.ones(ids.shape, np.bool_))],
                            k, chunk=chunk)


def recall_at_k(approx_ids: np.ndarray, exact_ids: np.ndarray) -> np.ndarray:
    """Per-query ``|approx ∩ exact| / k`` (k = exact id columns)."""
    a = np.asarray(approx_ids)
    e = np.asarray(exact_ids)
    k = e.shape[1]
    out = np.zeros((a.shape[0],), np.float64)
    for i in range(a.shape[0]):
        ea = set(int(x) for x in e[i] if x >= 0)
        aa = set(int(x) for x in a[i] if x >= 0)
        out[i] = len(ea & aa) / max(k, 1)
    return out


class RecallProbe:
    """Sampled online recall@k against an exact brute-force shadow."""

    def __init__(self, config: Optional[RecallProbeConfig] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.config = config or RecallProbeConfig()
        reg = registry or default_registry()
        self._rng = np.random.RandomState(self.config.seed)
        self._lock = threading.Lock()
        self._pending: deque = deque()
        self._window: deque = deque(maxlen=self.config.window)
        self._sampled = reg.counter("engine_recall_batches_sampled_total")
        self._dropped = reg.counter("engine_recall_batches_dropped_total")
        self._unscorable = reg.counter("engine_recall_unscorable_total")
        self._samples = reg.counter("engine_recall_samples_total")
        self._gauge = reg.gauge("engine_recall_at_k", fn=self.recall)
        self._pending_gauge = reg.gauge(
            "engine_recall_pending_batches", fn=lambda: len(self._pending)
        )

    def offer(self, queries: np.ndarray, ids: np.ndarray, k: int,
              index: Any) -> bool:
        """Maybe sample a served batch.  Serving-path cost: one RNG draw.

        Call with the index the batch was actually served against (the
        engine passes its checked-out epoch's index).  A kept batch pins
        a zero-copy snapshot when the index supports one — mutable
        layouts keep mutating after we return — and the index itself
        when static (immutable by construction).
        """
        with self._lock:
            if self._rng.random_sample() >= self.config.fraction:
                return False
            if len(self._pending) >= self.config.max_pending:
                self._dropped.inc()
                return False
            shadow = index.snapshot() if hasattr(index, "snapshot") else index
            self._pending.append(
                (np.asarray(queries).copy(), np.asarray(ids).copy(),
                 int(k), shadow)
            )
        self._sampled.inc()
        return True

    def score_pending(self) -> int:
        """Score every pending batch (call OFF the query path).

        Returns the number of per-query recall samples produced.
        """
        scored = 0
        while True:
            with self._lock:
                if not self._pending:
                    return scored
                queries, ids, k, shadow = self._pending.popleft()
            parts = live_parts(shadow)
            if not parts or not any(keep.any() for _, _, keep in parts):
                self._unscorable.inc()
                continue
            exact = exact_topk_parts(queries, parts, k)
            r = recall_at_k(ids, exact)
            with self._lock:
                self._window.extend(float(x) for x in r)
            self._samples.inc(r.size)
            scored += int(r.size)

    def recall(self) -> float:
        """Rolling mean recall@k over the window (nan before any sample)."""
        with self._lock:
            if not self._window:
                return float("nan")
            return float(np.mean(self._window))
