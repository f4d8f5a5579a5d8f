"""MutableHilbertIndex: LSM-style streaming mutation on top of HilbertIndex.

Port of ``repro.index.mutable``.  The same operations give the same state
in both packages, bit for bit: external ids, the tombstone mask, values,
the segments' generations, id maps and arrays.

* **Write buffer** — a fixed-capacity host array of freshly inserted
  points, searched exactly on the index's device
  (:func:`repro_torch.core.search.brute_force_topk`).
* **Sealed segments** — when the buffer fills (or :meth:`flush` is called)
  its live rows become an ordinary immutable :class:`HilbertIndex` on the
  index's device, plus a host id-remap array giving each local row its
  stable external id.
* **Tombstones** — deletes flip a bit in a dense host ``alive`` mask;
  search masks dead candidates during the cross-segment merge, and each
  segment's per-query ``k`` is inflated by its dead count.
* **Tiered compaction** — when segments pile up, the smallest two are
  merged: their stored points are gathered on the device, tombstoned rows
  drop for good, and one Hilbert-forest build re-sorts them.
  :meth:`compact` merges everything into one segment, after which search
  equals a from-scratch :class:`HilbertIndex.build` over the surviving
  points in insertion order.

Search fans out over buffer + segments and merges the per-source top-k
with :func:`repro_torch.core.search.merge_topk`.  Persistence is the JAX
package's multi-bundle layout (one bundle per segment, one for the
buffer/tombstone/value state, committed by an atomically renamed
manifest), so a mutable index saved by either package loads in the other.
Every mutation is logged to an optional write-ahead log before it applies
(:class:`WalFacade`).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import bundle
from repro_torch.checkpoint import wal as wal_lib
from repro_torch.core import search as search_lib
from repro_torch.core.types import SearchParams
from repro_torch.index.config import IndexConfig
from repro_torch.index.convert import load_index_bundle
from repro_torch.index.facade import (DeviceLike, HilbertIndex, resolve_device,
                                      save_index_bundle)
from repro_torch.obs.dispatch import dispatch_scope
from repro_torch.obs.trace import span
from repro_torch.testing.faults import fault_point

__all__ = [
    "LsmIdSpace",
    "MutableHilbertIndex",
    "Segment",
    "WalFacade",
    "dense_values_at",
    "load_mutable_bundle",
    "replay_wal_records",
    "save_mutable_bundle",
]

_MANIFEST = "mutable_manifest.json"
_SEGMENT_KIND = "mutable_segment"
_DEFAULT_KIND = "mutable_hilbert_index"
_MAX_IDS = 2**31 - 1  # external ids are int32


def _host(x) -> np.ndarray:
    """A numpy view of a tensor (any device) or array-like."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def dense_values_at(values: np.ndarray, ids, fill=0) -> torch.Tensor:
    """Gather rows of a dense by-id ``values`` array for search-result ids.

    ``-1`` padding ids surface as ``fill``; other ids are clipped into
    range.  The result lies on the device of ``ids`` when it is a tensor.
    """
    idn = _host(ids)
    safe = np.clip(idn, 0, values.shape[0] - 1)
    out = values[safe]
    mask = (idn >= 0).reshape(idn.shape + (1,) * (out.ndim - idn.ndim))
    dev = ids.device if isinstance(ids, torch.Tensor) else "cpu"
    return torch.from_numpy(np.where(mask, out, fill)).to(dev)


def _pow2_ceil(x: int) -> int:
    """Smallest power of two >= x (>= 1)."""
    return 1 << max(0, int(x) - 1).bit_length()


class LsmIdSpace:
    """External-id allocation, tombstones, and per-point values (host numpy).

    Ids are dense int32 assigned at insert and stable for the life of the
    index, ``alive`` is a dense by-id tombstone mask, and ``values``
    (optional) is a dense by-id payload array whose tracking mode is
    pinned by the first insert.  ``delete_epoch`` bumps on every effective
    delete so owners can cache per-segment dead counts.
    """

    def __init__(self):
        self.next_id = 0
        self.alive = np.zeros((0,), np.bool_)  # dense by external id
        self.values: Optional[np.ndarray] = None  # dense by external id
        self.track_values: Optional[bool] = None
        self.delete_epoch = 0  # bumps on delete; invalidates dead caches

    @property
    def n_live(self) -> int:
        return int(np.count_nonzero(self.alive))

    @property
    def n_deleted(self) -> int:
        return int(self.next_id - self.n_live)

    def prepare(self, points, values, dim: Optional[int]
                ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Normalize + fully validate an insert WITHOUT mutating anything.

        Returns host ``(points (m, d) fp32, values)``; a raise here leaves
        the index unchanged.
        """
        pts = np.asarray(_host(points), np.float32)
        if pts.ndim == 1:
            pts = pts[None, :]
        if pts.ndim != 2:
            raise ValueError(f"points must be (m, d), got shape {pts.shape}")
        if pts.shape[0] == 0:
            return pts, None
        vals = self.validate(pts.shape[0], values)
        if dim is not None and pts.shape[1] != dim:
            raise ValueError(f"dim mismatch: index is {dim}, got {pts.shape[1]}")
        return pts, vals

    def validate(self, m: int, values) -> Optional[np.ndarray]:
        """Pre-mutation checks for an m-row insert; returns host values.

        Raises without touching any state (a failed insert must leave the
        index unchanged — including NOT pinning the values mode).
        """
        if self.track_values is not None and (
            (values is not None) != self.track_values
        ):
            raise ValueError(
                "inconsistent values tracking: every insert must carry values "
                "or none may (first insert decides)"
            )
        vals = None
        if values is not None:
            vals = _host(values)
            if vals.shape[:1] != (m,):
                raise ValueError(f"values must be (m, ...) with m={m}")
        if self.next_id + m > _MAX_IDS:
            raise OverflowError("external id space (int32) exhausted")
        return vals

    def register(self, m: int, vals: Optional[np.ndarray]) -> np.ndarray:
        """Allocate m external ids; extend alive/values. Call validate first."""
        if self.track_values is None:
            self.track_values = vals is not None
        ids = np.arange(self.next_id, self.next_id + m, dtype=np.int32)
        self.next_id += m
        self.alive = np.concatenate([self.alive, np.ones((m,), np.bool_)])
        if vals is not None:
            self.values = (vals.copy() if self.values is None
                           else np.concatenate([self.values, vals]))
        return ids

    def check_ids(self, ids) -> np.ndarray:
        """Ids to delete as int64; ``KeyError`` on any id never assigned."""
        idn = np.atleast_1d(_host(ids)).astype(np.int64)
        bad = idn[(idn < 0) | (idn >= self.next_id)]
        if bad.size:
            raise KeyError(f"unknown external ids: {bad[:8].tolist()}")
        return idn

    def delete(self, ids) -> int:
        """Tombstone ids; returns the newly-dead count. KeyError on unknown."""
        idn = self.check_ids(ids)
        if idn.size == 0:
            return 0
        uniq = np.unique(idn)
        newly = int(np.count_nonzero(self.alive[uniq]))
        self.alive[uniq] = False
        if newly:
            self.delete_epoch += 1
        return newly

    def values_at(self, ids, fill=0) -> torch.Tensor:
        if self.values is None:
            raise ValueError("this index tracks no values (insert them)")
        return dense_values_at(self.values, ids, fill=fill)

    def clone(self) -> "LsmIdSpace":
        """Deep copy of the host bookkeeping (the snapshot/swap hook)."""
        c = LsmIdSpace()
        c.next_id = self.next_id
        c.alive = self.alive.copy()
        c.values = None if self.values is None else self.values.copy()
        c.track_values = self.track_values
        c.delete_epoch = self.delete_epoch
        return c


@dataclasses.dataclass(eq=False)  # identity equality: segments hold tensors
class Segment:
    """One sealed immutable segment: an index plus its external-id remap.

    ``ids[row] = external id`` of the row-th point handed to the segment's
    build (ascending, because flush/compaction keep insertion order).
    """

    index: HilbertIndex
    ids: np.ndarray  # (n,) int32, ascending external ids
    gen: int  # monotone generation tag (stable on-disk segment name)
    # With IndexConfig.seal_pow2, rows past ``n_valid`` repeat earlier rows
    # (same external id, so the merge dedups them).  -1 = unpadded.
    n_valid: int = -1
    # dead-count cache: recomputed only when the owner's delete epoch moves.
    dead_cache: int = dataclasses.field(default=-1, repr=False)
    dead_epoch: int = dataclasses.field(default=-1, repr=False)

    @property
    def n_points(self) -> int:
        return int(self.ids.shape[0])

    @property
    def n_real(self) -> int:
        """Rows that are NOT pow2 padding duplicates (a prefix of ids)."""
        return self.n_valid if self.n_valid >= 0 else self.n_points

    @property
    def n_pad(self) -> int:
        return self.n_points - self.n_real

    def memory_bytes(self) -> int:
        return self.index.memory_report()["resident_bytes"] + self.ids.nbytes

    def content_uid(self) -> str:
        """Content address for on-disk dedup: hashes gen, ids and packed codes.

        The codes are hashed as the JAX package's uint32 words (the port's
        int32 bit pattern has the same bytes), so both packages give one
        segment the same uid and a re-save over the other's bundle skips it.
        """
        codes = self.index.codes_master.cpu().numpy()
        h = hashlib.sha1()
        h.update(np.int64(self.gen).tobytes())
        h.update(np.asarray(self.ids.shape + codes.shape, np.int64).tobytes())
        h.update(self.ids.tobytes())
        h.update(codes.tobytes())
        return h.hexdigest()


class WalFacade:
    """WAL attachment + log-then-apply hooks.

    Host classes provide ``self._lsm`` (an :class:`LsmIdSpace`),
    ``self._dim``, and initialise ``self._wal = None``.  Mutating methods
    call :meth:`_wal_log_insert` / :meth:`_wal_log_delete` BEFORE touching
    any state, so an acknowledged mutation can never be lost to a crash.
    """

    _wal: Optional[wal_lib.WriteAheadLog]

    @property
    def wal(self) -> Optional[wal_lib.WriteAheadLog]:
        return self._wal

    def enable_wal(self, path: str, config: Optional[wal_lib.WalConfig] = None
                   ) -> wal_lib.WriteAheadLog:
        """Attach a write-ahead log at ``<path>/wal.log``.

        ``path`` is the checkpoint directory this index saves to:
        ``save(path)`` truncates the log at its commit point, and
        ``load(path)`` replays + re-attaches it.  The file must hold no
        unreplayed records.
        """
        if self._wal is not None:
            raise ValueError("a WAL is already attached to this index")
        os.makedirs(path, exist_ok=True)
        self._wal = wal_lib.WriteAheadLog(wal_lib.wal_path(path), config)
        return self._wal

    def detach_wal(self) -> Optional[wal_lib.WriteAheadLog]:
        """Detach (without closing) and return the WAL, if any."""
        w, self._wal = self._wal, None
        return w

    def _wal_log_insert(self, op: str, points, values) -> None:
        if self._wal is None:
            return
        # prepare() validates without mutating: nothing is logged for an
        # insert that would raise, and a failed append changes nothing.
        pts, vals = self._lsm.prepare(points, values, self._dim)
        if pts.shape[0] == 0:
            return
        arrays = {"points": pts}
        if vals is not None:
            arrays["values"] = vals
        self._wal.append(op, arrays, {"next_id": int(self._lsm.next_id)})

    def _wal_log_delete(self, ids) -> None:
        if self._wal is None:
            return
        idn = self._lsm.check_ids(ids)
        if idn.size == 0:
            return
        self._wal.append("delete", {"ids": idn.astype(np.int32)},
                         {"next_id": int(self._lsm.next_id)})


class MutableHilbertIndex(WalFacade):
    """Streaming insert/delete/search over an LSM of Hilbert-forest segments.

    Typical lifecycle::

        mut = MutableHilbertIndex(IndexConfig(), buffer_capacity=4096)
        ids = mut.insert(points)          # stable external ids
        mut.delete(ids[:10])              # tombstoned, invisible to search
        hits, d2 = mut.search(queries, SearchParams(k=30))
        mut.compact()                     # one segment, tombstones dropped
        mut.save(path); mut = MutableHilbertIndex.load(path)

    Segments live on ``device`` (the GPU unless ``device="cpu"``; without
    a GPU it raises); the write buffer, tombstones, values and id maps stay
    host numpy.  ``insert`` may carry per-point ``values``; retrieve them
    for search hits with :meth:`values_at`.
    """

    def __init__(self, config: Optional[IndexConfig] = None, *,
                 buffer_capacity: int = 4096, max_segments: int = 8,
                 device: DeviceLike = None):
        if buffer_capacity < 1:
            raise ValueError(f"buffer_capacity must be >= 1, got {buffer_capacity}")
        if max_segments < 1:
            raise ValueError(f"max_segments must be >= 1, got {max_segments}")
        self.device = resolve_device(device)
        self.config = IndexConfig() if config is None else config
        self.buffer_capacity = int(buffer_capacity)
        self.max_segments = int(max_segments)
        self.segments: List[Segment] = []
        self._dim: Optional[int] = None
        self._buf_points: Optional[np.ndarray] = None  # (capacity, d) f32
        self._buf_ids: Optional[np.ndarray] = None  # (capacity,) int32
        self._buf_count = 0
        self._lsm = LsmIdSpace()  # external ids / tombstones / values
        self._gen = 0
        self._wal: Optional[wal_lib.WriteAheadLog] = None

    # -- LsmIdSpace shims (the JAX package's attribute names) ---------------

    @property
    def _alive(self) -> np.ndarray:
        return self._lsm.alive

    @_alive.setter
    def _alive(self, v) -> None:
        self._lsm.alive = v

    @property
    def _next_id(self) -> int:
        return self._lsm.next_id

    @_next_id.setter
    def _next_id(self, v) -> None:
        self._lsm.next_id = v

    @property
    def _values(self) -> Optional[np.ndarray]:
        return self._lsm.values

    @_values.setter
    def _values(self, v) -> None:
        self._lsm.values = v

    @property
    def _track_values(self) -> Optional[bool]:
        return self._lsm.track_values

    @_track_values.setter
    def _track_values(self, v) -> None:
        self._lsm.track_values = v

    # -- introspection -------------------------------------------------------

    @property
    def dim(self) -> Optional[int]:
        return self._dim

    @property
    def n_segments(self) -> int:
        return len(self.segments)

    @property
    def n_live(self) -> int:
        """Points visible to search (inserted, not deleted)."""
        return self._lsm.n_live

    @property
    def n_deleted(self) -> int:
        return self._lsm.n_deleted

    @property
    def n_buffered(self) -> int:
        """Live points still in the write buffer (not yet in a segment)."""
        if self._buf_count == 0:
            return 0
        return int(np.count_nonzero(self._alive[self._buf_ids[: self._buf_count]]))

    def memory_report(self) -> Dict[str, Any]:
        """Bytes for ALL resident state: segments, buffer, values, tombstones."""
        per_segment = [seg.memory_bytes() for seg in self.segments]
        buffer_bytes = 0
        if self._buf_points is not None:
            buffer_bytes = self._buf_points.nbytes + self._buf_ids.nbytes
        rep: Dict[str, Any] = {
            "segments_bytes": int(sum(per_segment)),
            "buffer_bytes": int(buffer_bytes),
            "values_bytes": 0 if self._values is None else int(self._values.nbytes),
            "tombstone_bytes": int(self._alive.nbytes),
            "per_segment": [int(b) for b in per_segment],
            "n_segments": self.n_segments,
            "n_live": self.n_live,
            "n_deleted": self.n_deleted,
            "n_buffered": self.n_buffered,
        }
        rep["total_bytes"] = (rep["segments_bytes"] + rep["buffer_bytes"]
                              + rep["values_bytes"] + rep["tombstone_bytes"])
        return rep

    def __repr__(self) -> str:
        mb = self.memory_report()["total_bytes"] / 1e6
        return (
            f"MutableHilbertIndex(n_live={self.n_live}, "
            f"n_segments={self.n_segments}, "
            f"buffered={self.n_buffered}/{self.buffer_capacity}, "
            f"deleted={self.n_deleted}, dim={self._dim}, "
            f"device={self.device}, {mb:.2f} MB)"
        )

    # -- mutation ------------------------------------------------------------

    def _register(self, points, values) -> Tuple[np.ndarray, np.ndarray]:
        """Shared insert bookkeeping: dims, values mode, ids, alive mask."""
        pts, vals = self._lsm.prepare(points, values, self._dim)
        if pts.shape[0] == 0:
            return pts, np.zeros((0,), np.int32)
        if self._dim is None:
            self._dim = int(pts.shape[1])
            self._buf_points = np.zeros((self.buffer_capacity, self._dim), np.float32)
            self._buf_ids = np.full((self.buffer_capacity,), -1, np.int32)
        return pts, self._lsm.register(pts.shape[0], vals)

    def insert(self, points, values=None) -> np.ndarray:
        """Insert points (numpy array or tensor on any device).

        Args:
          points: (m, d) fp32 rows (a single (d,) row is promoted).
          values: optional (m, ...) per-point payloads; the first insert
            pins whether the index tracks values.

        Returns:
          (m,) int32 stable external ids (numpy).

        Points land in the write buffer (searchable immediately, exactly);
        each buffer fill seals a segment, and tier merging keeps the segment
        count at most ``max_segments``.  With a WAL attached the insert is
        logged before any state changes.
        """
        self._wal_log_insert("insert", points, values)
        pts, ids = self._register(points, values)
        m = pts.shape[0]
        done = 0
        while done < m:
            take = min(self.buffer_capacity - self._buf_count, m - done)
            sl = slice(self._buf_count, self._buf_count + take)
            self._buf_points[sl] = pts[done : done + take]
            self._buf_ids[sl] = ids[done : done + take]
            self._buf_count += take
            done += take
            if self._buf_count >= self.buffer_capacity:
                self.flush()
        if m:
            self._maybe_merge_tiers()
        return ids

    def bulk_load(self, points, values=None) -> np.ndarray:
        """Seal a whole corpus as ONE segment, bypassing the write buffer.

        The initial corpus of a store should be one large segment (search
        identical to a static ``HilbertIndex``), not ``n/buffer_capacity``
        small ones.  Returns external ids like :meth:`insert`.
        """
        self._wal_log_insert("bulk_load", points, values)
        if self._buf_count:
            self.flush()
        pts, ids = self._register(points, values)
        if pts.shape[0] == 0:
            raise ValueError("bulk_load needs a non-empty (m, d) corpus")
        self.segments.append(self._build_segment(pts, ids))
        self._maybe_merge_tiers()
        return ids

    def delete(self, ids) -> int:
        """Tombstone external ids; returns how many were newly deleted.

        Out-of-range ids raise ``KeyError``; already-deleted ids are a no-op.
        Rows are physically dropped at the next flush (buffer rows) or
        compaction touching their segment.
        """
        self._wal_log_delete(ids)
        return self._lsm.delete(ids)

    def _segment_dead(self, seg: Segment) -> int:
        """Tombstone count among a segment's REAL rows, cached between deletes."""
        if seg.dead_epoch != self._lsm.delete_epoch:
            seg.dead_cache = seg.n_real - int(
                np.count_nonzero(self._alive[seg.ids[: seg.n_real]]))
            seg.dead_epoch = self._lsm.delete_epoch
        return seg.dead_cache

    def rewrite_pressure(self, params: Optional[SearchParams] = None) -> int:
        """Segments so tombstoned that dead rows can crowd live neighbours
        out of the stage-2 candidate pool under ``params`` — the condition
        that rewrites a segment inside ``search(allow_rewrite=True)``."""
        if params is None:
            params = SearchParams()
        cap = params.k2 * (2 * params.h + 1)
        n = 0
        for seg in list(self.segments):
            dead = self._segment_dead(seg)
            need = (params.k + dead) * (2 if seg.n_pad else 1)
            if dead > 0 and need > cap and seg.index.points is not None:
                n += 1
        return n

    # -- segment lifecycle ---------------------------------------------------

    def _build_segment(self, pts, ids: np.ndarray, *, pad: bool = False) -> Segment:
        """Build a segment from host rows (copied to the device) or from a
        device tensor of rows (a merge), with pow2 padding when asked."""
        if isinstance(pts, np.ndarray):
            pts = torch.from_numpy(pts).to(self.device, copy=True)
        n_valid = int(pts.shape[0])
        if pad and self.config.seal_pow2:
            # Shape-stable seals: cyclically repeat real rows up to the next
            # power of two; duplicates share their original's external id.
            target = _pow2_ceil(max(n_valid, 1))
            if target > n_valid:
                reps = -(-target // n_valid)
                pts = pts.repeat(reps, 1)[:target]
                ids = np.tile(ids, reps)[:target]
        with span("lsm.segment_build", rows=int(pts.shape[0])), \
                dispatch_scope("lsm.segment_build"):
            index = HilbertIndex.build(pts, self.config, device=self.device)
        seg = Segment(index=index, ids=np.ascontiguousarray(ids, np.int32),
                      gen=self._gen, n_valid=n_valid)
        self._gen += 1
        return seg

    def flush(self) -> Optional[Segment]:
        """Seal the write buffer's live rows into an immutable segment.

        Dead buffer rows are dropped here for good.  No-op (returns None) on
        an empty or fully tombstoned buffer.
        """
        if self._buf_count == 0:
            return None
        ids = self._buf_ids[: self._buf_count]
        live = self._alive[ids]
        pts = self._buf_points[: self._buf_count][live]
        ids = ids[live].copy()
        self._buf_count = 0
        if ids.size == 0:
            return None
        seg = self._build_segment(pts, ids, pad=True)
        self.segments.append(seg)
        return seg

    def _merge_segments(self, to_merge: Sequence[Segment], *, pad: bool = False
                        ) -> Optional[Segment]:
        """Replace ``to_merge`` with one segment; tombstoned rows vanish."""
        for seg in to_merge:
            if seg.index.points is None:
                raise ValueError(
                    "cannot compact a segment built without stored points "
                    "(IndexConfig(store_points=False), or a store_points="
                    "False index adopted via from_index)"
                )
        # Real rows only (pow2 padding excluded); live rows in external-id
        # (= insertion) order, so a full compaction feeds the rebuild the
        # point sequence a fresh build would see.
        ids = np.concatenate([seg.ids[: seg.n_real] for seg in to_merge])
        keep = np.flatnonzero(self._alive[ids])
        keep = keep[np.argsort(ids[keep], kind="stable")]
        ids = ids[keep]
        self.segments = [s for s in self.segments if s not in to_merge]
        if ids.size == 0:
            return None
        rows = torch.from_numpy(keep).to(self.device)
        pts = torch.cat([seg.index.points[: seg.n_real] for seg in to_merge])[rows]
        seg = self._build_segment(pts, ids, pad=pad)
        self.segments.append(seg)
        return seg

    def _maybe_merge_tiers(self) -> None:
        while len(self.segments) > self.max_segments:
            # Only segments holding raw points can be re-sorted.
            mergeable = [s for s in self.segments if s.index.points is not None]
            if len(mergeable) < 2:
                return
            smallest = sorted(mergeable, key=lambda s: s.n_points)[:2]
            self._merge_segments(smallest, pad=True)

    def compact(self) -> "MutableHilbertIndex":
        """Full compaction: flush, then merge ALL segments into one.

        Afterwards the index holds at most one segment containing exactly
        the live points in insertion order.  Returns self (chainable).
        """
        with span("lsm.compact", segments=len(self.segments)):
            self.flush()
            if self.segments:
                self._merge_segments(list(self.segments))
        return self

    # -- serving-engine hooks ------------------------------------------------

    def snapshot(self) -> "MutableHilbertIndex":
        """Shared-segment copy for off-path maintenance: segments are
        immutable and shared (fresh wrappers), the buffer and bookkeeping
        are deep-copied, and the WAL is not carried over."""
        snap = MutableHilbertIndex(config=self.config,
                                   buffer_capacity=self.buffer_capacity,
                                   max_segments=self.max_segments,
                                   device=self.device)
        snap._dim = self._dim
        if self._dim is not None:
            snap._buf_points = self._buf_points.copy()
            snap._buf_ids = self._buf_ids.copy()
        snap._buf_count = self._buf_count
        snap._lsm = self._lsm.clone()
        snap._gen = self._gen
        snap.segments = [Segment(index=seg.index, ids=seg.ids, gen=seg.gen,
                                 n_valid=seg.n_valid) for seg in self.segments]
        return snap

    def maintenance_stats(self) -> Dict[str, Any]:
        """The trigger signals a background maintainer watches (host-only)."""
        next_id = max(self._next_id, 1)
        return {
            "n_segments": self.n_segments,
            "mergeable_segments": sum(
                1 for s in self.segments if s.index.points is not None),
            "n_live": self.n_live,
            "n_deleted": self.n_deleted,
            "n_buffered": self.n_buffered,
            "tombstone_ratio": float(self.n_deleted) / float(next_id),
        }

    # -- search --------------------------------------------------------------

    def search(self, queries, params: Optional[SearchParams] = None, *,
               backend: str = "kernel", query_chunk: Optional[int] = None,
               allow_rewrite: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fan-out Algorithm-1 top-k over buffer + segments, merged exactly.

        Args:
          queries: (Q, d) fp32 query batch (numpy array or tensor).
          params: Algorithm-1 hyper-parameters; each segment is asked for
            ``k`` inflated by its tombstones
            (:func:`repro_torch.core.search.inflate_k`).
          backend: ``"kernel"`` or ``"ref"``, passed to each segment's
            ``HilbertIndex.search``.
          query_chunk: per-chunk cap (default ``config.query_chunk``).
          allow_rewrite: permit read-triggered compaction of a segment
            tombstoned past the stage-2 pool (a serving engine passes
            ``False`` and reads :meth:`rewrite_pressure` instead).

        Returns ``(ids (Q, k) int32, sq_distances (Q, k) float32)`` on the
        index's device, with **external** ids; fewer than k live points pad
        the tail with id -1 / +inf.  Segment distances are 4-bit ADC, buffer
        distances exact fp32, and the merge compares them directly.
        """
        if params is None:
            params = SearchParams()
        dev = self.device
        q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
        qn, k = q.shape[0], params.k
        cap = params.k2 * (2 * params.h + 1)  # stage-2 candidate pool per segment
        parts_ids: List[np.ndarray] = []
        parts_d: List[torch.Tensor] = []
        for seg in list(self.segments):
            dead = self._segment_dead(seg)
            # A padded segment repeats each real row at most twice, so it
            # needs 2x the slots for the same count of distinct results.
            need = (k + dead) * (2 if seg.n_pad else 1)
            if (allow_rewrite and dead > 0 and need > cap
                    and seg.index.points is not None):
                # Read-triggered compaction of just this segment.
                seg = self._merge_segments([seg], pad=True)
                if seg is None:  # segment was fully tombstoned
                    continue
                dead = 0
                need = k * (2 if seg.n_pad else 1)
            k_seg = search_lib.inflate_k(k, need - k, cap)
            sids, sd2 = seg.index.search(q, dataclasses.replace(params, k=k_seg),
                                         backend=backend, query_chunk=query_chunk)
            # Local rows -> external ids on the host: one copy per segment.
            sids = np.clip(sids.cpu().numpy(), 0, seg.n_points - 1)
            parts_ids.append(seg.ids[sids])
            parts_d.append(sd2)
        if self.n_buffered:
            valid = np.zeros((self.buffer_capacity,), np.bool_)
            bids = self._buf_ids[: self._buf_count]
            valid[: self._buf_count] = self._alive[bids]
            with dispatch_scope("lsm.buffer_search"):
                idx, bd2 = search_lib.brute_force_topk(
                    q, torch.from_numpy(self._buf_points).to(dev),
                    torch.from_numpy(valid).to(dev),
                    k=min(k, self.buffer_capacity))
            parts_ids.append(self._buf_ids[idx.cpu().numpy()])
            parts_d.append(bd2)
        if not parts_ids:
            return (torch.full((qn, k), -1, dtype=torch.int32, device=dev),
                    torch.full((qn, k), torch.inf, dtype=torch.float32, device=dev))
        ids = np.concatenate(parts_ids, axis=1)
        # Tombstone masking on the host (the alive mask is numpy), then the
        # shared dedup + rank + pad merge on the device.
        dead = ~self._alive[np.clip(ids, 0, max(self._next_id - 1, 0))]
        d2 = torch.cat(parts_d, dim=1)
        d2 = torch.where(torch.from_numpy(dead).to(dev), torch.inf, d2)
        with dispatch_scope("lsm.merge"):
            return search_lib.merge_topk(torch.from_numpy(ids).to(dev), d2, k=k)

    # -- values --------------------------------------------------------------

    def values_at(self, ids, fill=0) -> torch.Tensor:
        """Gather per-point values for search-result ids; -1 slots get fill."""
        return self._lsm.values_at(ids, fill=fill)

    def values_dense(self) -> torch.Tensor:
        """The dense by-external-id values array (stale rows where deleted)."""
        if self._values is None:
            raise ValueError("this index tracks no values (insert them)")
        return torch.from_numpy(self._values).to(self.device)

    # -- adoption ------------------------------------------------------------

    @classmethod
    def from_index(cls, index: HilbertIndex, *, values=None,
                   buffer_capacity: int = 4096, max_segments: int = 8
                   ) -> "MutableHilbertIndex":
        """Adopt a prebuilt immutable index as segment 0 (ids = 0..n-1), on
        the index's device.

        If the index was built with ``store_points=False`` it can serve and
        absorb inserts/deletes, but compactions touching segment 0 raise.
        """
        self = cls(config=index.config, buffer_capacity=buffer_capacity,
                   max_segments=max_segments, device=index.device)
        n = index.n_points
        self._dim = index.dim
        self._buf_points = np.zeros((self.buffer_capacity, self._dim), np.float32)
        self._buf_ids = np.full((self.buffer_capacity,), -1, np.int32)
        self._next_id = n
        self._alive = np.ones((n,), np.bool_)
        if values is not None:
            vals = _host(values)
            if vals.shape[:1] != (n,):
                raise ValueError(f"values must be ({n}, ...)")
            self._values = vals.copy()
        # Pin the values mode now: ids 0..n-1 are already assigned.
        self._track_values = values is not None
        self.segments = [Segment(index=index, ids=np.arange(n, dtype=np.int32), gen=0)]
        self._gen = 1
        return self

    # -- persistence ---------------------------------------------------------

    def save(self, path: str, *, kind: str = _DEFAULT_KIND,
             extra_meta: Optional[Dict] = None) -> str:
        return save_mutable_bundle(self, path, kind=kind, extra_meta=extra_meta)

    @classmethod
    def load(cls, path: str, *, kind: str = _DEFAULT_KIND,
             device: DeviceLike = None) -> "MutableHilbertIndex":
        """Load a mutable index saved by either package, then replay its WAL."""
        index, _ = load_mutable_bundle(path, kind=kind, device=device)
        return index


def save_mutable_bundle(index: MutableHilbertIndex, path: str, *,
                        kind: str = _DEFAULT_KIND,
                        extra_meta: Optional[Dict] = None) -> str:
    """Persist a mutable index as segment bundles + state bundle + manifest.

    Nothing a previous manifest references is rewritten in place: a
    segment bundle whose uid matches is skipped, the buffer/tombstone
    state goes to a fresh step, and the top-level manifest is renamed into
    place LAST.  Afterwards bundles referenced by neither the new nor the
    previous manifest are pruned, and the WAL restarts empty.
    """
    os.makedirs(path, exist_ok=True)
    prev_manifest = {}
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            prev_manifest = json.load(f)
    except (OSError, ValueError):
        pass
    seg_names = []
    for seg in index.segments:
        name = f"seg_{seg.gen:06d}"
        seg_dir = os.path.join(path, "segments", name)
        uid = seg.content_uid()
        if _segment_bundle_uid(seg_dir) != uid:
            save_index_bundle(seg.index, seg_dir, kind=_SEGMENT_KIND,
                              extra_arrays={"ids": seg.ids},
                              extra_meta={"segment_uid": uid, "n_valid": seg.n_real})
        seg_names.append(name)
    # Buffer state: the raw occupied slice, tombstoned rows included, so a
    # load reconstructs the same buffer occupancy (later flushes fall at the
    # same ops — what WAL recovery's bit-equality rests on).
    d = index._dim if index._dim is not None else 0
    n = index._buf_count
    state: Dict[str, np.ndarray] = {
        "alive": index._alive,
        "buffer_points": (index._buf_points[:n].copy() if n
                          else np.zeros((0, d), np.float32)),
        "buffer_ids": index._buf_ids[:n].copy() if n else np.zeros((0,), np.int32),
    }
    if index._values is not None:
        state["values"] = index._values
    state_dir = os.path.join(path, "state")
    state_step = (bundle.latest_step(state_dir) or 0) + 1
    bundle.save(state_dir, state_step, state, extra={})
    manifest = {
        "state_step": state_step,
        "kind": kind,
        "format_version": 1,
        "config": index.config.to_dict(),
        "buffer_capacity": index.buffer_capacity,
        "max_segments": index.max_segments,
        "next_id": int(index._next_id),
        "gen": int(index._gen),
        "dim": index._dim,
        "track_values": index._track_values,
        "segments": seg_names,
        "extra_meta": extra_meta or {},
    }
    fault_point("mutable.save.pre_manifest", path=os.path.join(path, _MANIFEST))
    bundle.atomic_write_json(os.path.join(path, _MANIFEST), manifest)
    _prune_unreferenced(path, manifest, prev_manifest)
    # The manifest now covers every acknowledged write.  A crash between
    # the commit and this truncate replays records whose next_id
    # watermarks make them no-ops.
    if index._wal is not None:
        index._wal.truncate()
    return path


def _prune_unreferenced(path: str, manifest: Dict, prev_manifest: Dict) -> None:
    """Drop bundles neither the new nor the previous manifest references."""
    keep_segs = set(manifest["segments"]) | set(prev_manifest.get("segments", []))
    seg_root = os.path.join(path, "segments")
    if os.path.isdir(seg_root):
        for name in os.listdir(seg_root):
            if name.startswith("seg_") and name not in keep_segs:
                shutil.rmtree(os.path.join(seg_root, name), ignore_errors=True)
    bundle.prune_steps(os.path.join(path, "state"),
                       {manifest["state_step"], prev_manifest.get("state_step")})


def _segment_bundle_uid(seg_dir: str) -> Optional[str]:
    """uid of an already-saved segment bundle, or None if absent/unreadable."""
    step = bundle.latest_step(seg_dir)
    if step is None:
        return None
    try:
        return bundle.read_manifest(seg_dir, step).get("extra", {}).get("segment_uid")
    except (OSError, ValueError):
        return None


def _restore_state_bundle(path: str, step: Optional[int]) -> Dict[str, np.ndarray]:
    """Every leaf of a state bundle, as writable numpy arrays."""
    if step is None:  # manifests without state_step: newest available
        step = bundle.latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no state bundle under {path!r}")
    manifest = bundle.read_manifest(path, step)
    names = [key[2:-2] for key in manifest["leaves"]]  # "['name']" -> name
    arrays, _ = bundle.restore(path, step, names)
    # Owned copies: deletes and WAL replay mutate this state in place.
    return {k: np.array(v) for k, v in arrays.items()}


def load_mutable_bundle(path: str, *, kind: str = _DEFAULT_KIND,
                        device: DeviceLike = None
                        ) -> Tuple[MutableHilbertIndex, Dict]:
    """Inverse of :func:`save_mutable_bundle`; returns (index, extra_meta)."""
    dev = resolve_device(device)
    mpath = os.path.join(path, _MANIFEST)
    if not os.path.exists(mpath):
        raise FileNotFoundError(f"no mutable-index manifest under {path!r}")
    with open(mpath) as f:
        manifest = json.load(f)
    if manifest.get("kind") != kind:
        raise ValueError(
            f"{path!r} is not a mutable-index checkpoint of kind {kind!r} "
            f"(kind={manifest.get('kind')!r})"
        )
    index = MutableHilbertIndex(
        config=IndexConfig.from_dict(manifest["config"]),
        buffer_capacity=int(manifest["buffer_capacity"]),
        max_segments=int(manifest["max_segments"]),
        device=dev,
    )
    for name in manifest["segments"]:
        seg_index, extras, seg_meta = load_index_bundle(
            os.path.join(path, "segments", name), kind=_SEGMENT_KIND, device=dev)
        index.segments.append(Segment(
            index=seg_index,
            ids=np.asarray(extras["ids"], np.int32),
            gen=int(name.split("_")[1]),
            n_valid=int(seg_meta.get("n_valid", -1)),
        ))
    state = _restore_state_bundle(os.path.join(path, "state"),
                                  manifest.get("state_step"))
    index._alive = np.asarray(state["alive"], np.bool_)
    index._next_id = int(manifest["next_id"])
    index._gen = int(manifest["gen"])
    index._track_values = manifest.get("track_values")
    if "values" in state:
        index._values = state["values"]
    dim = manifest.get("dim")
    if dim is not None:
        index._dim = int(dim)
        index._buf_points = np.zeros((index.buffer_capacity, index._dim), np.float32)
        index._buf_ids = np.full((index.buffer_capacity,), -1, np.int32)
        bpts, bids = state["buffer_points"], state["buffer_ids"]
        m = int(bids.shape[0])
        if m:
            index._buf_points[:m] = bpts
            index._buf_ids[:m] = bids
        index._buf_count = m
    _recover_wal(index, path)
    return index, manifest.get("extra_meta", {})


def _recover_wal(index: MutableHilbertIndex, path: str) -> None:
    """Replay + re-attach ``<path>/wal.log`` if the index was WAL-enabled."""
    wfile = wal_lib.wal_path(path)
    if not os.path.exists(wfile):
        return
    records, wal = wal_lib.open_and_recover(wfile)
    replay_wal_records(index, records)
    index._wal = wal


def replay_wal_records(index, records) -> int:
    """Apply WAL records to a WAL-less index; returns ops applied.

    Inserts whose ``next_id`` watermark the restored state already covers
    are skipped; deletes are idempotent.
    """
    if getattr(index, "_wal", None) is not None:
        raise ValueError("detach the WAL before replaying records into it")
    applied = 0
    for rec in records:
        if rec.op in ("insert", "bulk_load"):
            wm = rec.meta.get("next_id")
            if wm is not None and wm < index._lsm.next_id:
                continue  # the restored checkpoint already contains it
            vals = rec.arrays.get("values")
            if rec.op == "bulk_load":
                index.bulk_load(rec.arrays["points"], vals)
            else:
                index.insert(rec.arrays["points"], vals)
        elif rec.op == "delete":
            index.delete(rec.arrays["ids"])
        else:
            raise wal_lib.WalError(f"unknown WAL op {rec.op!r}")
        applied += 1
    return applied
