"""ShardedMutableHilbertIndex: shard-local LSM writes on the partitioned forest.

Port of ``repro.index.sharded_mutable``.  The JAX package spreads the
shards over a mesh's ``data`` axis and searches inside ``shard_map``; here
the S shards are logical shards of one device, their per-shard arrays
stacked on a leading axis (:class:`repro_torch.index.sharded.ShardStack`),
and the one exchange between them, the cross-shard merge, goes through
:class:`repro_torch.core.shard_group.ShardGroup`.  The same operations
give the same state in both packages, bit for bit.

* **Per-shard write buffers**: every shard owns a fixed-capacity host
  buffer slice; an insert is routed to the shard owning its master-curve
  range (:func:`repro_torch.core.distributed.route_to_shards` against the
  partition's opening keys, frozen at build or compaction), or round-robin
  while no bounds exist (an index born empty).
* **Sealed generations**: when any shard's buffer fills (or on
  :meth:`flush`), every shard's live buffered rows seal together into one
  generation: per-shard :class:`HilbertIndex` builds sharing one quantizer
  fit over the union, stacked ``(S, ...)``.  Shards pad to the
  generation's largest row count with cyclic copies that keep their real
  external ids; a shard with no rows holds copies of the generation's
  smallest-id row.  Duplicates collapse in the merge.
* **Tombstones**: the dense by-id ``alive`` mask of
  :class:`repro_torch.index.mutable.LsmIdSpace`, mirrored on the device
  padded to a power-of-two capacity.
* **Search**: per query chunk, each shard runs
  :func:`repro_torch.core.search.fused_search_chunk` over every
  generation (``k`` inflated by the generation's padding and a pow2 bucket
  of its worst per-shard tombstone count) and brute-forces its buffer
  slice; hits map to external ids and dead ones are masked on the device,
  and the shards reduce through
  :func:`repro_torch.core.distributed.cross_shard_merge_topk`.  Nothing
  in the loop copies to the host.
* **Compaction**: :meth:`compact` gathers the survivors in external-id
  order and calls :meth:`ShardedHilbertIndex.build` over them, so rows
  rebalance across shards and search afterwards is bit-equal to a fresh
  sharded build.  Tier merges stay shard-local.

Checkpoints are the JAX package's format 4: one ordinary index bundle per
(generation, shard), a buffer/tombstone sidecar bundle, and one manifest
renamed into place last.  Format-3 sharded checkpoints are adopted on
load, and another shard count reshards by compacting on load.  Bundles of
either package load in the other.

``repro`` reads one shard of a sharded array on the host at
``_owned_rows``, ``_seg_shard_uid`` and ``shard_index_from_stack``, which
raises under jax 0.9.0 on several devices; the port reads shards from its
stacked tensors.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import bundle
from repro_torch.checkpoint import wal as wal_lib
from repro_torch.core import distributed as distributed_lib
from repro_torch.core import quantize
from repro_torch.core import search as search_lib
from repro_torch.core.shard_group import ShardGroup
from repro_torch.core.types import SearchParams
from repro_torch.index.config import IndexConfig
from repro_torch.index.convert import load_index_bundle
from repro_torch.index.facade import (BACKENDS, DeviceLike, HilbertIndex, _pow2_bucket,
                                      build_with_timings, resolve_device,
                                      save_index_bundle)
from repro_torch.index.mutable import (LsmIdSpace, WalFacade, _host, _recover_wal,
                                       _restore_state_bundle)
from repro_torch.index.sharded import (ShardedHilbertIndex, ShardStack,
                                       shard_index_from_stack, stack_shard_indexes)
from repro_torch.obs.dispatch import dispatch_scope
from repro_torch.obs.trace import span
from repro_torch.testing.faults import fault_point

__all__ = [
    "ShardedMutableHilbertIndex",
    "ShardedSegment",
    "load_sharded_mutable_as_mutable",
    "load_sharded_mutable_bundle",
    "save_sharded_mutable_bundle",
]

_MANIFEST = "sharded_mutable_manifest.json"
_STATIC_MANIFEST = "sharded_manifest.json"  # format-3 adoption
_SEG_SHARD_KIND = "sharded_mutable_segment_shard"
_DEFAULT_KIND = "sharded_mutable_hilbert_index"
_FORMAT_VERSION = 4


def _pow2_ceil(x: int) -> int:
    """0 for x <= 0, else the smallest power of two >= x."""
    return 0 if x <= 0 else 1 << (int(x) - 1).bit_length()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _resolve_shards(config: IndexConfig, n_shards: Optional[int]) -> int:
    """The shard count: ``n_shards``, else ``config.shards``; at least 2."""
    if n_shards is None:
        n_shards = config.shards if config.shards is not None else 1
    if config.shards is not None and config.shards != n_shards:
        raise ValueError(f"config.shards={config.shards} != n_shards={n_shards}")
    if n_shards < 2:
        raise ValueError(
            "ShardedMutableHilbertIndex needs a multi-device 'data' mesh; "
            "on one device use MutableHilbertIndex"
        )
    return int(n_shards)


@dataclasses.dataclass(eq=False)  # identity equality: segments hold tensors
class ShardedSegment:
    """One sealed cross-shard generation: stacked per-shard indexes + id map.

    ``stack.id_map`` (and its host copy ``ids_host``) maps each shard-local
    row, cyclic padding included, to its stable external id.
    """

    stack: ShardStack  # (S, ...) leaves on the index's device; id_map = ext ids
    points: Optional[torch.Tensor]  # (S, n_pad, d) fp32; None without store_points
    quant: quantize.Quantizer  # generation-global
    gen: int  # monotone generation tag (on-disk name)
    n_valid: np.ndarray  # (S,) owned-row counts (before padding)
    pad_max: int  # largest padding among shards that own rows
    ids_host: np.ndarray  # (S, n_pad) int32 ext ids, padding included
    # worst-per-shard dead-count cache, keyed by the owner's delete epoch
    dead_cache: int = dataclasses.field(default=-1, repr=False)
    dead_epoch: int = dataclasses.field(default=-1, repr=False)

    @property
    def n_pad(self) -> int:
        return int(self.ids_host.shape[1])

    @property
    def n_owned(self) -> int:
        return int(self.n_valid.sum())


class ShardedMutableHilbertIndex(WalFacade):
    """Streaming insert/delete/search over a row-partitioned Hilbert forest.

    Typical lifecycle (S >= 2 logical shards of one device; with one shard
    use :class:`repro_torch.index.MutableHilbertIndex`)::

        idx = ShardedMutableHilbertIndex.build(points, IndexConfig(), n_shards=4)
        ids = idx.insert(fresh)            # routed to curve-owning shards
        idx.delete(ids[:10])               # tombstoned, invisible to search
        hits, d2 = idx.search(queries, SearchParams(k=30))
        idx.compact()                      # rebalanced == fresh sharded build
        idx.save(path); idx = ShardedMutableHilbertIndex.load(path)

    Generations live on ``device`` (the GPU unless ``device="cpu"``; without
    a GPU it raises); the write buffers, tombstones, values and id maps
    stay host numpy.  External ids are stable for the life of the index.
    """

    def __init__(self, config: Optional[IndexConfig] = None, *,
                 n_shards: Optional[int] = None, buffer_capacity: int = 1024,
                 max_segments: int = 8, device: DeviceLike = None):
        if buffer_capacity < 1:
            raise ValueError(f"buffer_capacity must be >= 1, got {buffer_capacity}")
        if max_segments < 1:
            raise ValueError(f"max_segments must be >= 1, got {max_segments}")
        self.config = IndexConfig() if config is None else config
        n_shards = _resolve_shards(self.config, n_shards)
        self.device = resolve_device(device)
        self.group = ShardGroup(n_shards, self.device)
        self.buffer_capacity = int(buffer_capacity)
        self.max_segments = int(max_segments)
        self.segments: List[ShardedSegment] = []
        self._lsm = LsmIdSpace()
        self._dim: Optional[int] = None
        self._buf_pts: Optional[np.ndarray] = None  # (S, B, d) fp32 host
        self._buf_ids: Optional[np.ndarray] = None  # (S, B) int32 host
        self._buf_count: Optional[np.ndarray] = None  # (S,) int64
        self._dev_buf = None  # device mirror of the buffers, lazy
        self._perms: Optional[torch.Tensor] = None  # shared forest seed
        self._flips: Optional[torch.Tensor] = None
        self._bounds: Optional[torch.Tensor] = None  # (S-1, W) int32 curve keys
        self._route_lo: Optional[torch.Tensor] = None  # (d,) partition box
        self._route_hi: Optional[torch.Tensor] = None
        self._rr = 0  # round-robin cursor
        self._gen = 0
        self._alive_key = None
        self._alive_dev = None
        self.last_dispatch_count = 0
        self._wal: Optional[wal_lib.WriteAheadLog] = None

    # -- introspection -------------------------------------------------------

    @property
    def n_shards(self) -> int:
        return self.group.size

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
        """Live points still in the per-shard write buffers."""
        if self._buf_count is None:
            return 0
        return sum(int(np.count_nonzero(self._lsm.alive[self._buf_ids[s, :c]]))
                   for s, c in enumerate(self._buf_count.tolist()) if c)

    def memory_report(self) -> Dict[str, object]:
        """Bytes of all resident state, split sharded vs replicated, with
        ``repro``'s keys.  ``per_device_bytes`` lists what each shard would
        hold on a card of its own (all S share this index's device)."""
        s = self.n_shards
        per_segment, sharded, replicated = [], 0, 0
        for seg in self.segments:
            leaves = list(seg.stack) + ([seg.points] if seg.points is not None else [])
            b = sum(_nbytes(leaf) for leaf in leaves)
            per_segment.append(b)
            sharded += b
            replicated += _nbytes(seg.quant.boundaries) + _nbytes(seg.quant.centroids)
        if self._perms is not None:
            replicated += _nbytes(self._perms) + _nbytes(self._flips)
        # the device tombstone mask at its pow2-padded capacity (1 byte a slot)
        replicated += max(1024, _pow2_ceil(self._lsm.next_id))
        buffer_bytes = 0
        if self._buf_pts is not None:
            buffer_bytes = self._buf_pts.nbytes + self._buf_ids.nbytes
        sharded += buffer_bytes
        rep: Dict[str, object] = {
            "n_shards": s,
            "segments_bytes": int(sum(per_segment)),
            "per_segment": [int(b) for b in per_segment],
            "buffer_bytes": int(buffer_bytes),
            "values_bytes": 0 if self._lsm.values is None else int(self._lsm.values.nbytes),
            "tombstone_bytes": int(self._lsm.alive.nbytes),
            "sharded_bytes": int(sharded),
            "replicated_bytes": int(replicated),
            "n_segments": self.n_segments,
            "n_live": self.n_live,
            "n_deleted": self.n_deleted,
            "n_buffered": self.n_buffered,
        }
        rep["total_bytes"] = (rep["sharded_bytes"] + rep["replicated_bytes"]
                              + rep["values_bytes"] + rep["tombstone_bytes"])
        rep["per_device_bytes"] = [sharded // s + replicated] * s
        return rep

    def __repr__(self) -> str:
        mb = self.memory_report()["total_bytes"] / 1e6
        return (
            f"ShardedMutableHilbertIndex(n_live={self.n_live}, "
            f"n_shards={self.n_shards}, n_segments={self.n_segments}, "
            f"buffered={self.n_buffered}/{self.n_shards}x{self.buffer_capacity}, "
            f"deleted={self.n_deleted}, dim={self._dim}, device={self.device}, "
            f"{mb:.2f} MB)"
        )

    # -- construction --------------------------------------------------------

    @classmethod
    def build(cls, points, config: Optional[IndexConfig] = None, *,
              n_shards: Optional[int] = None, values=None,
              buffer_capacity: int = 1024, max_segments: int = 8,
              device: DeviceLike = None) -> "ShardedMutableHilbertIndex":
        """Build from an initial corpus: one balanced partitioned base.

        Args:
          points: (n, d) fp32 corpus; rows get external ids ``0..n-1``.
          config: build config.  ``store_points=True`` (the default) keeps
            raw points so tier merges and the rebalancing compaction can
            re-sort them; ``False`` serves lean, but inserts route
            round-robin and maintenance raises.
          n_shards: logical shard count (default ``config.shards``), >= 2.
          values: optional (n, ...) per-point payloads.
          buffer_capacity: write-buffer rows a shard.
          max_segments: sealed-generation cap before tier merging.
          device: ``None`` (the GPU; raises without one) or any torch device.

        Its initial search equals a :class:`ShardedHilbertIndex` built by
        the same call.
        """
        if config is None:
            config = IndexConfig()
        base = ShardedHilbertIndex.build(points, config,
                                         n_shards=_resolve_shards(config, n_shards),
                                         device=device)
        return cls.from_sharded(base, values=values, buffer_capacity=buffer_capacity,
                                max_segments=max_segments)

    @classmethod
    def from_sharded(cls, base: ShardedHilbertIndex, *, values=None,
                     buffer_capacity: int = 1024, max_segments: int = 8
                     ) -> "ShardedMutableHilbertIndex":
        """Adopt a static sharded index as generation 0 (ids ``0..n-1``), on
        its device.

        The partition's opening keys are recovered from the stored points so
        inserts route to the curve-owning shards; a base built with
        ``store_points=False`` adopts too, but routes round-robin and
        maintenance touching generation 0 raises.
        """
        if base.single is not None:
            raise ValueError(
                "from_sharded needs a multi-shard index; wrap a 1-shard "
                "index with MutableHilbertIndex.from_index instead"
            )
        self = cls(config=base.config, n_shards=base.n_shards,
                   buffer_capacity=buffer_capacity, max_segments=max_segments,
                   device=base.device)
        n = base.n_points
        vals = self._lsm.validate(n, values)
        self._dim = int(base.dim)
        self._alloc_buffers()
        self._lsm.register(n, vals)
        self._adopt_base(base, np.arange(n, dtype=np.int32))
        return self

    def _alloc_buffers(self) -> None:
        s = self.n_shards
        self._buf_pts = np.zeros((s, self.buffer_capacity, self._dim), np.float32)
        self._buf_ids = np.full((s, self.buffer_capacity), -1, np.int32)
        self._buf_count = np.zeros((s,), np.int64)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A device copy of a host array (never a view of host memory that
        a later write would change)."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device, copy=True)

    def _adopt_base(self, base: ShardedHilbertIndex, gids: np.ndarray) -> None:
        """Wrap a fresh static build as a sealed generation + routing bounds.

        ``gids[row]`` is the external id of the base corpus's row-th point.
        """
        id_host = base.stack.id_map.cpu().numpy()
        ext_host = np.asarray(gids, np.int32)[id_host]
        stack = base.stack
        if not np.array_equal(ext_host, id_host):
            stack = stack._replace(id_map=self._to_device(ext_host))
        self.segments.append(ShardedSegment(
            stack=stack, points=base.points, quant=base.quant, gen=self._gen,
            n_valid=np.asarray(base.n_valid, np.int64), pad_max=int(base.pad_max),
            ids_host=ext_host,
        ))
        self._gen += 1
        self._perms, self._flips = base.perms, base.flips
        if base.points is None:
            # No stored points to recover the opening keys from: inserts
            # route round-robin until the next full build.
            self._bounds = None
            return
        # Shard s's first owned row is its lowest point on the master curve.
        nv = [int(v) for v in base.n_valid]
        own = torch.cat([base.points[s, : nv[s]] for s in range(self.n_shards) if nv[s]])
        lo, hi = own.amin(0), own.amax(0)
        firsts = [base.points[s, 0] if nv[s] else None for s in range(self.n_shards)]
        self._bounds = distributed_lib.curve_partition_bounds(
            firsts, self.config.forest, lo, hi)
        self._route_lo, self._route_hi = lo, hi

    # -- mutation ------------------------------------------------------------

    def _register(self, points, values) -> Tuple[np.ndarray, np.ndarray]:
        """Shared insert bookkeeping; ``prepare`` validates everything before
        any state changes."""
        pts, vals = self._lsm.prepare(points, values, self._dim)
        if pts.shape[0] == 0:
            return pts, np.zeros((0,), np.int32)
        if self._dim is None:
            self._dim = int(pts.shape[1])
            self._alloc_buffers()
        return pts, self._lsm.register(pts.shape[0], vals)

    def _route(self, pts: np.ndarray) -> np.ndarray:
        """Owning shard of each row: curve bounds when known, else round-robin."""
        if self._bounds is None:
            out = (np.arange(pts.shape[0]) + self._rr) % self.n_shards
            self._rr = int((self._rr + pts.shape[0]) % self.n_shards)
            return out.astype(np.int32)
        return distributed_lib.route_to_shards(
            pts, self.config.forest, self._route_lo, self._route_hi, self._bounds,
        ).cpu().numpy()

    def insert(self, points, values=None) -> np.ndarray:
        """Insert points (m, d); returns their stable external ids (m,).

        Each row lands in the write buffer of the shard owning its
        master-curve range (searchable immediately, exactly); whenever a
        shard's buffer fills, all shards' buffered rows seal into one
        generation, and tier merging keeps at most ``max_segments``.  With a
        WAL attached the insert is logged before any state changes.
        """
        self._wal_log_insert("insert", points, values)
        pts, ids = self._register(points, values)
        m = pts.shape[0]
        if m == 0:
            return ids
        routes = self._route(pts)
        todo = np.ones((m,), np.bool_)
        while todo.any():
            for s in range(self.n_shards):
                idx = np.nonzero(todo & (routes == s))[0]
                if idx.size == 0:
                    continue
                c = int(self._buf_count[s])
                take = idx[: self.buffer_capacity - c]
                if take.size:
                    sl = slice(c, c + take.size)
                    self._buf_pts[s, sl] = pts[take]
                    self._buf_ids[s, sl] = ids[take]
                    self._buf_count[s] = c + take.size
                    todo[take] = False
            if int(self._buf_count.max()) >= self.buffer_capacity:
                self.flush()
        self._dev_buf = None
        self._maybe_merge_tiers()
        return ids

    def bulk_load(self, points, values=None) -> np.ndarray:
        """Seal a whole corpus at once, bypassing the write buffers.

        On an empty index this is :meth:`build`; on a live one the corpus
        seals as one generation, routed by the existing bounds.
        """
        self._wal_log_insert("bulk_load", points, values)
        had_content = bool(self.segments) or self.n_buffered > 0
        pts, ids = self._register(points, values)
        if pts.shape[0] == 0:
            raise ValueError("bulk_load needs a non-empty (m, d) corpus")
        if not had_content:
            base = ShardedHilbertIndex.build(pts, self.config, n_shards=self.n_shards,
                                             device=self.device)
            self._adopt_base(base, ids)
            return ids
        routes = self._route(pts)
        self._seal([(ids[routes == s], self._to_device(pts[routes == s]))
                    for s in range(self.n_shards)])
        self._maybe_merge_tiers()
        return ids

    def delete(self, ids) -> int:
        """Tombstone external ids; returns how many were newly deleted.

        Unknown ids raise ``KeyError``; repeats are idempotent.
        """
        self._wal_log_delete(ids)
        return self._lsm.delete(ids)

    # -- generation lifecycle ------------------------------------------------

    def _seal(self, rows: Sequence[Tuple[np.ndarray, torch.Tensor]],
              quant: Optional[quantize.Quantizer] = None, *, pad: bool = False
              ) -> Optional[ShardedSegment]:
        """Seal per-shard (ids, device points) rows into one generation.

        Shards pad with cyclic copies of their own rows; a shard with no
        rows holds copies of the generation's smallest-id row.  One
        quantizer, fit over the union unless given, serves every shard.
        With ``pad=True`` and ``config.seal_pow2`` the row count rounds up
        to a power of two (more cyclic copies; ``pad_max`` absorbs them).
        """
        n_valid = np.asarray([ids.size for ids, _ in rows], np.int64)
        if int(n_valid.sum()) == 0:
            return None
        n_pad = int(n_valid.max())
        if pad and self.config.seal_pow2:
            n_pad = _pow2_ceil(max(n_pad, 1))
        all_ids = np.concatenate([ids for ids, _ in rows])
        all_pts = torch.cat([pts for _, pts in rows])
        j = int(np.argmin(all_ids))
        e0, p0 = np.int32(all_ids[j]), all_pts[j]
        if quant is None:
            quant = quantize.fit(all_pts, bits=self.config.quantizer.bits,
                                 sample_limit=self.config.quantizer.sample_limit)
        id_maps = np.zeros((self.n_shards, n_pad), np.int32)
        shard_indexes = []
        for s, (ids_s, pts_s) in enumerate(rows):
            if ids_s.size == 0:
                id_maps[s] = e0
                pts_pad = p0[None, :].expand(n_pad, -1)
            else:
                reps = -(-n_pad // ids_s.size)
                id_maps[s] = np.tile(ids_s.astype(np.int32), reps)[:n_pad]
                pts_pad = pts_s.repeat(reps, 1)[:n_pad]
            with span("lsm.generation_build", rows=n_pad, shard=s), \
                    dispatch_scope("lsm.generation_build"):
                idx, _ = build_with_timings(pts_pad.contiguous(), self.config,
                                            quant=quant, device=self.device)
            shard_indexes.append(idx)
        stack, points = stack_shard_indexes(shard_indexes, id_maps,
                                            store_points=self.config.store_points)
        seg = ShardedSegment(
            stack=stack, points=points, quant=quant, gen=self._gen, n_valid=n_valid,
            pad_max=int(max((n_pad - int(v) for v in n_valid if v > 0), default=0)),
            ids_host=id_maps,
        )
        self._gen += 1
        if self._perms is None:
            self._perms = shard_indexes[0].forest.perms
            self._flips = shard_indexes[0].forest.flips
        self.segments.append(seg)
        return seg

    def flush(self) -> Optional[ShardedSegment]:
        """Seal every shard's live buffered rows into one generation.

        Dead buffer rows drop here for good.  No-op (returns None) when all
        buffers are empty or fully tombstoned.
        """
        if self._buf_count is None or int(self._buf_count.sum()) == 0:
            return None
        rows = []
        for s in range(self.n_shards):
            c = int(self._buf_count[s])
            ids_s = self._buf_ids[s, :c]
            live = self._lsm.alive[ids_s]
            rows.append((ids_s[live].copy(), self._to_device(self._buf_pts[s, :c][live])))
        self._buf_count[:] = 0
        self._buf_ids[:] = -1
        self._dev_buf = None
        return self._seal(rows, pad=True)

    def _owned_rows(self, seg: ShardedSegment, s: int
                    ) -> Tuple[np.ndarray, torch.Tensor]:
        """Shard s's owned (pre-padding) external ids (host) and points
        (a view of the stacked device tensor)."""
        if seg.points is None:
            raise ValueError(
                "cannot re-sort a generation built without stored points "
                "(IndexConfig(store_points=False), or a store_points=False "
                "index adopted via from_sharded)"
            )
        nv = int(seg.n_valid[s])
        return seg.ids_host[s, :nv], seg.points[s, :nv]

    def _live_in_id_order(self, ids: np.ndarray, pts: torch.Tensor
                          ) -> Tuple[np.ndarray, torch.Tensor]:
        """The live rows of (ids, points), sorted by external id (stable)."""
        keep = np.flatnonzero(self._lsm.alive[ids])
        keep = keep[np.argsort(ids[keep], kind="stable")]
        rows = torch.from_numpy(keep).to(self.device)
        return ids[keep].astype(np.int32), pts[rows]

    def _merge_segments(self, to_merge: Sequence[ShardedSegment]
                        ) -> Optional[ShardedSegment]:
        """Replace ``to_merge`` with one generation; tombstoned rows vanish.

        Shard-local: each shard's new rows are its own rows of the merged
        generations, re-sorted by external id; only :meth:`compact` moves
        rows between shards.
        """
        rows = []
        for s in range(self.n_shards):
            owned = [self._owned_rows(seg, s) for seg in to_merge]
            rows.append(self._live_in_id_order(np.concatenate([i for i, _ in owned]),
                                               torch.cat([p for _, p in owned])))
        self.segments = [x for x in self.segments if x not in to_merge]
        return self._seal(rows, pad=True)

    def _maybe_merge_tiers(self) -> None:
        while len(self.segments) > self.max_segments:
            # Only generations holding raw points can be re-sorted.
            mergeable = [g for g in self.segments if g.points is not None]
            if len(mergeable) < 2:
                return
            smallest = sorted(mergeable, key=lambda g: g.n_owned)[:2]
            self._merge_segments(smallest)

    def compact(self) -> "ShardedMutableHilbertIndex":
        """Full compaction: re-partition and rebalance the survivors.

        Every live row (generations and buffers) is gathered in external-id
        order and rebuilt with :meth:`ShardedHilbertIndex.build`, so search
        afterwards is bit-equal to a fresh sharded build over the surviving
        points.  Raises if a generation has no stored points.  Returns self.
        """
        ids, pts = self._gather_live()
        if self._buf_count is not None:
            self._buf_count[:] = 0
            self._buf_ids[:] = -1
        self._dev_buf = None
        self.segments = []
        if ids.size == 0:
            self._bounds = None
            return self
        with span("lsm.compact", rows=int(ids.size)), dispatch_scope("lsm.compact"):
            base = ShardedHilbertIndex.build(pts, self.config, n_shards=self.n_shards,
                                             device=self.device)
            self._adopt_base(base, ids)
        return self

    # -- serving-engine hooks ------------------------------------------------

    def snapshot(self) -> "ShardedMutableHilbertIndex":
        """Shared-generation copy for off-path maintenance.

        Sealed generations are immutable, so their stacked tensors are
        shared under fresh :class:`ShardedSegment` wrappers (dead-count
        caches must not race between the serving copy and the shadow); the
        buffers, routing bounds and bookkeeping are copied.  The WAL is not
        carried over: the engine moves it at the swap.
        """
        snap = ShardedMutableHilbertIndex(
            config=self.config, n_shards=self.n_shards,
            buffer_capacity=self.buffer_capacity, max_segments=self.max_segments,
            device=self.device,
        )
        snap._dim = self._dim
        if self._buf_pts is not None:
            snap._buf_pts = self._buf_pts.copy()
            snap._buf_ids = self._buf_ids.copy()
            snap._buf_count = self._buf_count.copy()
        snap._lsm = self._lsm.clone()
        snap._gen = self._gen
        snap._perms, snap._flips = self._perms, self._flips
        snap._rr = self._rr
        if self._bounds is not None:
            snap._bounds = self._bounds.clone()
            snap._route_lo = self._route_lo.clone()
            snap._route_hi = self._route_hi.clone()
        snap.segments = [
            ShardedSegment(stack=seg.stack, points=seg.points, quant=seg.quant,
                           gen=seg.gen, n_valid=seg.n_valid.copy(),
                           pad_max=seg.pad_max, ids_host=seg.ids_host)
            for seg in self.segments
        ]
        return snap

    def maintenance_stats(self) -> Dict[str, object]:
        """The trigger signals a background maintainer watches (host-only)."""
        next_id = max(self._lsm.next_id, 1)
        return {
            "n_segments": self.n_segments,
            "mergeable_segments": sum(1 for g in self.segments if g.points is not None),
            "n_live": self.n_live,
            "n_deleted": self.n_deleted,
            "n_buffered": self.n_buffered,
            "tombstone_ratio": float(self.n_deleted) / float(next_id),
        }

    def _gather_live(self) -> Tuple[np.ndarray, torch.Tensor]:
        """All live (ids host, points on the device), sorted by external id."""
        parts_i, parts_p = [], []
        for seg in self.segments:
            for s in range(self.n_shards):
                ids_s, pts_s = self._owned_rows(seg, s)
                parts_i.append(ids_s)
                parts_p.append(pts_s)
        if self._buf_count is not None:
            for s in range(self.n_shards):
                c = int(self._buf_count[s])
                parts_i.append(self._buf_ids[s, :c])
                parts_p.append(self._to_device(self._buf_pts[s, :c]))
        if not parts_i:
            return (np.zeros((0,), np.int32),
                    torch.zeros((0, self._dim or 0), dtype=torch.float32,
                                device=self.device))
        return self._live_in_id_order(np.concatenate(parts_i), torch.cat(parts_p))

    # -- search --------------------------------------------------------------

    def _segment_dead_max(self, seg: ShardedSegment) -> int:
        """Worst per-shard tombstone count (padding copies included), cached
        between deletes.  Racing readers fill it identically, the value
        before the epoch stamp."""
        if seg.dead_epoch != self._lsm.delete_epoch:
            alive = self._lsm.alive
            seg.dead_cache = max(
                seg.n_pad - int(np.count_nonzero(alive[seg.ids_host[s]]))
                for s in range(self.n_shards)
            )
            seg.dead_epoch = self._lsm.delete_epoch
        return seg.dead_cache

    @staticmethod
    def _pool(seg: ShardedSegment, params: SearchParams) -> int:
        """A generation's stage-2 candidate pool a shard under ``params``."""
        return params.k2 * min(2 * params.h + 1, seg.n_pad)

    def _over_tombstoned(self, seg: ShardedSegment, params: SearchParams) -> bool:
        return (self._segment_dead_max(seg) > max(self._pool(seg, params) - params.k, 0)
                and seg.points is not None)

    def rewrite_pressure(self, params: Optional[SearchParams] = None) -> int:
        """Generations whose tombstones exceed their stage-2 pool under
        ``params``: what ``search(allow_rewrite=True)`` would rewrite,
        surfaced for engines that search with ``allow_rewrite=False``."""
        if params is None:
            params = SearchParams()
        return sum(1 for seg in list(self.segments) if self._over_tombstoned(seg, params))

    def _alive_device(self) -> Tuple[int, torch.Tensor]:
        """The alive mask padded to a pow2 capacity (>= 1024), on the device.

        A lazy mirror keyed by ``(cap, delete_epoch, next_id)``: mutators
        that move the key run exclusively, racing readers at worst both
        copy the same mask, and the value is published before the key.
        """
        cap = max(1024, _pow2_ceil(self._lsm.next_id))
        key = (cap, self._lsm.delete_epoch, self._lsm.next_id)
        dev = self._alive_dev
        if self._alive_key != key or dev is None:
            pad = np.zeros((cap,), np.bool_)
            pad[: self._lsm.next_id] = self._lsm.alive
            dev = torch.from_numpy(pad).to(self.device)
            self._alive_dev = dev  # value BEFORE key
            self._alive_key = key
        return cap, dev

    def _device_buffers(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (S, B, d) buffer points and (S, B) ids on the device; a lazy
        mirror that writers invalidate by assigning None."""
        buf = self._dev_buf
        if buf is None:
            buf = (self._to_device(self._buf_pts), self._to_device(self._buf_ids))
            self._dev_buf = buf
        return buf

    def search(self, queries, params: Optional[SearchParams] = None, *,
               backend: str = "kernel", query_chunk: Optional[int] = None,
               merge: Optional[str] = None, prune: Optional[bool] = None,
               allow_rewrite: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
        """Streaming search over every shard; returns (ext ids (Q, k) int32,
        sq-dists (Q, k)) on the index's device.

        Per query chunk, each shard runs the fused pipeline over each
        generation and a brute force over its buffer slice, dead candidates
        are masked against the device alive mask, and the shards reduce via
        :func:`repro_torch.core.distributed.cross_shard_merge_topk`
        (``merge="auto"|"gather"|"tree"`` and ``prune`` default to the
        config).  Fewer than ``k`` live points pad the tail with id -1 /
        +inf.  ``last_dispatch_count`` is the number of chunks.

        A generation tombstoned past its stage-2 pool is rewritten first
        (shard-local), unless ``allow_rewrite=False`` (the serving engine's
        shared-read-lock path; see :meth:`rewrite_pressure`).
        """
        if params is None:
            params = SearchParams()
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        merge = distributed_lib.resolve_merge(
            merge if merge is not None else self.config.merge, self.n_shards)
        prune = self.config.merge_prune if prune is None else bool(prune)
        if query_chunk is None:
            query_chunk = self.config.query_chunk
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        qn, k = q.shape[0], params.k
        self.last_dispatch_count = 0
        if qn == 0 or self._dim is None or (not self.segments and self.n_buffered == 0):
            return (torch.full((qn, k), -1, dtype=torch.int32, device=self.device),
                    torch.full((qn, k), torch.inf, dtype=torch.float32,
                               device=self.device))
        if allow_rewrite:
            for seg in list(self.segments):
                if self._over_tombstoned(seg, params):
                    self._merge_segments([seg])
        # Per-generation k: padding copies + a pow2 bucket of the worst
        # tombstone count, capped at the pool.
        segs = list(self.segments)
        k_segs = [search_lib.inflate_k(k, seg.pad_max + _pow2_ceil(self._segment_dead_max(seg)),
                                       self._pool(seg, params)) for seg in segs]
        alive_cap, alive = self._alive_device()
        bpts, bids = self._device_buffers()
        outs_i, outs_d = [], []
        for s in range(0, qn, query_chunk):
            chunk = q[s : s + query_chunk]
            m = chunk.shape[0]
            bucket = _pow2_bucket(m, query_chunk)
            if bucket > m:
                chunk = torch.nn.functional.pad(chunk, (0, 0, 0, bucket - m))
            with dispatch_scope("sharded_mutable.search"):
                ids, dists = self._search_chunk(
                    chunk.contiguous(), params, segs, k_segs, alive, alive_cap,
                    bpts, bids, backend == "kernel", merge, prune)
            outs_i.append(ids[:m])
            outs_d.append(dists[:m])
        # one assignment: concurrent readers each publish their own count
        self.last_dispatch_count = len(outs_i)
        return torch.cat(outs_i), torch.cat(outs_d)

    def _search_chunk(self, q, params, segs, k_segs, alive, alive_cap, bpts, bids,
                      use_kernels: bool, merge: str, prune: bool):
        """One chunk on every shard (generations first, then the buffer, as
        ``repro``'s part order), then the cross-shard merge: (Q, k)."""
        fcfg = self.config.forest

        def live_gids(gids, d2):
            live = (gids >= 0) & alive[gids.clamp(0, alive_cap - 1).long()]
            return torch.where(live, gids, -1), torch.where(live, d2, torch.inf)

        parts_g, parts_d = [], []
        for seg, k_seg in zip(segs, k_segs):
            st = seg.stack
            g_s, d_s = [], []
            for s in range(self.n_shards):
                ids_l, d2 = search_lib.fused_search_chunk(
                    q, st.orders[s], st.directories[s], st.lo[s], st.hi[s],
                    self._perms, self._flips, st.master_rank[s], st.sketches[s],
                    st.codes[s], st.master_order[s], seg.quant,
                    bits=fcfg.bits, key_bits=fcfg.key_bits, leaf_size=fcfg.leaf_size,
                    k1=params.k1, k2=params.k2, h=params.h, k=k_seg,
                    use_kernels=use_kernels,
                )
                gids = torch.where(ids_l >= 0, st.id_map[s][ids_l.clamp_min(0).long()], -1)
                g, d = live_gids(gids, d2)
                g_s.append(g)
                d_s.append(d)
            parts_g.append(torch.stack(g_s))
            parts_d.append(torch.stack(d_s))
        k_buf = max(1, min(params.k, self.buffer_capacity))
        g_s, d_s = [], []
        for s in range(self.n_shards):
            bvalid = (bids[s] >= 0) & alive[bids[s].clamp(0, alive_cap - 1).long()]
            with dispatch_scope("lsm.buffer_search"):
                bidx, bd2 = search_lib.brute_force_topk(q, bpts[s], bvalid, k=k_buf)
            g_s.append(torch.where(torch.isfinite(bd2), bids[s][bidx.long()], -1))
            d_s.append(bd2)
        parts_g.append(torch.stack(g_s))
        parts_d.append(torch.stack(d_s))
        out_i, out_d = distributed_lib.cross_shard_merge_topk(
            self.group, torch.cat(parts_g, dim=2), torch.cat(parts_d, dim=2),
            k=params.k, merge=merge, prune=prune)
        return out_i[0], out_d[0]

    # -- values --------------------------------------------------------------

    def values_at(self, ids, fill=0) -> torch.Tensor:
        """Gather per-point values for search-result ids; -1 slots get fill."""
        return self._lsm.values_at(ids, fill=fill)

    def values_dense(self) -> torch.Tensor:
        """The dense by-external-id values array (stale rows where deleted)."""
        if self._lsm.values is None:
            raise ValueError("this index tracks no values (insert them)")
        return torch.from_numpy(self._lsm.values).to(self.device)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str, *, kind: str = _DEFAULT_KIND,
             extra_meta: Optional[Dict] = None) -> str:
        return save_sharded_mutable_bundle(self, path, kind=kind, extra_meta=extra_meta)

    @classmethod
    def load(cls, path: str, *, n_shards: Optional[int] = None,
             kind: str = _DEFAULT_KIND, device: DeviceLike = None
             ) -> "ShardedMutableHilbertIndex":
        """Load a format-4 checkpoint (or adopt a format-3 one), then replay
        its WAL; ``n_shards`` other than the checkpoint's reshards."""
        index, _ = load_sharded_mutable_bundle(path, n_shards=n_shards, kind=kind,
                                               device=device)
        return index


def _seg_shard_uid(seg: ShardedSegment, s: int) -> str:
    """Content address of one (generation, shard) bundle for save dedup:
    ``repro``'s hash (int32 codes have the bytes of its uint32 words)."""
    h = hashlib.sha1()
    h.update(np.int64(seg.gen).tobytes())
    codes = seg.stack.codes[s].cpu().numpy()
    h.update(np.asarray(seg.ids_host[s].shape + codes.shape, np.int64).tobytes())
    h.update(seg.ids_host[s].tobytes())
    h.update(codes.tobytes())
    return h.hexdigest()


def _shard_bundle_uid(seg_dir: str) -> Optional[str]:
    step = bundle.latest_step(seg_dir)
    if step is None:
        return None
    try:
        return bundle.read_manifest(seg_dir, step).get("extra", {}).get("segment_uid")
    except (OSError, ValueError):
        return None


def save_sharded_mutable_bundle(index: ShardedMutableHilbertIndex, path: str, *,
                                kind: str = _DEFAULT_KIND,
                                extra_meta: Optional[Dict] = None) -> str:
    """Persist as per-(generation, shard) bundles + sidecar + one manifest.

    Format 4: one ordinary index bundle per (generation, shard), written
    only when its content uid differs from the one on disk, plus a
    buffer/tombstone/values/bounds sidecar at a fresh step; the manifest
    renames into place last.  Bundles referenced by neither the new nor
    the previous manifest are pruned afterwards, and the WAL restarts.
    """
    os.makedirs(path, exist_ok=True)
    prev_manifest = {}
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            prev_manifest = json.load(f)
    except (OSError, ValueError):
        pass
    s_count = index.n_shards
    seg_entries = []
    for seg in index.segments:
        name = f"gen_{seg.gen:06d}"
        for s in range(s_count):
            shard_dir = os.path.join(path, "segments", name, f"shard_{s:05d}")
            uid = _seg_shard_uid(seg, s)
            if _shard_bundle_uid(shard_dir) != uid:
                shard_index = shard_index_from_stack(
                    index.config, seg.stack, seg.points, seg.quant,
                    index._perms, index._flips, s)
                save_index_bundle(
                    shard_index, shard_dir, kind=_SEG_SHARD_KIND,
                    extra_arrays={"ids": seg.ids_host[s]},
                    extra_meta={"shard": s, "n_shards": s_count,
                                "n_valid": int(seg.n_valid[s]), "segment_uid": uid},
                )
        seg_entries.append({"name": name, "gen": int(seg.gen),
                            "pad_max": int(seg.pad_max),
                            "n_valid": [int(v) for v in seg.n_valid]})
    # Sidecar: occupied buffer rows (tombstoned ones kept, so a load
    # rebuilds the same slots and WAL replay crosses the same flushes),
    # tombstones, values, routing bounds.
    state: Dict[str, np.ndarray] = {"alive": index._lsm.alive}
    if index._lsm.values is not None:
        state["values"] = index._lsm.values
    d = index._dim if index._dim is not None else 0
    bsh, bid, bpt = [], [], []
    if index._buf_count is not None:
        for s in range(s_count):
            c = int(index._buf_count[s])
            bsh.append(np.full((c,), s, np.int32))
            bid.append(index._buf_ids[s, :c].copy())
            bpt.append(index._buf_pts[s, :c].copy())
    state["buffer_shard"] = np.concatenate(bsh) if bsh else np.zeros((0,), np.int32)
    state["buffer_ids"] = np.concatenate(bid) if bid else np.zeros((0,), np.int32)
    state["buffer_points"] = (np.concatenate(bpt) if bpt
                              else np.zeros((0, d), np.float32))
    if index._bounds is not None:
        state["bounds"] = _host(index._bounds).view(np.uint32)
        state["route_lo"] = _host(index._route_lo).astype(np.float32)
        state["route_hi"] = _host(index._route_hi).astype(np.float32)
    state_dir = os.path.join(path, "state")
    state_step = (bundle.latest_step(state_dir) or 0) + 1
    bundle.save(state_dir, state_step, state, extra={})
    manifest = {
        "kind": kind,
        "format_version": _FORMAT_VERSION,
        "config": index.config.to_dict(),
        "n_shards": s_count,
        "buffer_capacity": index.buffer_capacity,
        "max_segments": index.max_segments,
        "next_id": int(index._lsm.next_id),
        "gen": int(index._gen),
        "dim": index._dim,
        "track_values": index._lsm.track_values,
        "has_bounds": index._bounds is not None,
        "state_step": state_step,
        "segments": seg_entries,
        "extra_meta": extra_meta or {},
    }
    fault_point("sharded_mutable.save.pre_manifest", path=os.path.join(path, _MANIFEST))
    bundle.atomic_write_json(os.path.join(path, _MANIFEST), manifest)
    keep = ({e["name"] for e in manifest["segments"]}
            | {e["name"] for e in prev_manifest.get("segments", [])})
    seg_root = os.path.join(path, "segments")
    if os.path.isdir(seg_root):
        for name in os.listdir(seg_root):
            if name.startswith("gen_") and name not in keep:
                shutil.rmtree(os.path.join(seg_root, name), ignore_errors=True)
    bundle.prune_steps(state_dir, {state_step, prev_manifest.get("state_step")})
    # The manifest is the commit point: every record logged before it is
    # covered.  A crash before the truncate replays no-ops (next_id marks).
    if index._wal is not None:
        index._wal.truncate()
    return path


def _read_manifest(path: str, kind: str) -> Dict:
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("kind") != kind:
        raise ValueError(
            f"{path!r} is not a sharded-mutable checkpoint of kind {kind!r} "
            f"(kind={manifest.get('kind')!r})"
        )
    return manifest


def load_sharded_mutable_bundle(path: str, *, n_shards: Optional[int] = None,
                                kind: str = _DEFAULT_KIND, device: DeviceLike = None
                                ) -> Tuple[ShardedMutableHilbertIndex, Dict]:
    """Inverse of :func:`save_sharded_mutable_bundle`; returns (index, meta).

    ``n_shards`` is the target count, by default the checkpoint's own.  The
    same count loads array-identical; another reshards by compacting on
    load (live rows gathered in id order, buffered rows folded in, the
    partition rebuilt).  A directory holding a format-3 static sharded
    checkpoint is adopted via :meth:`ShardedMutableHilbertIndex.from_sharded`.
    The WAL is replayed and re-attached on every path.
    """
    dev = resolve_device(device)
    if not os.path.exists(os.path.join(path, _MANIFEST)):
        if not os.path.exists(os.path.join(path, _STATIC_MANIFEST)):
            raise FileNotFoundError(
                f"no sharded-mutable (v4) or sharded (v3) manifest under {path!r}")
        base = ShardedHilbertIndex.load(path, n_shards=n_shards, device=dev)
        index = ShardedMutableHilbertIndex.from_sharded(base)
        _recover_wal(index, path)
        return index, {}
    manifest = _read_manifest(path, kind)
    config = IndexConfig.from_dict(manifest["config"])
    saved = int(manifest["n_shards"])
    target = saved if n_shards is None else int(n_shards)
    state = _restore_state_bundle(os.path.join(path, "state"), manifest.get("state_step"))

    if target != saved:
        if target == 1:
            raise ValueError(
                "cannot load a sharded-mutable checkpoint onto a 1-device "
                "mesh as ShardedMutableHilbertIndex; use "
                "load_sharded_mutable_as_mutable for the single-device "
                "mutable layout"
            )
        ids, pts = _gather_live_v4(path, manifest, state, dev)
        index = ShardedMutableHilbertIndex(
            config=dataclasses.replace(config, shards=None), n_shards=target,
            buffer_capacity=int(manifest["buffer_capacity"]),
            max_segments=int(manifest["max_segments"]), device=dev,
        )
        _restore_lsm(index, manifest, state)
        index._gen = int(manifest["gen"])
        if manifest.get("dim") is not None:
            index._dim = int(manifest["dim"])
            index._alloc_buffers()
        if ids.size:
            base = ShardedHilbertIndex.build(pts, index.config, n_shards=target,
                                             device=dev)
            index._adopt_base(base, ids)
        _recover_wal(index, path)
        return index, manifest.get("extra_meta", {})

    index = ShardedMutableHilbertIndex(
        config=config, n_shards=saved, buffer_capacity=int(manifest["buffer_capacity"]),
        max_segments=int(manifest["max_segments"]), device=dev,
    )
    _restore_lsm(index, manifest, state)
    index._gen = int(manifest["gen"])
    if manifest.get("dim") is not None:
        index._dim = int(manifest["dim"])
        index._alloc_buffers()
        bsh = np.asarray(state["buffer_shard"], np.int64)
        for s in range(saved):
            rows = np.flatnonzero(bsh == s)
            c = rows.size
            index._buf_pts[s, :c] = state["buffer_points"][rows]
            index._buf_ids[s, :c] = state["buffer_ids"][rows]
            index._buf_count[s] = c
    if manifest.get("has_bounds") and "bounds" in state:
        index._bounds = torch.from_numpy(
            np.asarray(state["bounds"], np.uint32).view(np.int32).copy()).to(dev)
        index._route_lo = torch.from_numpy(
            np.asarray(state["route_lo"], np.float32).copy()).to(dev)
        index._route_hi = torch.from_numpy(
            np.asarray(state["route_hi"], np.float32).copy()).to(dev)
    for entry in manifest["segments"]:
        loaded = _load_segment_bundles(path, entry, saved, dev)
        shard_indexes = [ix for ix, _ in loaded]
        id_maps = np.stack([ids for _, ids in loaded])
        stack, points = stack_shard_indexes(
            shard_indexes, id_maps,
            store_points=all(ix.points is not None for ix in shard_indexes))
        index.segments.append(ShardedSegment(
            stack=stack, points=points, quant=shard_indexes[0].quant,
            gen=int(entry["gen"]), n_valid=np.asarray(entry["n_valid"], np.int64),
            pad_max=int(entry["pad_max"]), ids_host=id_maps,
        ))
        if index._perms is None:
            index._perms = shard_indexes[0].forest.perms
            index._flips = shard_indexes[0].forest.flips
    _recover_wal(index, path)
    return index, manifest.get("extra_meta", {})


def _restore_lsm(index, manifest: Dict, state: Dict[str, np.ndarray]) -> None:
    index._lsm.next_id = int(manifest["next_id"])
    index._lsm.alive = np.asarray(state["alive"], np.bool_)
    index._lsm.track_values = manifest.get("track_values")
    if "values" in state:
        index._lsm.values = state["values"]


def _load_segment_bundles(path: str, entry: Dict, n_shards: int, dev: torch.device
                          ) -> List[Tuple[HilbertIndex, np.ndarray]]:
    """One format-4 generation's per-shard (HilbertIndex, ext-id array) pairs."""
    out = []
    for s in range(n_shards):
        idx, extras, _ = load_index_bundle(
            os.path.join(path, "segments", entry["name"], f"shard_{s:05d}"),
            kind=_SEG_SHARD_KIND, device=dev)
        out.append((idx, np.asarray(extras["ids"], np.int32)))
    return out


def _gather_live_v4(path: str, manifest: Dict, state: Dict, dev: torch.device
                    ) -> Tuple[np.ndarray, torch.Tensor]:
    """Live (ids host, points on ``dev``) of a format-4 checkpoint, sorted
    by external id."""
    parts_i = [np.asarray(state["buffer_ids"], np.int32)]
    parts_p = [torch.from_numpy(np.asarray(state["buffer_points"], np.float32)
                                .reshape(-1, int(manifest.get("dim") or 0))).to(dev)]
    for entry in manifest["segments"]:
        for s, (idx, ids) in enumerate(
                _load_segment_bundles(path, entry, int(manifest["n_shards"]), dev)):
            if idx.points is None:
                raise ValueError(
                    "cannot reshard a sharded-mutable checkpoint whose "
                    "segments lack stored points (IndexConfig("
                    "store_points=False)); load on a matching mesh instead"
                )
            nv = int(entry["n_valid"][s])
            parts_i.append(ids[:nv])
            parts_p.append(idx.points[:nv])
    ids = np.concatenate(parts_i)
    pts = torch.cat(parts_p)
    keep = np.flatnonzero(np.asarray(state["alive"], np.bool_)[ids])
    keep = keep[np.argsort(ids[keep], kind="stable")]
    return ids[keep].astype(np.int32), pts[torch.from_numpy(keep).to(dev)]


def load_sharded_mutable_as_mutable(path: str, *, kind: str = _DEFAULT_KIND,
                                    device: DeviceLike = None):
    """Degrade a format-4 checkpoint to the single-device mutable layout.

    Live rows gather in external-id order (buffered rows included) and seal
    as one :class:`repro_torch.index.MutableHilbertIndex` segment, external
    ids and values kept; the WAL's records replay into it.
    """
    from repro_torch.index.mutable import MutableHilbertIndex, Segment

    dev = resolve_device(device)
    manifest = _read_manifest(path, kind)
    state = _restore_state_bundle(os.path.join(path, "state"), manifest.get("state_step"))
    ids, pts = _gather_live_v4(path, manifest, state, dev)
    config = dataclasses.replace(IndexConfig.from_dict(manifest["config"]), shards=None)
    mut = MutableHilbertIndex(config, buffer_capacity=int(manifest["buffer_capacity"]),
                              max_segments=int(manifest["max_segments"]), device=dev)
    _restore_lsm(mut, manifest, state)
    if manifest.get("dim") is not None:
        d = int(manifest["dim"])
        mut._dim = d
        mut._buf_points = np.zeros((mut.buffer_capacity, d), np.float32)
        mut._buf_ids = np.full((mut.buffer_capacity,), -1, np.int32)
    if ids.size:
        mut.segments = [Segment(index=HilbertIndex.build(pts, config, device=dev),
                                ids=ids, gen=0)]
        mut._gen = 1
    _recover_wal(mut, path)
    return mut
