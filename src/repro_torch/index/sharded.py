"""ShardedHilbertIndex: the row-partitioned Hilbert forest, on logical shards.

Port of ``repro.index.sharded``.  The JAX package spreads the shards over
a mesh's ``data`` axis, one a device; here the S shards are logical
shards of one device, their per-shard arrays stacked on a leading axis,
and every exchange between them goes through
:class:`repro_torch.core.shard_group.ShardGroup`.

Layout
  The partition is contiguous runs of the master Hilbert order
  (:func:`repro_torch.core.distributed.hilbert_partition`, the sample sort
  over the shards): shard ``s`` owns the ``s``-th stretch of the curve.
  Every shard is padded to equal length with cyclic copies of its own rows
  (an empty shard with copies of global row 0); padding rows keep their
  real global ids, so they surface as duplicate ids that the cross-shard
  merge's dedup collapses.

Search
  Per query chunk, each shard runs
  :func:`repro_torch.core.search.fused_search_chunk` over its stacked
  arrays for ``k + pad_max`` results (so duplicate padding rows cannot
  crowd a distinct neighbour out), maps its hits to global ids, and the
  shards reduce through
  :func:`repro_torch.core.distributed.cross_shard_merge_topk`: the
  butterfly tree (``merge="tree"``, what ``"auto"`` picks on a
  power-of-two count, optionally with the ``pmin`` prune) or one flat
  merge (``"gather"``).  All shards share one quantizer fit on the whole
  corpus, so their distances are comparable and equal to the
  single-index values.  A 1-shard index is a plain :class:`HilbertIndex`
  underneath and searches bit-identically to it.

Checkpoints (format_version 3)
  ``save()`` writes one ordinary index bundle a shard, then a top-level
  JSON manifest renamed into place last.  ``load()`` restacks the shards
  when the shard count is unchanged, reshards (gathers points and ids,
  rebuilds with the same quantizer) when it changes, and adopts a plain
  format-2 index bundle the same way.  Bundles of either package load in
  the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import bundle
from repro_torch.core import distributed as distributed_lib
from repro_torch.core import forest as forest_lib
from repro_torch.core import quantize
from repro_torch.core import search as search_lib
from repro_torch.core.shard_group import ShardGroup
from repro_torch.core.types import SearchParams
from repro_torch.index.config import IndexConfig
from repro_torch.index.convert import load_index_bundle
from repro_torch.index.facade import (BACKENDS, DeviceLike, HilbertIndex, _pow2_bucket,
                                      build_with_timings, resolve_device,
                                      save_index_bundle)
from repro_torch.obs.dispatch import dispatch_scope

__all__ = [
    "ShardedHilbertIndex",
    "ShardStack",
    "build_auto",
    "shard_index_from_stack",
    "stack_shard_indexes",
]

_SHARDED_MANIFEST = "sharded_manifest.json"
_SHARD_KIND = "sharded_index_shard"
_DEFAULT_KIND = "sharded_hilbert_index"
_FORMAT_VERSION = 3


class ShardStack(NamedTuple):
    """Per-shard index arrays stacked on a leading shard axis.

    ``perms``/``flips`` (one forest seed) and the quantizer are shared by
    all shards and stay outside the stack.
    """

    orders: torch.Tensor  # (S, T, n_pad) int32, per-tree Hilbert orders
    directories: torch.Tensor  # (S, T, n_dir, W) int32 words, rank directories
    lo: torch.Tensor  # (S, d) float32 per-shard curve bounds
    hi: torch.Tensor  # (S, d) float32
    sketches: torch.Tensor  # (S, n_pad, Ws) int32 words, master-order layout
    codes: torch.Tensor  # (S, n_pad, Wc) int32 words, nibble-packed, master order
    master_order: torch.Tensor  # (S, n_pad) int32: position -> local row
    master_rank: torch.Tensor  # (S, n_pad) int32: local row -> position
    id_map: torch.Tensor  # (S, n_pad) int32: local row -> GLOBAL id


def stack_shard_indexes(
    shard_indexes: List[HilbertIndex],
    id_maps,
    *,
    store_points: bool,
) -> Tuple[ShardStack, Optional[torch.Tensor]]:
    """Stack per-shard :class:`HilbertIndex` arrays on a leading shard axis.

    ``id_maps`` (S, n_pad) maps each shard's local rows to the ids its
    search hits are reported as (global rows for this facade).  Returns
    ``(stack, points)``, points (S, n_pad, d) when ``store_points``.
    """
    dev = shard_indexes[0].device

    def stack_leaf(get):
        return torch.stack([get(ix) for ix in shard_indexes])

    stack = ShardStack(
        orders=stack_leaf(lambda ix: ix.forest.orders),
        directories=stack_leaf(lambda ix: ix.forest.directories),
        lo=stack_leaf(lambda ix: ix.forest.lo),
        hi=stack_leaf(lambda ix: ix.forest.hi),
        sketches=stack_leaf(lambda ix: ix.sketches_master),
        codes=stack_leaf(lambda ix: ix.codes_master),
        master_order=stack_leaf(lambda ix: ix.master_order),
        master_rank=stack_leaf(lambda ix: ix.master_rank),
        id_map=torch.as_tensor(id_maps, dtype=torch.int32, device=dev),
    )
    points = stack_leaf(lambda ix: ix.points) if store_points else None
    return stack, points


def shard_index_from_stack(
    config: IndexConfig,
    stack: ShardStack,
    points: Optional[torch.Tensor],
    quant: quantize.Quantizer,
    perms: torch.Tensor,
    flips: torch.Tensor,
    s: int,
) -> HilbertIndex:
    """Shard ``s`` of a stack as a self-contained format-2 :class:`HilbertIndex`
    (its tensors are views of the stack)."""
    return HilbertIndex(
        config=dataclasses.replace(config, shards=None),
        forest=forest_lib.HilbertForest(
            perms=perms, flips=flips, orders=stack.orders[s],
            directories=stack.directories[s], lo=stack.lo[s], hi=stack.hi[s],
        ),
        quant=quant,
        codes_master=stack.codes[s],
        sketches_master=stack.sketches[s],
        master_order=stack.master_order[s],
        master_rank=stack.master_rank[s],
        points=None if points is None else points[s],
    )


@dataclasses.dataclass
class ShardedHilbertIndex:
    """Row-partitioned Hilbert forest over ``group.size`` logical shards."""

    config: IndexConfig
    group: ShardGroup
    quant: quantize.Quantizer  # global, shared by every shard
    perms: torch.Tensor  # (T, d) shared forest randomization
    flips: torch.Tensor  # (T, d)
    stack: Optional[ShardStack]  # None iff n_shards == 1
    points: Optional[torch.Tensor]  # (S, n_pad, d) iff store_points
    single: Optional[HilbertIndex]  # the 1-shard path
    n_points: int
    n_valid: np.ndarray  # (S,) rows each shard owns
    pad_max: int  # largest pad count among non-empty shards

    def __post_init__(self):
        self.last_dispatch_count = 0

    # -- introspection -------------------------------------------------------

    @property
    def n_shards(self) -> int:
        return self.group.size

    @property
    def n_pad(self) -> int:
        return (self.single.n_points if self.single is not None
                else int(self.stack.id_map.shape[1]))

    @property
    def dim(self) -> int:
        return self.quant.boundaries.shape[0]

    @property
    def device(self) -> torch.device:
        return self.group.device

    def memory_report(self) -> Dict[str, object]:
        """The paper's RAM model plus the partitioned layout's actual bytes.

        All S logical shards sit on one device, which holds
        ``resident_bytes``.  ``per_device_bytes`` lists, as the JAX
        package's does, what each shard would hold on a card of its own:
        its slice of every stacked array plus a copy of the shared ones.
        """
        if self.single is not None:
            rep = dict(self.single.memory_report())
            rep.update(n_shards=1, sharded_bytes=0,
                       replicated_bytes=rep["resident_bytes"],
                       per_device_bytes=[rep["resident_bytes"]])
            return rep

        def nbytes(t):
            return t.numel() * t.element_size()

        s = self.n_shards
        sharded = sum(nbytes(t) for t in self.stack) + (
            0 if self.points is None else nbytes(self.points))
        replicated = sum(nbytes(t) for t in (self.quant.boundaries, self.quant.centroids,
                                             self.perms, self.flips))
        rep = search_lib.paper_memory_model(
            self.n_points, self.dim, nbytes(self.stack.sketches),
            nbytes(self.stack.orders) + nbytes(self.stack.directories)
            + nbytes(self.perms) + nbytes(self.flips),
        )
        rep.update(
            n_shards=s,
            points_bytes=0 if self.points is None else nbytes(self.points),
            codes_bytes=nbytes(self.stack.codes),
            sharded_bytes=sharded,
            replicated_bytes=replicated,
            resident_bytes=sharded + replicated,
            total_bytes=sharded + replicated,
            per_device_bytes=[sharded // s + replicated] * s,
        )
        return rep

    def __repr__(self) -> str:
        rep = self.memory_report()
        return (
            f"ShardedHilbertIndex(n_points={self.n_points}, dim={self.dim}, "
            f"n_shards={self.n_shards}, n_pad={self.n_pad}, device={self.device}, "
            f"{rep['resident_bytes'] / 1e6:.2f} MB)"
        )

    # -- build ---------------------------------------------------------------

    @classmethod
    def build(cls, points, config: Optional[IndexConfig] = None, *,
              n_shards: Optional[int] = None,
              device: DeviceLike = None) -> "ShardedHilbertIndex":
        """Partition the rows into ``n_shards`` logical shards and build each.

        Args:
          points: (n, d) fp32 corpus (numpy array or tensor); global ids
            are ``0..n-1``.
          config: build configuration (``None`` = ``IndexConfig()``).
          n_shards: shard count; default ``config.shards``, else 1.  Both
            given and different raises.
          device: ``None`` (the GPU; raises without one) or any torch
            device; every shard lives there.

        The quantizer is fit once on the whole corpus and shared by every
        shard; each shard then runs the Algorithm-1 build over its run of
        the master curve.
        """
        if config is None:
            config = IndexConfig()
        dev = resolve_device(device)
        pts = torch.as_tensor(points, dtype=torch.float32, device=dev)
        if pts.shape[0] == 0:
            raise ValueError("cannot build a sharded index over 0 points")
        if n_shards is None:
            n_shards = config.shards if config.shards is not None else 1
        if config.shards is not None and config.shards != n_shards:
            raise ValueError(f"config.shards={config.shards} != n_shards={n_shards}")
        quant = quantize.fit(pts, bits=config.quantizer.bits,
                             sample_limit=config.quantizer.sample_limit)
        return cls._build_impl(pts, config, n_shards, quant)

    @classmethod
    def _build_impl(cls, pts: torch.Tensor, config: IndexConfig, n_shards: int,
                    quant: quantize.Quantizer) -> "ShardedHilbertIndex":
        n = pts.shape[0]
        dev = pts.device
        if n_shards == 1:
            single, _ = build_with_timings(pts, config, quant=quant, device=dev)
            return cls._single(config, single, n, [n])

        gid_slices = distributed_lib.hilbert_partition(pts, config.forest, n_shards)
        n_pad = -(-n // n_shards)
        n_valid = np.asarray([len(g) for g in gid_slices], np.int64)
        # Only shards that own rows count: an empty shard's padding copies
        # global row 0, which shard 0 owns and the merge collapses.
        pad_max = int(max((n_pad - v for v in n_valid if v > 0), default=0))
        id_maps = torch.zeros((n_shards, n_pad), dtype=torch.int32, device=dev)
        shard_indexes = []
        for s, gids in enumerate(gid_slices):
            if len(gids):
                id_maps[s] = gids.repeat(-(-n_pad // len(gids)))[:n_pad]
            idx, _ = build_with_timings(pts[id_maps[s].long()], config, quant=quant,
                                        device=dev)
            shard_indexes.append(idx)
        return cls._assemble(config, ShardGroup(n_shards, dev), quant, shard_indexes,
                             id_maps, n, n_valid, pad_max)

    @classmethod
    def _assemble(cls, config, group, quant, shard_indexes, id_maps, n, n_valid,
                  pad_max) -> "ShardedHilbertIndex":
        stack, points = stack_shard_indexes(shard_indexes, id_maps,
                                            store_points=config.store_points)
        return cls(config=config, group=group, quant=quant,
                   perms=shard_indexes[0].forest.perms,
                   flips=shard_indexes[0].forest.flips,
                   stack=stack, points=points, single=None, n_points=n,
                   n_valid=np.asarray(n_valid, np.int64), pad_max=pad_max)

    # -- search --------------------------------------------------------------

    def _resolve_merge(self, merge: Optional[str], prune: Optional[bool]
                       ) -> Tuple[str, bool]:
        """Per-call knobs default to the config; "auto" resolves by S."""
        merge = distributed_lib.resolve_merge(
            merge if merge is not None else self.config.merge, self.n_shards)
        if prune is None:
            prune = self.config.merge_prune
        return merge, bool(prune)

    def search(
        self,
        queries,
        params: SearchParams = SearchParams(),
        *,
        backend: str = "kernel",
        query_chunk: Optional[int] = None,
        merge: Optional[str] = None,
        prune: Optional[bool] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Algorithm-1 search over every shard, merged across shards.

        Args:
          queries: (Q, d) fp32 batch (numpy array or tensor).
          params: Algorithm-1 hyper-parameters (paper Table 1 names); each
            shard searches for ``k + pad_max`` candidates.
          backend: ``"kernel"`` or ``"ref"``, as in :meth:`HilbertIndex.search`.
          query_chunk: chunk cap (default ``config.query_chunk``); chunks
            are padded to power-of-two buckets.
          merge: ``"auto"|"gather"|"tree"`` (default ``config.merge``).
          prune: the distance-bound prune of the tree (default
            ``config.merge_prune``).

        Returns ``(ids (Q, k) int32, sq_distances (Q, k) float32)`` with
        global ids, distances ascending; shortfalls pad id -1 / +inf.
        ``last_dispatch_count`` is the number of chunks of the last call.
        """
        merge, prune = self._resolve_merge(merge, prune)
        if self.single is not None:
            chunk = query_chunk or self.config.query_chunk
            self.last_dispatch_count = -(-queries.shape[0] // chunk)
            return self.single.search(queries, params, backend=backend,
                                      query_chunk=query_chunk, fused=True)
        ids, d2 = self._search_chunks(queries, params, backend, query_chunk, merge,
                                      prune, "sharded.search")
        return ids[0], d2[0]

    def search_local(
        self,
        queries,
        params: SearchParams = SearchParams(),
        *,
        backend: str = "kernel",
        query_chunk: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-shard search without the cross-shard reduction.

        The same per-shard pipeline, gid mapping and shard-local deflation
        to k as :meth:`search`; returns the unmerged ``(ids (S, Q, k),
        sq_distances (S, Q, k))`` stacks.
        """
        if self.single is not None:
            ids, d2 = self.single.search(queries, params, backend=backend,
                                         query_chunk=query_chunk, fused=True)
            return ids[None], d2[None]
        return self._search_chunks(queries, params, backend, query_chunk, "local",
                                   False, "sharded.search_local")

    def _search_chunks(self, queries, params, backend, query_chunk, merge, prune,
                       site):
        """(S, Q, k) per-rank results of every chunk, concatenated."""
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        if query_chunk is None:
            query_chunk = self.config.query_chunk
        queries = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        qn = queries.shape[0]
        self.last_dispatch_count = 0
        if qn == 0:
            s = 1 if merge != "local" else self.n_shards
            return (torch.zeros((s, 0, params.k), dtype=torch.int32, device=self.device),
                    torch.zeros((s, 0, params.k), dtype=torch.float32, device=self.device))
        k_local = self._k_local(params)
        outs_i, outs_d = [], []
        for s in range(0, qn, query_chunk):
            q = queries[s : s + query_chunk]
            m = q.shape[0]
            bucket = _pow2_bucket(m, query_chunk)
            if bucket > m:
                q = torch.nn.functional.pad(q, (0, 0, 0, bucket - m))
            with dispatch_scope(site):
                ids, dists = self._search_chunk(q.contiguous(), params, k_local,
                                                backend == "kernel", merge, prune)
            self.last_dispatch_count += 1
            outs_i.append(ids[:, :m])
            outs_d.append(dists[:, :m])
        return torch.cat(outs_i, dim=1), torch.cat(outs_d, dim=1)

    def _k_local(self, params: SearchParams) -> int:
        window = min(2 * params.h + 1, self.n_pad)
        return max(1, min(params.k + self.pad_max, params.k2 * window))

    def _search_chunk(self, q, params: SearchParams, k_local: int, use_kernels: bool,
                      merge: str, prune: bool):
        """One chunk on every shard, then the merge: (S, Q, k) per rank, or
        (1, Q, k) once merged (every rank holds the same result)."""
        st = self.stack
        fcfg = self.config.forest
        ids_all, d_all = [], []
        for s in range(self.n_shards):
            ids_l, d2 = search_lib.fused_search_chunk(
                q, st.orders[s], st.directories[s], st.lo[s], st.hi[s],
                self.perms, self.flips, st.master_rank[s], st.sketches[s],
                st.codes[s], st.master_order[s], self.quant,
                bits=fcfg.bits, key_bits=fcfg.key_bits, leaf_size=fcfg.leaf_size,
                k1=params.k1, k2=params.k2, h=params.h, k=k_local,
                use_kernels=use_kernels,
            )
            gids = torch.where(ids_l >= 0, st.id_map[s][ids_l.clamp_min(0).long()], -1)
            ids_all.append(gids)
            d_all.append(torch.where(gids >= 0, d2, torch.inf))
        ids, d2 = torch.stack(ids_all), torch.stack(d_all)
        if merge == "local":
            return distributed_lib.merge_topk_rows(ids, d2, params.k)
        out_i, out_d = distributed_lib.cross_shard_merge_topk(
            self.group, ids, d2, k=params.k, merge=merge, prune=prune)
        return out_i[:1], out_d[:1]

    # -- persistence ---------------------------------------------------------

    def _shard_index(self, s: int) -> Tuple[HilbertIndex, np.ndarray]:
        """Shard ``s`` as a self-contained format-2 index, and its gid map."""
        if self.single is not None:
            return self.single, np.arange(self.n_points, dtype=np.int32)
        index = shard_index_from_stack(self.config, self.stack, self.points,
                                       self.quant, self.perms, self.flips, s)
        return index, self.stack.id_map[s].cpu().numpy()

    def save(self, path: str, *, kind: str = _DEFAULT_KIND,
             extra_meta: Optional[Dict] = None) -> str:
        """Persist as per-shard bundles under one atomically renamed manifest.

        Every shard bundle is written before the manifest commits, so a
        crash mid-save leaves the previous manifest and its bundles intact.
        """
        os.makedirs(path, exist_ok=True)
        names = []
        for s in range(self.n_shards):
            index, gids = self._shard_index(s)
            name = f"shard_{s:05d}"
            save_index_bundle(
                index, os.path.join(path, "shards", name), kind=_SHARD_KIND,
                extra_arrays={"shard_gids": gids},
                extra_meta={"shard": s, "n_shards": self.n_shards,
                            "n_valid": int(self.n_valid[s])},
            )
            names.append(name)
        manifest = {
            "kind": kind,
            "format_version": _FORMAT_VERSION,
            "config": self.config.to_dict(),
            "n_shards": self.n_shards,
            "n_points": int(self.n_points),
            "dim": int(self.dim),
            "pad_max": int(self.pad_max),
            "shards": names,
            "extra_meta": extra_meta or {},
        }
        bundle.atomic_write_json(os.path.join(path, _SHARDED_MANIFEST), manifest)
        return path

    @classmethod
    def load(cls, path: str, *, n_shards: Optional[int] = None,
             kind: str = _DEFAULT_KIND,
             device: DeviceLike = None) -> "ShardedHilbertIndex":
        """Load a format-3 sharded checkpoint, or adopt a format-2 index bundle.

        ``n_shards`` is the target count: by default the checkpoint's own
        (1 for a format-2 bundle).  Another count reshards on load: the
        owned rows and their global ids are gathered from the stored shards
        and the partition is rebuilt with the checkpoint's quantizer, so
        distances are unchanged; that needs stored points
        (``IndexConfig(store_points=True)``, the default).
        """
        dev = resolve_device(device)
        mpath = os.path.join(path, _SHARDED_MANIFEST)
        if not os.path.exists(mpath):
            index, _, _ = load_index_bundle(path, device=dev)
            config = dataclasses.replace(index.config, shards=None)
            if n_shards in (None, 1):
                return cls._single(config, index, index.n_points, [index.n_points])
            if index.points is None:
                raise ValueError("cannot reshard a format-2 bundle saved with "
                                 "store_points=False (no raw points to re-partition)")
            return cls._build_impl(index.points, config, n_shards, index.quant)
        with open(mpath) as f:
            manifest = json.load(f)
        if manifest.get("kind") != kind:
            raise ValueError(f"{path!r} is not a sharded-index checkpoint of kind "
                             f"{kind!r} (kind={manifest.get('kind')!r})")
        config = IndexConfig.from_dict(manifest["config"])
        n = int(manifest["n_points"])
        shard_indexes, id_maps, n_valid = [], [], []
        for name in manifest["shards"]:
            idx, extras, extra = load_index_bundle(
                os.path.join(path, "shards", name), kind=_SHARD_KIND, device=dev)
            shard_indexes.append(idx)
            id_maps.append(np.asarray(extras["shard_gids"], np.int32))
            n_valid.append(int(extra["n_valid"]))
        target = len(shard_indexes) if n_shards is None else n_shards
        if target == len(shard_indexes):
            if target == 1:
                return cls._single(config, shard_indexes[0], n, n_valid)
            return cls._assemble(config, ShardGroup(target, dev), shard_indexes[0].quant,
                                 shard_indexes, np.stack(id_maps), n, n_valid,
                                 int(manifest["pad_max"]))
        # Shard-count change: gather the owned rows, rebuild at the new count.
        if any(ix.points is None for ix in shard_indexes):
            raise ValueError(
                f"checkpoint has {len(shard_indexes)} shards but {target} were asked "
                "for; resharding needs stored points (IndexConfig(store_points=True))")
        pts = torch.zeros((n, shard_indexes[0].dim), dtype=torch.float32, device=dev)
        for ix, gids, nv in zip(shard_indexes, id_maps, n_valid):
            pts[torch.as_tensor(gids[:nv], device=dev).long()] = ix.points[:nv]
        # The stored config.shards describes the old partition.
        return cls._build_impl(pts, dataclasses.replace(config, shards=None), target,
                               shard_indexes[0].quant)

    @classmethod
    def _single(cls, config, index: HilbertIndex, n: int, n_valid
                ) -> "ShardedHilbertIndex":
        return cls(config=config, group=ShardGroup(1, index.device), quant=index.quant,
                   perms=index.forest.perms, flips=index.forest.flips, stack=None,
                   points=None, single=index, n_points=n,
                   n_valid=np.asarray(n_valid, np.int64), pad_max=0)


def build_auto(
    points,
    config: Optional[IndexConfig] = None,
    *,
    n_shards: Optional[int] = None,
    mutable: Optional[bool] = None,
    values=None,
    buffer_capacity: int = 1024,
    max_segments: int = 8,
    device: DeviceLike = None,
):
    """The ``backend="auto"`` of index construction.

    Args:
      points: (n, d) corpus to index.
      config: build configuration; ``None`` means ``IndexConfig()``.
      n_shards: logical shard count; default ``config.shards``, else 1.
      mutable: build the streaming (LSM) facade; ``None`` defers to
        ``config.mutable``.
      values: optional (n, ...) per-point payloads (the mutable facade).
      buffer_capacity, max_segments: the mutable facades' write-buffer
        rows (a shard, when sharded) and sealed-segment cap.
      device: ``None`` (the GPU; raises without one) or any torch device.

    Returns the facade for the resolved shard count and mutability:
    :class:`HilbertIndex`, :class:`ShardedHilbertIndex`,
    :class:`repro_torch.index.MutableHilbertIndex` or
    :class:`repro_torch.index.ShardedMutableHilbertIndex`.
    """
    if config is None:
        config = IndexConfig()
    if mutable is None:
        mutable = config.mutable
    if n_shards is None:
        n_shards = config.shards if config.shards is not None else 1
    if n_shards > 1:
        if mutable:
            from repro_torch.index.sharded_mutable import ShardedMutableHilbertIndex

            return ShardedMutableHilbertIndex.build(
                points, config, n_shards=n_shards, values=values,
                buffer_capacity=buffer_capacity, max_segments=max_segments,
                device=device)
        return ShardedHilbertIndex.build(points, config, n_shards=n_shards,
                                         device=device)
    config = dataclasses.replace(config, shards=None)
    if mutable:
        from repro_torch.index.mutable import MutableHilbertIndex

        mut = MutableHilbertIndex(config, buffer_capacity=buffer_capacity,
                                  max_segments=max_segments, device=device)
        mut.bulk_load(points, values)
        return mut
    return HilbertIndex.build(points, config, device=device)
