"""Hilbert-forest-backed retrieval for serving (kNN-LM-style).

Port of ``repro.serve.retrieval``.  A datastore of (hidden-state ->
next-token) pairs is indexed with the Task-1 pipeline, and at decode
time the last hidden state queries it; retrieved next-token distances
form p_knn, mixed with the model's softmax (Khandelwal et al., 2020):

    p(w) = (1-λ)·p_model(w) + λ·p_knn(w),
    p_knn ∝ Σ_{(h_i,w_i) ∈ kNN} 1[w_i=w]·exp(-d(h, h_i)/T)

Two backing layouts, one streaming contract, on ``cuda`` unless the
caller passes ``device="cpu"``:

* **Mutable (default)**: a :class:`repro_torch.index.MutableHilbertIndex`
  carrying next-token values.
* **Sharded-mutable (``shards > 1``)**: a
  :class:`repro_torch.index.ShardedMutableHilbertIndex` on S logical
  shards of the device; appends route to the shard owning each key's
  curve range, and :meth:`RetrievalStore.compact` re-balances them.

``save()``/``load()`` round-trip both layouts in the JAX package's
formats, so a store saved by either package loads in the other; ``load``
also adopts ``repro``'s first sharded store checkpoints (a static
sharded index, format 3, with its values in a sidecar) and the first
static single-index store.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.types import ForestConfig, SearchParams
from repro_torch.index.config import IndexConfig
from repro_torch.index.convert import load_index_bundle
from repro_torch.index.facade import DeviceLike
from repro_torch.index.mutable import (MutableHilbertIndex, _restore_state_bundle,
                                       load_mutable_bundle)
from repro_torch.index.sharded import ShardedHilbertIndex
from repro_torch.index.sharded_mutable import (ShardedMutableHilbertIndex,
                                               load_sharded_mutable_as_mutable,
                                               load_sharded_mutable_bundle)

__all__ = ["RetrievalStore", "knn_lm_mix"]

_STORE_KIND = "retrieval_store"
_SHARDED_STORE_KIND = "retrieval_store_sharded"
_VALUES_DIR = "store_values"
_MUTABLE_MANIFEST = "mutable_manifest.json"
_SHARDED_MANIFEST = "sharded_manifest.json"
_SHARDED_MUTABLE_MANIFEST = "sharded_mutable_manifest.json"


def _remove_if_exists(path: str) -> None:
    try:
        os.remove(path)
    except FileNotFoundError:
        pass


def _remove_stale_layouts(path: str, keep: str) -> None:
    """Drop the other layouts' manifests and orphaned payloads post-commit.

    Called after a save's own manifest has committed: the v3 static
    store's ``shards/`` + ``store_values/`` trees and the other mutable
    layout's segment bundles (``seg_*`` vs ``gen_*``) would otherwise leak
    forever.  The shared ``state/`` dir is pruned by every saver.
    """
    if keep != "mutable":
        _remove_if_exists(os.path.join(path, _MUTABLE_MANIFEST))
    if keep != "sharded_mutable":
        _remove_if_exists(os.path.join(path, _SHARDED_MUTABLE_MANIFEST))
    _remove_if_exists(os.path.join(path, _SHARDED_MANIFEST))
    shutil.rmtree(os.path.join(path, "shards"), ignore_errors=True)
    shutil.rmtree(os.path.join(path, _VALUES_DIR), ignore_errors=True)
    stale_prefix = "gen_" if keep == "mutable" else "seg_"
    seg_root = os.path.join(path, "segments")
    if os.path.isdir(seg_root):
        for name in os.listdir(seg_root):
            if name.startswith(stale_prefix):
                shutil.rmtree(os.path.join(seg_root, name),
                              ignore_errors=True)


@dataclasses.dataclass
class RetrievalStore:
    """A streaming kNN-LM datastore over either mutable index layout.

    Exactly one of ``index`` (single-device LSM) / ``sharded`` (S logical
    shards) is set; every public method is layout-agnostic.
    """

    index: Optional[MutableHilbertIndex] = None
    sharded: Optional[ShardedMutableHilbertIndex] = None
    engine: Optional["object"] = None  # RetrievalEngine when attached

    @classmethod
    def build(cls, keys, values,
              config: Union[IndexConfig, ForestConfig, None] = None,
              *, buffer_capacity: int = 4096, max_segments: int = 8,
              shards: Optional[int] = None,
              device: DeviceLike = None) -> "RetrievalStore":
        """Build a datastore over (hidden-state, next-token) pairs.

        Args:
          keys: (n, d) fp32 hidden states (numpy array or tensor).
          values: (n,) next tokens (any dense per-entry payload works).
          config: a full :class:`IndexConfig` or a bare ``ForestConfig``.
          buffer_capacity: write-buffer rows (per shard when sharded).
          max_segments: sealed-segment cap before tier merging.
          shards: logical shard count; ``shards`` or ``config.shards`` > 1
            selects the sharded-mutable layout, default is the mutable
            store.
          device: ``None`` (the GPU; raises without one) or any torch
            device.

        Returns a store whose corpus is one sealed segment (one generation
        across the shards); later :meth:`append` batches stream through
        the write buffer(s).
        """
        if config is None:
            config = IndexConfig()
        elif isinstance(config, ForestConfig):
            config = IndexConfig(forest=config)
        if shards is None:
            shards = config.shards or 1
        if shards > 1:
            config = dataclasses.replace(config, shards=shards)
            sharded = ShardedMutableHilbertIndex.build(
                keys, config, n_shards=shards, values=values,
                buffer_capacity=buffer_capacity, max_segments=max_segments,
                device=device)
            return cls(sharded=sharded)
        index = MutableHilbertIndex(config, buffer_capacity=buffer_capacity,
                                    max_segments=max_segments, device=device)
        index.bulk_load(keys, values)
        return cls(index=index)

    @property
    def is_sharded(self) -> bool:
        return self.sharded is not None

    @property
    def _impl(self):
        """The backing mutable index, whichever layout it is: the engine's
        CURRENT one when attached (after a maintenance swap the engine
        serves the compacted copy)."""
        if self.engine is not None:
            return self.engine.index
        return self.sharded if self.is_sharded else self.index

    def serving_engine(self, params: Optional[SearchParams] = None,
                       **kwargs) -> "object":
        """Attach a :class:`~repro_torch.serve.engine.RetrievalEngine` over
        the backing index and route ALL store traffic through it.

        :meth:`lookup` then goes through the engine's admission queue and
        micro-batcher, :meth:`append`/:meth:`delete` are routed writes, and
        :meth:`compact` becomes a forced off-path maintenance cycle.
        Calling this again drains and stops the previous engine first and
        wraps the index version it was serving.
        """
        from repro_torch.serve.engine import RetrievalEngine

        if self.engine is not None:
            self.engine.stop()
        impl = self._impl
        self.engine = RetrievalEngine(impl, params, **kwargs)
        return self.engine

    @property
    def values(self) -> torch.Tensor:
        """Dense next-token array keyed by datastore id (kNN-LM gather)."""
        return self._impl.values_dense()

    def values_at(self, ids, fill=0) -> torch.Tensor:
        """Gather per-entry values for search-result ids; -1 slots get fill."""
        if self.engine is not None:
            return self.engine.values_at(ids, fill=fill)
        return self._impl.values_at(ids, fill=fill)

    def append(self, keys, values) -> np.ndarray:
        """Stream new (hidden, token) pairs in while serving; returns ids."""
        if self.engine is not None:
            return self.engine.insert(keys, values)
        return self._impl.insert(keys, values)

    def delete(self, ids) -> int:
        """Tombstone datastore entries (stale documents, TTL eviction)."""
        if self.engine is not None:
            return self.engine.delete(ids)
        return self._impl.delete(ids)

    def enable_wal(self, path: str, config=None) -> "RetrievalStore":
        """Make acknowledged writes durable: attach a write-ahead log at
        ``path`` (the directory this store saves to); :meth:`save`
        truncates it and :meth:`load` replays its tail."""
        self._impl.enable_wal(path, config)
        return self

    def compact(self) -> "RetrievalStore":
        """Merge segments / drop tombstones (the sharded layout also
        re-balances its partition); with an engine attached, a forced
        background-maintenance cycle with an atomic swap."""
        if self.engine is not None:
            self.engine.maintain_once(force=True)
            return self
        self._impl.compact()
        return self

    def lookup(self, queries, params: SearchParams
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(Q, d) hidden states -> (ids (Q, k), sq-dists (Q, k)).

        With fewer than k live entries the tail is id -1 / +inf —
        :func:`knn_lm_mix` masks those slots.  Through an attached engine
        the results are host numpy arrays; otherwise tensors on the
        store's device.
        """
        if self.engine is not None:
            return self.engine.search(queries, params)
        return self._impl.search(queries, params)

    def memory_report(self) -> dict:
        """Bytes of segments + buffer + values + tombstones (the sharded
        layout also splits them by shard)."""
        return self._impl.memory_report()

    def save(self, path: str) -> str:
        """Persist the store as ONE manifest-committed save (values ride in
        the index's state bundle), in the JAX package's layout.  A save
        that switches layout removes the other layouts' manifests and
        payloads after committing its own."""
        impl = self._impl
        if not self.is_sharded:
            out = impl.save(path, kind=_STORE_KIND)
            _remove_stale_layouts(path, keep="mutable")
            return out
        out = impl.save(path, kind=_SHARDED_STORE_KIND)
        _remove_stale_layouts(path, keep="sharded_mutable")
        return out

    @classmethod
    def load(cls, path: str, *, n_shards: Optional[int] = None,
             device: DeviceLike = None) -> "RetrievalStore":
        """Load a store checkpoint of any generation, saved by either package.

        Resolution, as ``repro``'s: the newest manifest wins (two coexist
        only when a layout-switching save crashed before its clean-up); on
        an mtime tie, the one whose state step still exists; then the
        format generation.  Layouts: the v4 sharded-mutable store, the v1
        mutable store, the v3 static sharded store (adopted into the
        mutable layout, values sidecar and all), then the first static
        single-index store (adopted as one sealed segment).

        ``n_shards`` is the shard count of a sharded store: by default the
        checkpoint's own; another count reshards, and 1 yields the
        single-device mutable layout.  ``repro`` takes the count from its
        mesh or ``jax.device_count()``; one card has no such count, so the
        port keeps the build's unless told.
        """
        candidates = []
        for priority, (manifest, kind) in enumerate((
            (_SHARDED_MANIFEST, "sharded_static"),
            (_MUTABLE_MANIFEST, "mutable"),
            (_SHARDED_MUTABLE_MANIFEST, "sharded_mutable"),
        )):
            p = os.path.join(path, manifest)
            if os.path.exists(p):
                ok = _state_ok(path, p) if priority else True
                candidates.append((os.stat(p).st_mtime_ns, ok, priority, kind))
        layout = max(candidates)[3] if candidates else "legacy"
        if layout == "sharded_mutable":
            if n_shards == 1:
                return cls(index=load_sharded_mutable_as_mutable(
                    path, kind=_SHARDED_STORE_KIND, device=device))
            sharded, _ = load_sharded_mutable_bundle(
                path, n_shards=n_shards, kind=_SHARDED_STORE_KIND, device=device)
            return cls(sharded=sharded)
        if layout == "mutable":
            index, _ = load_mutable_bundle(path, kind=_STORE_KIND, device=device)
            return cls(index=index)
        if layout == "sharded_static":
            # the first sharded store: a static index checkpoint + a values
            # sidecar at the manifest-referenced step
            with open(os.path.join(path, _SHARDED_MANIFEST)) as f:
                manifest = json.load(f)
            base = ShardedHilbertIndex.load(path, n_shards=n_shards,
                                            kind=_SHARDED_STORE_KIND, device=device)
            values = _restore_state_bundle(
                os.path.join(path, _VALUES_DIR),
                manifest.get("extra_meta", {}).get("values_step"))["values"]
            if base.single is not None:
                return cls(index=MutableHilbertIndex.from_index(base.single,
                                                                values=values))
            return cls(sharded=ShardedMutableHilbertIndex.from_sharded(base,
                                                                       values=values))
        # The first static RetrievalStore: one HilbertIndex bundle + values
        # sidecar, adopted as a single sealed segment.
        static_index, extras, _ = load_index_bundle(path, kind=_STORE_KIND,
                                                    device=device)
        return cls(index=MutableHilbertIndex.from_index(
            static_index, values=extras["values"]))


def _state_ok(path: str, manifest_path: str) -> bool:
    """Whether the state step a manifest references still exists (the
    committed side of a crashed layout switch pruned the other's)."""
    try:
        with open(manifest_path) as f:
            step = json.load(f).get("state_step")
    except (OSError, ValueError):
        return False
    if step is None:
        return True
    return os.path.isdir(os.path.join(path, "state", f"step_{int(step):08d}"))


def knn_lm_mix(logits, hidden, store: RetrievalStore, params: SearchParams,
               lam: float = 0.25, temperature: float = 1.0) -> torch.Tensor:
    """Return log of the mixed distribution (B, V) on ``logits``' device."""
    logits = torch.as_tensor(logits)
    dev = logits.device
    ids, d2 = store.lookup(hidden, params)  # (B, k)
    ids = torch.as_tensor(ids, device=dev)
    d2 = torch.as_tensor(d2, device=dev)
    w = torch.softmax(-d2 / temperature, dim=-1)
    w = torch.where(ids >= 0, w, torch.zeros_like(w))  # mask -1 padding slots
    tok = torch.as_tensor(store.values_at(ids, fill=0), device=dev).long()
    p_knn = torch.zeros_like(logits).index_put_(
        (torch.arange(logits.shape[0], device=dev)[:, None], tok), w,
        accumulate=True)
    p_model = torch.softmax(logits, dim=-1)
    mixed = (1.0 - lam) * p_model + lam * p_knn
    return torch.log(torch.clamp(mixed, min=1e-20))
