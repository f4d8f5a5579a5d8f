"""Hilbert-forest-backed retrieval for serving (kNN-LM-style).

Port of ``repro.serve.retrieval`` on the single-device layout.  A
datastore of (hidden-state -> next-token) pairs is indexed with the
Task-1 pipeline, and at decode time the last hidden state queries it;
retrieved next-token distances form p_knn, mixed with the model's
softmax (Khandelwal et al., 2020):

    p(w) = (1-λ)·p_model(w) + λ·p_knn(w),
    p_knn ∝ Σ_{(h_i,w_i) ∈ kNN} 1[w_i=w]·exp(-d(h, h_i)/T)

The store is a :class:`repro_torch.index.MutableHilbertIndex` carrying
next-token values, on ``cuda`` unless the caller passes ``device="cpu"``.
Its bundles are the JAX package's, so a store saved by either package
loads in the other.  The sharded layouts (``shards > 1``, sharded store
checkpoints) raise until the sharded indexes are ported (ROADMAP
module 12).
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
from repro_torch.index.mutable import MutableHilbertIndex, load_mutable_bundle

__all__ = ["RetrievalStore", "knn_lm_mix"]

_STORE_KIND = "retrieval_store"
_VALUES_DIR = "store_values"
_MUTABLE_MANIFEST = "mutable_manifest.json"
_SHARDED_MANIFEST = "sharded_manifest.json"
_SHARDED_MUTABLE_MANIFEST = "sharded_mutable_manifest.json"


def _sharded_unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs the sharded layouts, which wait for the port of the "
        "sharded indexes (ROADMAP module 12)"
    )


def _remove_if_exists(path: str) -> None:
    try:
        os.remove(path)
    except FileNotFoundError:
        pass


def _remove_stale_layouts(path: str) -> None:
    """Drop the other layouts' manifests and orphaned payloads post-commit.

    Called after a save's own (mutable) manifest has committed: the v3
    static store's ``shards/`` + ``store_values/`` trees and the sharded
    layout's ``gen_*`` segment bundles would otherwise leak forever.
    """
    _remove_if_exists(os.path.join(path, _SHARDED_MUTABLE_MANIFEST))
    _remove_if_exists(os.path.join(path, _SHARDED_MANIFEST))
    shutil.rmtree(os.path.join(path, "shards"), ignore_errors=True)
    shutil.rmtree(os.path.join(path, _VALUES_DIR), ignore_errors=True)
    seg_root = os.path.join(path, "segments")
    if os.path.isdir(seg_root):
        for name in os.listdir(seg_root):
            if name.startswith("gen_"):
                shutil.rmtree(os.path.join(seg_root, name),
                              ignore_errors=True)


@dataclasses.dataclass
class RetrievalStore:
    """A streaming kNN-LM datastore over the single-device mutable index."""

    index: Optional[MutableHilbertIndex] = None
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
          buffer_capacity: write-buffer rows.
          max_segments: sealed-segment cap before tier merging.
          shards: must be ``None`` or 1 (the sharded layout is not ported).
          device: ``None`` (the GPU; raises without one) or any torch
            device.

        Returns a store whose corpus is one sealed segment; later
        :meth:`append` batches stream through the write buffer.
        """
        if config is None:
            config = IndexConfig()
        elif isinstance(config, ForestConfig):
            config = IndexConfig(forest=config)
        if (shards or config.shards or 1) > 1:
            raise _sharded_unported("RetrievalStore.build(shards > 1)")
        index = MutableHilbertIndex(config, buffer_capacity=buffer_capacity,
                                    max_segments=max_segments, device=device)
        index.bulk_load(keys, values)
        return cls(index=index)

    @property
    def _impl(self) -> MutableHilbertIndex:
        """The backing index: the engine's CURRENT one when attached (after
        a maintenance swap the engine serves the compacted copy)."""
        if self.engine is not None:
            return self.engine.index
        return self.index

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
        """Merge segments / drop tombstones; with an engine attached, a
        forced background-maintenance cycle with an atomic swap."""
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
        """Bytes of segments + buffer + values + tombstones."""
        return self._impl.memory_report()

    def save(self, path: str) -> str:
        """Persist the store as ONE manifest-committed save (values ride in
        the index's state bundle); the JAX package's layout."""
        out = self._impl.save(path, kind=_STORE_KIND)
        _remove_stale_layouts(path)
        return out

    @classmethod
    def load(cls, path: str, *, device: DeviceLike = None) -> "RetrievalStore":
        """Load a store checkpoint saved by either package.

        Resolution: the mutable store (newest), then the first static
        single-index store bundle (adopted as one sealed segment).
        Sharded store checkpoints raise until the sharded layouts are
        ported.
        """
        sharded = [m for m in (_SHARDED_MUTABLE_MANIFEST, _SHARDED_MANIFEST)
                   if os.path.exists(os.path.join(path, m))]
        mutable = os.path.join(path, _MUTABLE_MANIFEST)
        if os.path.exists(mutable):
            newest = max([mutable] + [os.path.join(path, m) for m in sharded],
                         key=lambda p: os.stat(p).st_mtime_ns)
            if newest != mutable and _state_ok(path, newest):
                raise _sharded_unported(f"loading the sharded store at {path!r}")
            index, _ = load_mutable_bundle(path, kind=_STORE_KIND, device=device)
            return cls(index=index)
        if sharded:
            raise _sharded_unported(f"loading the sharded store at {path!r}")
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
