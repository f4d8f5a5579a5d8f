"""IndexConfig: the single build-time configuration for :class:`HilbertIndex`.

A copy of ``repro.index.config``: the same fields and the same
``to_dict``/``from_dict`` round trip, so a manifest written by either
package configures an index in the other.  Fields of the sharded layouts,
which only the JAX package has yet (``shards``, ``merge``,
``merge_prune``), are carried unchanged so the manifest round-trips.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.core.types import ForestConfig, QuantizerConfig

__all__ = ["IndexConfig"]


def _filter_fields(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    """Keep only known dataclass fields (forward-compatible manifests)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Everything needed to (re)build or interpret a :class:`HilbertIndex`.

    Attributes:
      forest: Hilbert-forest shape (trees, curve bits, key width, leaf size).
      quantizer: 4-bit shared-MSB quantizer settings.
      store_points: keep the raw fp32 points on the index.
      query_chunk: search chunk cap; chunks are padded to power-of-two
        buckets up to this cap.
      mutable: the JAX package's ``build_auto`` picks the streaming facade
        (:class:`MutableHilbertIndex`) when set.
      seal_pow2: :class:`MutableHilbertIndex` pads every seal and tier
        merge to a power-of-two row count (duplicate rows share external
        ids); compaction and bulk loads never pad.
      shards, merge, merge_prune: layout settings of the JAX package's
        sharded facades, carried so manifests round-trip.
    """

    forest: ForestConfig = ForestConfig()
    quantizer: QuantizerConfig = QuantizerConfig()
    store_points: bool = True
    query_chunk: int = 2048
    shards: Optional[int] = None
    mutable: bool = False
    seal_pow2: bool = False
    merge: str = "auto"
    merge_prune: bool = False

    def to_dict(self) -> Dict[str, Any]:
        """Manifest form of the config; ``from_dict(to_dict(cfg)) == cfg``."""
        return {
            "forest": dataclasses.asdict(self.forest),
            "quantizer": dataclasses.asdict(self.quantizer),
            "store_points": self.store_points,
            "query_chunk": self.query_chunk,
            "shards": self.shards,
            "mutable": self.mutable,
            "seal_pow2": self.seal_pow2,
            "merge": self.merge,
            "merge_prune": self.merge_prune,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "IndexConfig":
        """Inverse of :meth:`to_dict`; unknown keys are dropped, missing keys
        take the field defaults."""
        shards = d.get("shards")
        return cls(
            forest=ForestConfig(**_filter_fields(ForestConfig, d.get("forest", {}))),
            quantizer=QuantizerConfig(
                **_filter_fields(QuantizerConfig, d.get("quantizer", {}))
            ),
            store_points=bool(d.get("store_points", True)),
            query_chunk=int(d.get("query_chunk", 2048)),
            shards=None if shards is None else int(shards),
            mutable=bool(d.get("mutable", False)),
            seal_pow2=bool(d.get("seal_pow2", False)),
            merge=str(d.get("merge", "auto")),
            merge_prune=bool(d.get("merge_prune", False)),
        )
