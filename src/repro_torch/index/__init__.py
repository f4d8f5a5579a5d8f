"""Public API of the port: :class:`HilbertIndex`, the streaming
:class:`MutableHilbertIndex`, the row-partitioned
:class:`ShardedHilbertIndex` and its streaming
:class:`ShardedMutableHilbertIndex`, ``build_auto``, and their build
config."""

from repro_torch.core.types import (ForestConfig, GraphParams, QuantizerConfig,
                                    SearchParams)
from repro_torch.index.config import IndexConfig
from repro_torch.index.convert import index_from_arrays, load_index_bundle
from repro_torch.checkpoint.wal import WalConfig
from repro_torch.index.facade import HilbertIndex, build_with_timings
from repro_torch.index.mutable import (LsmIdSpace, MutableHilbertIndex, Segment,
                                       load_mutable_bundle, save_mutable_bundle)
from repro_torch.index.sharded import ShardedHilbertIndex, build_auto
from repro_torch.index.sharded_mutable import (ShardedMutableHilbertIndex,
                                               ShardedSegment,
                                               load_sharded_mutable_as_mutable,
                                               load_sharded_mutable_bundle,
                                               save_sharded_mutable_bundle)

__all__ = [
    "ForestConfig",
    "GraphParams",
    "QuantizerConfig",
    "SearchParams",
    "IndexConfig",
    "HilbertIndex",
    "build_with_timings",
    "index_from_arrays",
    "load_index_bundle",
    "LsmIdSpace",
    "MutableHilbertIndex",
    "Segment",
    "WalConfig",
    "load_mutable_bundle",
    "save_mutable_bundle",
    "ShardedHilbertIndex",
    "ShardedMutableHilbertIndex",
    "ShardedSegment",
    "build_auto",
    "load_sharded_mutable_as_mutable",
    "load_sharded_mutable_bundle",
    "save_sharded_mutable_bundle",
]
