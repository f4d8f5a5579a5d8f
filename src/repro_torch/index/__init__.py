"""Public API of the port: :class:`HilbertIndex` and its build config."""

from repro_torch.core.types import (ForestConfig, GraphParams, QuantizerConfig,
                                    SearchParams)
from repro_torch.index.config import IndexConfig
from repro_torch.index.convert import index_from_arrays, index_from_jax_bundle
from repro_torch.index.facade import HilbertIndex, build_with_timings

__all__ = [
    "ForestConfig",
    "GraphParams",
    "QuantizerConfig",
    "SearchParams",
    "IndexConfig",
    "HilbertIndex",
    "build_with_timings",
    "index_from_arrays",
    "index_from_jax_bundle",
]
