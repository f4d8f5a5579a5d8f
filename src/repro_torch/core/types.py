"""Config dataclasses of the Hilbert forest core (copies of ``repro.core.types``)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ForestConfig:
    """Hilbert forest shape.

    Attributes:
      n_trees: number of Hilbert trees (paper: ``n``; Task 1 used up to 160).
      bits: grid bits per axis for the curve (curve depth).
      key_bits: truncated Hilbert-key width in bits (packed to 32-bit words).
      leaf_size: points per compressed-tree leaf (paper: ~100); the rank
        directory stores every ``leaf_size``-th key.
      seed: numpy seed for per-tree axis permutations/reflections.
    """

    n_trees: int = 16
    bits: int = 4
    key_bits: int = 128
    leaf_size: int = 100
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class QuantizerConfig:
    """4-bit shared-MSB quantizer (paper §3.1).

    ``bits=4`` gives 16 quantile cells per dim whose upper half starts at the
    median — the code MSB doubles as the sketch bit ("one bit is shared").
    """

    bits: int = 4
    sample_limit: int = 262144  # quantile-fit subsample


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Algorithm 1 hyper-parameters (paper Table 1 names)."""

    k1: int = 64  # candidates per query per tree
    k2: int = 128  # sketch-filter survivors
    h: int = 2  # master-order expansion half-width
    k: int = 30  # final neighbors returned



@dataclasses.dataclass(frozen=True)
class GraphParams:
    """Algorithm 2 hyper-parameters (paper Table 2 names)."""

    n_orders: int = 80
    k1: int = 96
    k2: int = 60
    k: int = 15
    seed: int = 0
