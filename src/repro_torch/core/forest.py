"""Hilbert forest: multiple Hilbert trees under randomized axis orders.

Port of ``repro.core.forest``.  A tree is the Hilbert-sorted **order** (an
int32 permutation) plus a **rank directory** — every ``leaf_size``-th
sorted key — searched by a vectorized lexicographic binary search.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import hilbert
from repro_torch.core.types import ForestConfig
from repro_torch.obs.trace import stage

__all__ = ["HilbertForest", "forest_randomization", "build_forest", "tree_candidates"]


class HilbertForest(NamedTuple):
    """Stacked per-tree state (T trees over n points in d dims)."""

    perms: torch.Tensor  # (T, d) int32 — randomized axis orders
    flips: torch.Tensor  # (T, d) bool  — randomized reflections
    orders: torch.Tensor  # (T, n) int32 — point ids in per-tree Hilbert order
    directories: torch.Tensor  # (T, n_dir, W) int32 words — sampled sorted keys
    lo: torch.Tensor  # (d,) quantization bounds
    hi: torch.Tensor  # (d,)

    @property
    def n_trees(self) -> int:
        return self.orders.shape[0]

    @property
    def n_points(self) -> int:
        return self.orders.shape[1]

    def memory_bytes(self) -> int:
        """Index footprint of the forest arrays (the paper's budget accounting)."""
        return sum(
            a.numel() * a.element_size()
            for a in (self.perms, self.flips, self.orders, self.directories)
        )


def forest_randomization(cfg: ForestConfig, d: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per-tree axis permutations and reflections from ``cfg.seed`` (numpy rng,
    as in the JAX package, so both packages draw the same trees)."""
    rng = np.random.default_rng(cfg.seed)
    perms = np.stack([rng.permutation(d) for _ in range(cfg.n_trees)]).astype(np.int32)
    flips = rng.integers(0, 2, size=(cfg.n_trees, d)).astype(bool)
    return perms, flips


def build_forest(points: torch.Tensor, cfg: ForestConfig) -> HilbertForest:
    """Build ``cfg.n_trees`` Hilbert trees (one key array live at a time)."""
    d = points.shape[1]
    lo = points.amin(0)
    hi = points.amax(0)
    perms_np, flips_np = forest_randomization(cfg, d)
    perms = torch.as_tensor(perms_np, device=points.device)
    flips = torch.as_tensor(flips_np, device=points.device)
    orders, dirs = [], []
    for t in range(cfg.n_trees):
        order, sorted_keys = hilbert.hilbert_sort(
            points, bits=cfg.bits, key_bits=cfg.key_bits, lo=lo, hi=hi,
            perm=perms[t], flip=flips[t],
        )
        orders.append(order)
        dirs.append(sorted_keys[:: cfg.leaf_size].clone())
    return HilbertForest(
        perms=perms,
        flips=flips,
        orders=torch.stack(orders),
        directories=torch.stack(dirs),
        lo=lo,
        hi=hi,
    )


def tree_candidates(
    queries: torch.Tensor,
    order: torch.Tensor,
    directory: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    perm: torch.Tensor,
    flip: torch.Tensor,
    *,
    bits: int,
    key_bits: int,
    leaf_size: int,
    k1: int,
) -> torch.Tensor:
    """Per-tree stage-1: locate each query in Hilbert order, take k1 around.

    Returns (Q, k1) int32 point ids.  Window edges clip; duplicates are
    handled downstream.
    """
    n = order.shape[0]
    with stage("search.keys"):
        qkeys = hilbert.hilbert_keys(
            queries, bits=bits, key_bits=key_bits, lo=lo, hi=hi, perm=perm, flip=flip
        )
    with stage("search.directory"):
        j = hilbert.lex_searchsorted(directory, qkeys)  # (Q,) in [0, n_dir + 1]
    # directory[j-1] <= q < directory[j]  =>  true rank in ((j-1)·leaf, j·leaf];
    # center the window on the interval midpoint to avoid a +leaf/2 bias.
    rank = torch.clamp(j * leaf_size - leaf_size // 2, 0, n - 1)
    start = torch.clamp(rank - k1 // 2, 0, max(n - k1, 0))
    pos = start[:, None] + torch.arange(k1, device=queries.device)[None, :]
    pos = torch.clamp(pos, 0, n - 1)
    return order[pos]
