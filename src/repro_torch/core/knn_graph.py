"""Algorithm 2: approximate k-NN graph construction (Task 2).

Port of ``repro.core.knn_graph``; the public entry point is
``repro_torch.index.HilbertIndex.knn_graph(params)``, which reuses the
index's fitted sketches and bounds.

Every point is a query, so no tree or binary search is needed: a point's
candidates are its ±k1/2 rank neighbours in each randomized Hilbert order.
Each order's candidates are Hamming-filtered on the shared sketches and
merged into a running deduped top-k2 (exact, as top-k2 of a union is
associative), so memory stays constant in the number of orders.  The
survivors are re-ranked by exact fp32 distance to the stored points.

Every row is independent, so the merge runs in row chunks: unchunked at
3M rows, the (n, k1, W) sketch gather alone is 13.8 GB.  Chunking changes
no bit.  Tie order follows ``lax.top_k`` and the stable ``jnp.argsort``:
every top-k is a stable ascending sort sliced to k, never ``torch.topk``.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import hilbert, quantize, sketch
from repro_torch.core.search import _merge_topk_dedup, _topk_smallest
from repro_torch.core.types import ForestConfig, GraphParams, QuantizerConfig
from repro_torch.kernels.hamming import hamming_rows_indexed
from repro_torch.obs.trace import stage

__all__ = [
    "order_and_rank",
    "merge_order",
    "final_select_chunk",
    "graph_survivors",
    "knn_graph_from_sketches",
]

_INF = 2**30  # int32 "no candidate" Hamming distance


def order_and_rank(points, lo, hi, perm, flip, *, bits, key_bits):
    """One Hilbert order (position -> id) and its inverse rank (id -> position)."""
    order, _ = hilbert.hilbert_sort(
        points, bits=bits, key_bits=key_bits, lo=lo, hi=hi, perm=perm, flip=flip
    )
    n = order.shape[0]
    rank = torch.empty((n,), dtype=torch.int32, device=order.device)
    rank.scatter_(0, order.long(),
                  torch.arange(n, dtype=torch.int32, device=order.device))
    return order, rank


def merge_order(best_id, best_dist, order, rank, sketches, *, k1, k2,
                chunk: int = 1 << 16):
    """Merge one Hilbert order's rank-window candidates into the top-k2.

    Offsets are ±k1/2 with 0 left out, positions clipped to [0, n-1]; the
    point's own sketch is the Hamming "query" of ``hamming_rows_indexed``,
    which reads the candidates' sketches from ``sketches`` by id, and self
    matches are masked to 2**30.  Returns new (n, k2) ids and distances.
    """
    n = order.shape[0]
    dev = order.device
    half = k1 // 2
    deltas = torch.cat([torch.arange(-half, 0), torch.arange(1, k1 - half + 1)]
                       ).to(dtype=torch.int32, device=dev)  # k1 offsets
    out_id = torch.empty((n, k2), dtype=torch.int32, device=dev)
    out_dist = torch.empty((n, k2), dtype=torch.int32, device=dev)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        pos = (rank[s:e, None] + deltas[None, :]).clamp_(0, n - 1)
        cand = order[pos.long()]  # (m, k1) ids
        hd = hamming_rows_indexed(sketches[s:e], sketches, cand)
        rows = torch.arange(s, e, dtype=torch.int32, device=dev)
        hd = torch.where(cand == rows[:, None], _INF, hd)
        out_id[s:e], out_dist[s:e] = _merge_topk_dedup(
            best_id[s:e], best_dist[s:e], cand, hd, k2)
    return out_id, out_dist


def final_select_chunk(points, best_id_chunk, row_start: int, *, k: int):
    """Exact fp32 squared distances to the k2 survivors; stable top-k.

    Ids < 0 and self are set to +inf.  The candidates are gathered once and
    turned into squared differences in place, so one (C, k2, d) transient
    is held; ``(c - p)**2`` is bit-equal to ``(p - c)**2``.
    """
    c = best_id_chunk.shape[0]
    rows = torch.arange(row_start, row_start + c, dtype=torch.int32,
                        device=points.device)
    diff = points[best_id_chunk.long()]  # (C, k2, d); id -1 reads the last row
    diff.sub_(points[row_start : row_start + c, None, :]).square_()
    d2 = diff.sum(-1)
    d2 = torch.where((best_id_chunk < 0) | (best_id_chunk == rows[:, None]),
                     torch.inf, d2)
    dist, idx = _topk_smallest(d2, k)
    return best_id_chunk.gather(1, idx), dist


def graph_survivors(
    points: torch.Tensor,
    sketches: torch.Tensor,
    params: GraphParams,
    *,
    bits: int,
    key_bits: int,
    lo: torch.Tensor,
    hi: torch.Tensor,
    chunk: int = 1 << 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (n, k2) ids and Hamming distances left after all ``n_orders``.

    Perms and flips come from ``np.random.default_rng(params.seed)`` in the
    JAX package's draw order (per order a permutation, then the flips), so
    every order matches the JAX run.
    """
    n, d = points.shape
    dev = points.device
    rng = np.random.default_rng(params.seed)
    best_id = torch.full((n, params.k2), -1, dtype=torch.int32, device=dev)
    best_dist = torch.full((n, params.k2), _INF, dtype=torch.int32, device=dev)
    for o in range(params.n_orders):
        perm = torch.as_tensor(rng.permutation(d).astype(np.int32), device=dev)
        flip = torch.as_tensor(rng.integers(0, 2, d).astype(bool), device=dev)
        order, rank = order_and_rank(points, lo, hi, perm, flip, bits=bits,
                                     key_bits=key_bits)
        with stage("graph.merge", device=dev, order=o, rows=n, k1=params.k1,
                   k2=params.k2):
            best_id, best_dist = merge_order(best_id, best_dist, order, rank, sketches,
                                             k1=params.k1, k2=params.k2, chunk=chunk)
    return best_id, best_dist


def knn_graph_from_sketches(
    points: torch.Tensor,
    sketches: torch.Tensor,
    params: GraphParams,
    *,
    bits: int,
    key_bits: int,
    lo: torch.Tensor,
    hi: torch.Tensor,
    chunk: int = 1 << 16,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full Algorithm-2 pipeline over sketches in point-id order.

    Returns ``(ids (n, k) int32, sq_distances (n, k) float32)``, self
    excluded.  ``chunk`` bounds the rows of each merge and re-rank pass.
    """
    best_id, _ = graph_survivors(points, sketches, params, bits=bits,
                                 key_bits=key_bits, lo=lo, hi=hi, chunk=chunk)
    ids_out, d_out = [], []
    for s in range(0, points.shape[0], chunk):
        ids_c, d_c = final_select_chunk(points, best_id[s : s + chunk], s,
                                        k=params.k)
        ids_out.append(ids_c)
        d_out.append(d_c)
    return torch.cat(ids_out), torch.cat(d_out)


def build_knn_graph(points, params: GraphParams,
                    quant_cfg: QuantizerConfig = QuantizerConfig(),
                    forest_cfg: ForestConfig = ForestConfig(), chunk: int = 1 << 16, *,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """DEPRECATED: use ``repro_torch.index.HilbertIndex.build(...).knn_graph(...)``,
    which reuses the quantizer and sketches fitted at build time; this
    fits them again on every call."""
    warnings.warn(
        "repro_torch.core.knn_graph.build_knn_graph is deprecated; use "
        "repro_torch.index.HilbertIndex.knn_graph(params), which reuses the "
        "index's fitted quantizer/sketches", DeprecationWarning, stacklevel=2)
    from repro_torch.index.facade import resolve_device

    points = torch.as_tensor(points, dtype=torch.float32, device=resolve_device(device))
    quant = quantize.fit(points, bits=quant_cfg.bits, sample_limit=quant_cfg.sample_limit)
    sketches = sketch.sketches_from_codes(quantize.encode(quant, points),
                                          bits=quant_cfg.bits)
    return knn_graph_from_sketches(
        points, sketches, params, bits=forest_cfg.bits, key_bits=forest_cfg.key_bits,
        lo=points.min(dim=0).values, hi=points.max(dim=0).values, chunk=chunk)
