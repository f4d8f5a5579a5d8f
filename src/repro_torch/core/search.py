"""Algorithm 1 stages: approximate k-NN search with a Hilbert forest.

Port of ``repro.core.search``.  Pipeline (paper §3.1): forest candidates
(coarse) → Hamming filter on shared sketches (fine) → master-order ±h
expansion → asymmetric fp32-vs-4-bit distance → top-k.

Candidates are tracked by master-order position, so stage 2 reads
contiguous ±h windows of the resident nibble-packed codes.  A running
deduped top-k2 absorbs each tree's k1 candidates (top-k2 of a union is
associative).

Tie order: ``lax.top_k`` ranks equal values lower index first and
``jnp.argsort`` is stable; ``torch.topk`` gives no such order.  Every
top-k here is therefore a stable ascending ``torch.sort`` sliced to k, and
every argsort passes ``stable=True``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import forest as forest_lib
from repro_torch.core import hilbert, quantize, sketch
from repro_torch.core.quantize import Quantizer
from repro_torch.core.types import ForestConfig
from repro_torch.kernels.hamming import hamming_rows, hamming_rows_ref
from repro_torch.kernels.qdist import qdist_windows, qdist_windows_ref

__all__ = [
    "hilbert_master_sort",
    "stage1_tree_merge",
    "stage1_forest",
    "stage2_expand_rank",
    "stage2_packed_windows",
    "fused_search_chunk",
    "merge_topk",
    "merge_topk_pair",
    "inflate_k",
    "brute_force_topk",
    "paper_memory_model",
]

_INF = 2**30  # int32 "no candidate" Hamming distance


def paper_memory_model(n: int, d: int, sketch_bytes: int, forest_bytes: int
                       ) -> dict:
    """The paper's RAM-budget table (§3.1) as a dict of byte counts."""
    packed_codes = n * (-(-d // 8)) * 4  # 4-bit packed into 32-bit words
    shared = n * (-(-d // 32)) * 4  # MSB plane counted once
    return {
        "forest_bytes": forest_bytes,
        "sketch_bytes": sketch_bytes,
        "quantized_bytes": packed_codes,
        "shared_bit_savings": shared,
        "combined_stage2_bytes": sketch_bytes + packed_codes - shared,
    }


def hilbert_master_sort(points: torch.Tensor, cfg: ForestConfig,
                        lo: torch.Tensor, hi: torch.Tensor):
    """Un-permuted Hilbert sort defining the master order."""
    return hilbert.hilbert_sort(
        points, bits=cfg.bits, key_bits=cfg.key_bits, lo=lo, hi=hi
    )


def _topk_smallest(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k(-values, k)`` as (values, indices): ascending, ties lower index first.

    ``lax.top_k`` orders floats totally, so -0.0 ranks before +0.0 where
    ``torch.sort`` calls them equal; float32 values are therefore sorted by
    their total-order integer key (the sign bit's run of bits flipped).
    """
    key = values
    if values.dtype == torch.float32:
        bits = values.view(torch.int32)
        key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    idx = torch.sort(key, dim=1, stable=True).indices[:, :k]
    return values.gather(1, idx), idx


def _merge_topk_dedup(best_pos, best_dist, new_pos, new_dist, k: int):
    """Merge candidate sets keyed by position; dedup; keep k smallest dists."""
    pos = torch.cat([best_pos, new_pos], dim=1)
    dist = torch.cat([best_dist, new_dist], dim=1)
    # Dedup: sort by position; equal-adjacent entries are duplicates (same
    # position ⇒ same sketch ⇒ same distance), mask all but the first.
    pos_s, sort_idx = torch.sort(pos, dim=1, stable=True)
    dist_s = dist.gather(1, sort_idx)
    dup = torch.zeros_like(pos_s, dtype=torch.bool)
    dup[:, 1:] = pos_s[:, 1:] == pos_s[:, :-1]
    dist_s = torch.where(dup, _INF, dist_s)
    top_d, idx = _topk_smallest(dist_s, k)
    return pos_s.gather(1, idx), top_d


def stage1_tree_merge(
    queries,
    qsketches,
    best_pos,
    best_dist,
    order,
    directory,
    lo,
    hi,
    perm,
    flip,
    master_rank,
    sketches_master,
    *,
    bits,
    key_bits,
    leaf_size,
    k1,
    k2,
    use_kernels=False,
):
    """One tree's stage-1: candidates → Hamming filter → merge into top-k2."""
    cand_ids = forest_lib.tree_candidates(
        queries, order, directory, lo, hi, perm, flip,
        bits=bits, key_bits=key_bits, leaf_size=leaf_size, k1=k1,
    )  # (Q, k1)
    mpos = master_rank[cand_ids]  # (Q, k1) master positions
    csk = sketches_master[mpos]  # (Q, k1, Ws)
    hd = (hamming_rows if use_kernels else hamming_rows_ref)(qsketches, csk)
    return _merge_topk_dedup(best_pos, best_dist, mpos, hd, k2)


def _expand_windows(best_pos, n: int, h: int):
    """±h windows as (starts (Q, k2), pos (Q, k2, window), window size).

    Each surviving stage-1 position expands to a contiguous window of
    ``window = min(2h+1, n)`` master-order rows starting at
    ``clip(best_pos - h, 0, n - window)``.
    """
    window = min(2 * h + 1, n)
    starts = torch.clamp(best_pos - h, 0, n - window)  # (Q, k2)
    pos = starts[:, :, None] + torch.arange(
        window, dtype=starts.dtype, device=starts.device)[None, None, :]
    return starts, pos, window


def _window_slices(rows: torch.Tensor, starts: torch.Tensor, window: int
                   ) -> torch.Tensor:
    """Read (Q, k2) contiguous row windows: (n, W) -> (Q, k2, window, W)."""
    idx = starts[:, :, None] + torch.arange(
        window, dtype=starts.dtype, device=starts.device)
    return rows[idx]


def _dedup_rank_topk(pos, d2, valid, master_order, k: int):
    """Sort by position, mask duplicates/invalid to +inf, final top-k.

    The pool is ``k2 * min(2h+1, n)``; when it is smaller than ``k`` the
    tail is padded with id -1 / +inf.
    """
    pos_s, sort_idx = torch.sort(pos, dim=1, stable=True)
    d2_s = d2.gather(1, sort_idx)
    valid_s = valid.gather(1, sort_idx)
    dup = torch.zeros_like(pos_s, dtype=torch.bool)
    dup[:, 1:] = pos_s[:, 1:] == pos_s[:, :-1]
    d2_s = torch.where((~dup) & valid_s, d2_s, torch.inf)
    k_top = min(k, pos_s.shape[1])
    dist, idx = _topk_smallest(d2_s, k_top)
    ids = master_order[pos_s.gather(1, idx)]
    if k_top < k:
        qn, pad = ids.shape[0], k - k_top
        ids = torch.cat([ids, ids.new_full((qn, pad), -1)], dim=1)
        dist = torch.cat([dist, dist.new_full((qn, pad), torch.inf)], dim=1)
    return ids, dist


def stage2_expand_rank(queries, best_pos, codes_master, master_order,
                       quant: Quantizer, *, h, k):
    """±h expansion, dedup, exact ADC distance, top-k on UNPACKED codes.

    ``codes_master`` is (n, d) uint8.  The reference for
    :func:`stage2_packed_windows`: both share the windowed candidate
    expansion and the dedup/top-k tail, and the plain packed distance
    unpacks losslessly, so the two are bit-identical on the plain route.
    """
    n = master_order.shape[0]
    qn, k2 = best_pos.shape
    starts, pos, window = _expand_windows(best_pos, n, h)
    codes = _window_slices(codes_master, starts, window)  # (Q, k2, window, d)
    codes = codes.reshape(qn, k2 * window, codes_master.shape[1])
    d2 = quantize.adc_distance(quant, queries, codes)
    valid = (best_pos >= 0)[:, :, None].expand(pos.shape)
    return _dedup_rank_topk(
        pos.reshape(qn, -1), d2, valid.reshape(qn, -1), master_order, k
    )


def stage2_packed_windows(
    queries, best_pos, codes_packed, master_order, quant: Quantizer, *, h, k,
    use_kernels=False,
):
    """Stage 2 on the resident nibble-packed codes (n, ceil(d/8)).

    Candidate codes are read as contiguous ±h windows of the packed words;
    distances come from :func:`repro_torch.kernels.qdist.qdist_windows`
    (``use_kernels``) or its plain version.
    """
    n = master_order.shape[0]
    qn, k2 = best_pos.shape
    starts, pos, window = _expand_windows(best_pos, n, h)
    win = _window_slices(codes_packed, starts, window)  # (Q, k2, window, W)
    win = win.reshape(qn, k2 * window, codes_packed.shape[1])
    d2 = (qdist_windows if use_kernels else qdist_windows_ref)(
        queries, win, quant.centroids)
    valid = (best_pos >= 0)[:, :, None].expand(pos.shape)
    return _dedup_rank_topk(
        pos.reshape(qn, -1), d2, valid.reshape(qn, -1), master_order, k
    )


def stage1_forest(
    queries,
    qsketches,
    orders,
    directories,
    lo,
    hi,
    perms,
    flips,
    master_rank,
    sketches_master,
    *,
    bits,
    key_bits,
    leaf_size,
    k1,
    k2,
    use_kernels=False,
):
    """Stage 1 over every tree of the stacked forest -> (Q, k2) best positions.

    The JAX package runs the trees as a ``lax.scan`` inside one jitted
    dispatch (fused) or as a per-tree dispatch loop (reference); here both
    are this Python loop over the stacked forest arrays.
    """
    qn = queries.shape[0]
    best_pos = torch.full((qn, k2), -1, dtype=torch.int32, device=queries.device)
    best_dist = torch.full((qn, k2), _INF, dtype=torch.int32, device=queries.device)
    for t in range(orders.shape[0]):
        best_pos, best_dist = stage1_tree_merge(
            queries, qsketches, best_pos, best_dist,
            orders[t], directories[t], lo, hi, perms[t], flips[t],
            master_rank, sketches_master,
            bits=bits, key_bits=key_bits, leaf_size=leaf_size, k1=k1, k2=k2,
            use_kernels=use_kernels,
        )
    return best_pos


def fused_search_chunk(
    queries,
    orders,
    directories,
    lo,
    hi,
    perms,
    flips,
    master_rank,
    sketches_master,
    codes_packed,
    master_order,
    quant: Quantizer,
    *,
    bits,
    key_bits,
    leaf_size,
    k1,
    k2,
    h,
    k,
    use_kernels=False,
):
    """One query chunk: sketch → stage 1 over every tree → packed stage 2."""
    qsk = sketch.make_sketches(quant, queries)
    best_pos = stage1_forest(
        queries, qsk, orders, directories, lo, hi, perms, flips,
        master_rank, sketches_master,
        bits=bits, key_bits=key_bits, leaf_size=leaf_size, k1=k1, k2=k2,
        use_kernels=use_kernels,
    )
    return stage2_packed_windows(
        queries, best_pos, codes_packed, master_order, quant,
        h=h, k=k, use_kernels=use_kernels,
    )


def merge_topk(ids: torch.Tensor, dists: torch.Tensor, *, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Associative cross-source top-k merge over (id, distance) candidates.

    Args:
      ids: (Q, C) int32 candidate ids; ``-1`` marks a padding slot.
      dists: (Q, C) float distances; non-finite entries are masked out.
      k: results per query.

    Returns ``(ids (Q, k) int32, dists (Q, k))`` by ascending distance,
    with the JAX package's contract: the same id from several sources is
    kept once, at its smallest distance (earliest column among equals);
    survivors keep their columns, so equal distances rank by input column
    ("column-stable tie order"); fewer than ``k`` finite candidates pad the
    tail with id -1 / +inf.
    """
    qn, c = ids.shape
    # Stable lexsort by (id, dist): sort by the secondary key, then stably
    # by the primary one; mark all but the first of every equal-id run and
    # scatter the mask back to the original columns.
    by_dist = torch.sort(dists, dim=1, stable=True).indices
    by_id = torch.sort(ids.gather(1, by_dist), dim=1, stable=True).indices
    order = by_dist.gather(1, by_id)
    ids_s = ids.gather(1, order)
    dup_s = torch.zeros_like(ids_s, dtype=torch.bool)
    dup_s[:, 1:] = ids_s[:, 1:] == ids_s[:, :-1]
    dup = torch.zeros_like(dup_s).scatter_(1, order, dup_s)
    d = torch.where(dup | (ids < 0) | ~torch.isfinite(dists), torch.inf, dists)
    k_top = min(k, c)
    out_d, idx = _topk_smallest(d, k_top)
    out_ids = torch.where(torch.isfinite(out_d), ids.gather(1, idx), -1)
    if k_top < k:
        pad = k - k_top
        out_ids = torch.cat([out_ids, out_ids.new_full((qn, pad), -1)], dim=1)
        out_d = torch.cat([out_d, out_d.new_full((qn, pad), torch.inf)], dim=1)
    return out_ids, out_d


def merge_topk_pair(ids_a, d_a, ids_b, d_b, first, *, k: int):
    """One hop of a pairwise :func:`merge_topk` tree reduction.

    ``first`` (a bool, or a bool tensor broadcast over queries) puts source
    ``a`` in the leading columns; column order breaks distance ties, so two
    ranks that key ``first`` to the lower rank merge identical layouts and
    get bit-identical results.
    """
    first = torch.as_tensor(first, dtype=torch.bool, device=ids_a.device)
    cat_i = torch.where(first, torch.cat([ids_a, ids_b], dim=1),
                        torch.cat([ids_b, ids_a], dim=1))
    cat_d = torch.where(first, torch.cat([d_a, d_b], dim=1),
                        torch.cat([d_b, d_a], dim=1))
    return merge_topk(cat_i, cat_d, k=k)


def inflate_k(k: int, dead: int, pool: int) -> int:
    """Tombstone-aware per-source ``k``: ``k + dead`` capped at the source's
    stage-2 pool and floored at 1 (the LSM search contract)."""
    return max(1, min(k + dead, pool))


def brute_force_topk(queries: torch.Tensor, points: torch.Tensor,
                     valid: torch.Tensor, *, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact squared-L2 top-k against a small point set.

    Gram expansion ``||q||^2 - 2<q,p> + ||p||^2`` (clamped at 0) so the
    transient is (Q, B); rows with ``valid`` False are +inf.  Returns
    ``(row indices (Q, k) int32, d2 (Q, k))``.
    """
    qq = (queries * queries).sum(1)[:, None]
    pp = (points * points).sum(1)[None, :]
    d2 = torch.clamp_min(qq - 2.0 * (queries @ points.T) + pp, 0.0)
    d2 = torch.where(valid[None, :], d2, torch.inf)
    dist, idx = _topk_smallest(d2, k)
    return idx.to(torch.int32), dist
