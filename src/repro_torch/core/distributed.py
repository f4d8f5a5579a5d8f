"""The sharded Hilbert sort, the sharded k-NN graph and the cross-shard merges.

Port of ``repro.core.distributed``.  Where the JAX package runs each
function inside ``shard_map`` over a mesh's ``data`` axis, the port runs
it over S logical shards stacked on a leading axis, and every exchange
between shards goes through :class:`repro_torch.core.shard_group.ShardGroup`
(``all_gather``, ``all_to_all``, ``ppermute``, ``pmin``, ``axis_index``).
A global ``(n, ...)`` input is shard-major, as a ``P('data')`` array is:
shard r owns rows ``[r n/S, (r+1) n/S)``.

* The **sample sort** (:func:`sample_sort_sharded`): local key sort, an
  all-gathered sample of splitters, bucketing, one ``all_to_all`` of the
  keys with their payload, a local merge.  Every shard ends with a padded
  slice of the global Hilbert order: a valid prefix, then sentinel rows of
  all-ones keys; rows that a full bucket would drop are counted as
  overflow, which must be zero.
* **Task 2 across shards** (:func:`distributed_knn_graph`): each shard's
  ±k1/2 windows reach into its neighbours through a ``ppermute`` halo of
  their edge rows, candidates travel to their home shard (``gid //
  (n/S)``) by a second ``all_to_all``, and the running top-k2 merge is
  that of the single-device graph.
* The **cross-shard top-k merges** of the sharded facades
  (:func:`cross_shard_merge_topk`): a butterfly of pairwise merges, or one
  flat merge of every shard's pool.

Packed words are int32 tensors holding the JAX package's uint32 bits, so
the all-ones sentinel key is -1 in every word.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import hilbert, quantize, sketch
from repro_torch.core import search as search_lib
from repro_torch.core.search import _topk_smallest
from repro_torch.core.shard_group import ShardGroup
from repro_torch.core.types import ForestConfig, GraphParams
from repro_torch.kernels.hamming import hamming_rows_indexed

__all__ = [
    "sample_sort_sharded",
    "distributed_hilbert_order",
    "hilbert_partition",
    "curve_partition_bounds",
    "route_to_shards",
    "halo_tables",
    "halo_window_candidates",
    "route_home",
    "graph_order",
    "final_ranking",
    "distributed_knn_graph",
    "is_pow2",
    "resolve_merge",
    "tree_merge_topk",
    "gather_merge_topk",
    "cross_shard_merge_topk",
    "merge_topk_rows",
]

_INF = 2**30  # int32 "no candidate" Hamming distance
_MAX_WORD = -1  # an all-ones uint32 word, as int32 bits

# Rows per pass of the Task-2 merge and final ranking: bounds the (rows,
# k2, d) candidate codes of the final ranking (69 GB unchunked at 3M x 60
# x 384); chunking changes no bit.
_ROW_CHUNK = 1 << 14


# ---------------------------------------------------------------------------
# Sample sort
# ---------------------------------------------------------------------------


def _local_lexsort(keys: torch.Tensor) -> torch.Tensor:
    """Stable argsort (int64) of (n, W) packed keys, word 0 primary."""
    return hilbert._lexsort_words(keys)


def _bucket_of(splitters: torch.Tensor, keys_sorted: torch.Tensor) -> torch.Tensor:
    """Splitters (p-1, W) sorted; keys (n, W) -> (n,) int64 buckets in [0, p).

    A key's bucket is the number of splitters at or below it.  With p = 1
    there are no splitters and every key is in bucket 0.
    """
    bucket = torch.zeros(keys_sorted.shape[0], dtype=torch.int64,
                         device=keys_sorted.device)
    for j in range(splitters.shape[0]):
        bucket += ~hilbert.lex_less(keys_sorted, splitters[j][None, :])
    return bucket


def _scatter_rows(v: torch.Tensor, slot: torch.Tensor, rows: int, fill) -> torch.Tensor:
    """``rows`` rows of ``fill`` with row ``slot[i]`` set to ``v[i]``.

    Slots are unique except the dump slot ``rows``, one past the end, which
    several rows may share; it is sliced away, so the write order of its
    duplicates never matters.
    """
    out = torch.full((rows + 1,) + tuple(v.shape[1:]), fill, dtype=v.dtype,
                     device=v.device)
    out.index_put_((slot,), v)
    return out[:rows]


def sample_sort_sharded(
    group: ShardGroup,
    keys: torch.Tensor,
    payload: Dict[str, torch.Tensor],
    oversample: int = 64,
    cap_factor: float = 2.0,
):
    """Sample-sort (S, ln, W) per-shard keys, carrying their payload.

    ``payload`` maps names to (S, ln, ...) tensors.  Returns ``(keys_out
    (S, cap_total, W), payload_out, n_valid (S,) int32, overflow (S,)
    int32)`` with ``cap_total = p * max(8, int(cap_factor * ln / p))``;
    rows at or past ``n_valid[r]`` are sentinels (all-ones keys; payload 0
    for floats, -1 otherwise).  Concatenating the valid prefixes over
    shards gives the globally sorted sequence, equal keys in the order of
    their global rows.
    """
    p = group.size
    _, ln, w = keys.shape
    cap = max(8, int(cap_factor * ln / p))  # per (src, dst) bucket slots
    names = list(payload)

    # --- local sort, then splitters from an all-gathered sample ---
    keys_s, pay_s = [], {k: [] for k in names}
    for r in range(p):
        order = _local_lexsort(keys[r])
        keys_s.append(keys[r][order])
        for k in names:
            pay_s[k].append(payload[k][r][order])
    s = min(oversample, ln)
    samp_idx = torch.arange(s, device=keys.device) * (ln // s)
    cand = torch.stack([ks[samp_idx] for ks in keys_s])  # (p, s, W)
    flat = group.all_gather(cand).reshape(p * s, w)
    flat = flat[_local_lexsort(flat)]
    splitters = flat[torch.arange(1, p, device=keys.device) * s - 1]  # (p-1, W)

    # --- bucket, then one all_to_all of the keys and each payload ---
    send_keys, send_pay = [], {k: [] for k in names}
    overflow = torch.zeros(p, dtype=torch.int32, device=keys.device)
    for r in range(p):
        bucket = _bucket_of(splitters, keys_s[r])  # nondecreasing
        counts = torch.bincount(bucket, minlength=p)
        offsets = torch.cumsum(counts, 0) - counts
        pos = torch.arange(ln, device=keys.device) - offsets[bucket]
        valid = pos < cap
        overflow[r] = (~valid).sum()
        slot = torch.where(valid, bucket * cap + pos, p * cap)
        send_keys.append(_scatter_rows(keys_s[r], slot, p * cap, _MAX_WORD
                                       ).reshape(p, cap, w))
        for k in names:
            v = pay_s[k][r]
            fill = 0 if v.is_floating_point() else -1
            send_pay[k].append(_scatter_rows(v, slot, p * cap, fill).reshape(
                (p, cap) + tuple(v.shape[1:])))
    recv_keys = group.all_to_all(torch.stack(send_keys)).reshape(p, p * cap, w)
    recv_pay = {}
    for k in names:
        rv = group.all_to_all(torch.stack(send_pay[k]))
        recv_pay[k] = rv.reshape((p, p * cap) + tuple(rv.shape[3:]))

    # --- local merge; sentinels (all-ones keys) sort to the tail ---
    keys_out = torch.empty_like(recv_keys)
    pay_out = {k: torch.empty_like(v) for k, v in recv_pay.items()}
    for r in range(p):
        morder = _local_lexsort(recv_keys[r])
        keys_out[r] = recv_keys[r][morder]
        for k in names:
            pay_out[k][r] = recv_pay[k][r][morder]
    n_valid = (~(keys_out == _MAX_WORD).all(2)).sum(1).to(torch.int32)
    return keys_out, pay_out, n_valid, overflow


# ---------------------------------------------------------------------------
# Distributed Hilbert order and the partition of the sharded facade
# ---------------------------------------------------------------------------


def distributed_hilbert_order(
    group: ShardGroup,
    points: torch.Tensor,
    cfg: ForestConfig,
    lo: torch.Tensor,
    hi: torch.Tensor,
    perm: Optional[torch.Tensor] = None,
    flip: Optional[torch.Tensor] = None,
    payload: Optional[Dict[str, torch.Tensor]] = None,
    cap_factor: float = 2.0,
):
    """Global Hilbert ordering of (n, d) shard-major points (+ payload).

    ``n`` must be a multiple of the shard count.  Each point carries its
    global row as payload ``"gid"``; ``payload`` adds (n, ...) tensors.
    Returns :func:`sample_sort_sharded`'s four outputs.
    """
    if points.shape[0] % group.size:
        raise ValueError(f"{points.shape[0]} rows do not split into {group.size} "
                         "equal shards")
    keys = hilbert.hilbert_keys(points, bits=cfg.bits, key_bits=cfg.key_bits,
                                lo=lo, hi=hi, perm=perm, flip=flip)
    return _sort_rows(group, keys, payload, cap_factor)


def _sort_rows(group: ShardGroup, keys: torch.Tensor,
               payload: Optional[Dict[str, torch.Tensor]], cap_factor: float = 2.0):
    """:func:`sample_sort_sharded` of (n, W) shard-major keys, each row
    carrying its global row as ``"gid"`` and its rows of ``payload``."""
    p = group.size
    n = keys.shape[0]
    pay = {"gid": torch.arange(n, dtype=torch.int32, device=keys.device)}
    pay.update(payload or {})
    stacked = {k: v.reshape((p, n // p) + tuple(v.shape[1:])) for k, v in pay.items()}
    return sample_sort_sharded(group, keys.reshape(p, n // p, -1), stacked,
                               cap_factor=cap_factor)


def hilbert_partition(points: torch.Tensor, cfg: ForestConfig,
                      n_shards: int) -> List[torch.Tensor]:
    """Row-partition ``points`` into ``n_shards`` runs of the master Hilbert order.

    The layout of :class:`repro_torch.index.sharded.ShardedHilbertIndex`:
    each returned int32 tensor of global rows is one shard's residency set,
    and their concatenation walks the un-permuted master curve.  With more
    than one shard and ``n`` a multiple of the count, the order comes from
    the sample sort over the shards; otherwise, or when the sample sort
    overflows, from the single sort of every row (same keys, equal keys in
    row order either way).

    Returns ``n_shards`` tensors of ``ceil(n / n_shards)`` rows (the last
    may be shorter; shards past the data are empty).
    """
    n = points.shape[0]
    lo = points.amin(0)
    hi = points.amax(0)
    order = None
    if n_shards > 1 and n % n_shards == 0:
        group = ShardGroup(n_shards, points.device)
        _, pay_o, n_valid, ovf = distributed_hilbert_order(group, points, cfg, lo, hi)
        if int(ovf.sum()) == 0:
            nv = n_valid.tolist()
            order = torch.cat([pay_o["gid"][r, : nv[r]] for r in range(n_shards)])
        # Overflow would drop rows: take the exact single sort instead.
    if order is None:
        order, _ = search_lib.hilbert_master_sort(points, cfg, lo, hi)
    per = -(-n // n_shards)
    return [order[s * per : (s + 1) * per] for s in range(n_shards)]


def curve_partition_bounds(
    first_points: Sequence,
    cfg: ForestConfig,
    lo: torch.Tensor,
    hi: torch.Tensor,
) -> torch.Tensor:
    """Master-curve opening keys of a contiguous Hilbert partition.

    ``first_points[s]`` is the first row (in master-curve order) that shard
    ``s`` owns, a (d,) array or tensor, or ``None`` for an empty shard.
    Returns ``(S-1, W)`` int32 words where row ``s-1`` is shard ``s``'s
    opening key; an empty shard gets the all-ones key, so
    :func:`route_to_shards` never routes a row to it.  Keys use the global
    ``lo``/``hi`` the partition used, on ``lo``'s device.
    """
    n_shards = len(first_points)
    w = hilbert.key_words(cfg.key_bits)
    bounds = torch.full((max(n_shards - 1, 0), w), _MAX_WORD, dtype=torch.int32,
                        device=lo.device)
    present = [s for s in range(1, n_shards) if first_points[s] is not None]
    if present:
        pts = torch.stack([torch.as_tensor(first_points[s], dtype=torch.float32,
                                           device=lo.device) for s in present])
        keys = hilbert.hilbert_keys(pts, bits=cfg.bits, key_bits=cfg.key_bits,
                                    lo=lo, hi=hi)
        bounds[torch.as_tensor(present, device=lo.device) - 1] = keys
    return bounds


def route_to_shards(
    points,
    cfg: ForestConfig,
    lo: torch.Tensor,
    hi: torch.Tensor,
    bounds: torch.Tensor,
) -> torch.Tensor:
    """(m,) int32 shard of each of the (m, d) rows: the number of
    :func:`curve_partition_bounds` keys at or below its master-curve key.

    Rows outside the frozen ``lo``/``hi`` box clamp to its edge, as the
    curve quantization does, so every row is routed.
    """
    points = torch.as_tensor(points, dtype=torch.float32, device=lo.device)
    shard = torch.zeros(points.shape[0], dtype=torch.int32, device=lo.device)
    if points.shape[0] == 0:
        return shard
    keys = hilbert.hilbert_keys(points, bits=cfg.bits, key_bits=cfg.key_bits,
                                lo=lo, hi=hi)
    for b in bounds:
        shard += ~hilbert.lex_less(keys, b[None, :])
    return shard


# ---------------------------------------------------------------------------
# Halo windows (Task-2 stage 1 across shard edges)
# ---------------------------------------------------------------------------


def halo_tables(
    group: ShardGroup,
    gids_sorted: torch.Tensor,
    sketches_sorted: torch.Tensor,
    n_valid: torch.Tensor,
    k1: int,
):
    """Each shard's extended gid and sketch tables, and its windows' rows in them.

    A shard's extended table is ``[previous shard's last k1/2 valid rows |
    its own L rows | k1/2 sentinel slots]``, with the next shard's first
    k1/2 rows spliced in right after its valid prefix; the first shard has
    no previous rows (-1) and the last no next (-1).  Returns ``(ext_g (S,
    L + k1/2·2) int32, ext_s (S, L + k1/2·2, Ws), pos (L, k1) int64)``:
    row i's window is ``ext[pos[i]]``, the ±k1/2 neighbours without i.
    Arguments as :func:`halo_window_candidates`'.
    """
    p = group.size
    half = k1 // 2
    ln = gids_sorted.shape[1]
    dev = gids_sorted.device
    nv = n_valid.to(device=dev, dtype=torch.int64)
    ar = torch.arange(half, device=dev)
    rows = torch.arange(p, device=dev)[:, None]

    # Halo: each shard's first and last `half` valid rows, to its neighbours.
    first_g = gids_sorted[:, :half]
    first_s = sketches_sorted[:, :half]
    tail = (nv - half).clamp_min(0)[:, None] + ar  # (S, half)
    idx = tail.clamp_max(ln - 1)
    last_g = torch.where(tail < nv[:, None], gids_sorted[rows, idx], -1)
    last_s = sketches_sorted[rows, idx]
    fwd = [(i, (i + 1) % p) for i in range(p)]
    bwd = [(i, (i - 1) % p) for i in range(p)]
    from_prev_g = group.ppermute(last_g, fwd)  # the previous shard's tail
    from_prev_s = group.ppermute(last_s, fwd)
    from_next_g = group.ppermute(first_g, bwd)  # the next shard's head
    from_next_s = group.ppermute(first_s, bwd)
    rank = group.axis_index()[:, None]
    from_prev_g = torch.where(rank == 0, -1, from_prev_g)
    from_next_g = torch.where(rank == p - 1, -1, from_next_g)

    ext_g = torch.cat([from_prev_g, gids_sorted, gids_sorted.new_full((p, half), -1)], 1)
    ext_s = torch.cat([from_prev_s, sketches_sorted, sketches_sorted.new_zeros(
        (p, half) + tuple(sketches_sorted.shape[2:]))], 1)
    at = half + nv[:, None] + ar  # (S, half) unique slots a shard
    ext_g[rows, at] = from_next_g
    ext_s[rows, at] = from_next_s

    deltas = torch.cat([torch.arange(-half, 0), torch.arange(1, k1 - half + 1)]
                       ).to(device=dev)
    pos = (torch.arange(ln, device=dev)[:, None] + half + deltas[None, :]
           ).clamp_(0, ln + 2 * half - 1)
    return ext_g, ext_s, pos


def halo_window_candidates(
    group: ShardGroup,
    gids_sorted: torch.Tensor,
    sketches_sorted: torch.Tensor,
    n_valid: torch.Tensor,
    k1: int,
):
    """Each resident row's k1 window candidates and their Hamming distances.

    Args:
      gids_sorted: (S, L) int32, each shard's slice of the global order
        (-1 = sentinel), as :func:`sample_sort_sharded` leaves it.
      sketches_sorted: (S, L, Ws) int32 words in the same order.
      n_valid: (S,) valid rows a shard.
      k1: window size; the offsets are ±k1/2 without 0.

    Returns ``(cand (S, L, k1) int32 gids, dist (S, L, k1) int32)``; a
    candidate past the data, a sentinel row's candidates and the row itself
    are -1 / 2**30.  Windows reach across shard edges through a halo of
    each neighbour's first and last k1/2 valid rows (:func:`halo_tables`),
    so with even k1 and shards of at least k1/2 valid rows they equal the
    single-shard windows.  The distances come from ``hamming_rows_indexed``,
    one launch a shard, which reads each window's sketches from the
    shard's extended table by position.
    """
    ext_g, ext_s, pos = halo_tables(group, gids_sorted, sketches_sorted, n_valid, k1)
    p, ln = gids_sorted.shape
    row_ok = (torch.arange(ln, device=pos.device)[None, :]
              < n_valid.to(pos.device)[:, None])[:, :, None]
    cand = ext_g[:, pos]  # (S, L, k1)
    cand = torch.where(row_ok & (cand >= 0), cand, -1)
    dist = torch.empty_like(cand)
    for r in range(p):
        dist[r] = hamming_rows_indexed(sketches_sorted[r].contiguous(), ext_s[r], pos)
    dist.masked_fill_((cand < 0) | (cand == gids_sorted[:, :, None]), _INF)
    return cand, dist


# ---------------------------------------------------------------------------
# Route candidates home + merge (Task-2 main loop)
# ---------------------------------------------------------------------------


def route_home(
    group: ShardGroup,
    owner_gid: torch.Tensor,
    cand_g: torch.Tensor,
    cand_d: torch.Tensor,
    n_points: int,
    cap_factor: float = 1.5,
):
    """Send each row's candidates to the shard that owns its gid.

    ``owner_gid`` (S, L) int32 (-1 sentinel), ``cand_g``/``cand_d`` (S, L,
    k1).  Shard r owns gids ``[r n/S, (r+1) n/S)``.  Returns ``(cands (S,
    n/S, k1), dists (S, n/S, k1), overflow (S,) int32)`` in home-local gid
    order; a gid that did not arrive keeps -1 / 2**30.
    """
    p = group.size
    local_n = n_points // p
    k1 = cand_g.shape[2]
    cap = max(8, int(cap_factor * local_n / p))
    dev = owner_gid.device
    overflow = torch.zeros(p, dtype=torch.int32, device=dev)
    send_g, send_c, send_d = [], [], []
    for r in range(p):
        og = owner_gid[r]
        ok = og >= 0
        home = torch.where(ok, og.div(local_n, rounding_mode="floor"), p).long()
        # A row's slot in its home's bucket: the earlier valid rows with the
        # same home.  The scan runs along rows in a (p, L) layout (innermost).
        member = (home[None, :] == torch.arange(p, device=dev)[:, None]) & ok[None, :]
        run = torch.cumsum(member, 1, dtype=torch.int32)
        pos = run.gather(0, home.clamp(0, p - 1)[None, :])[0].long() - 1
        valid = ok & (pos < cap)
        overflow[r] = (ok & (pos >= cap)).sum()
        slot = torch.where(valid, home * cap + pos, p * cap)
        send_g.append(_scatter_rows(og, slot, p * cap, -1).reshape(p, cap))
        send_c.append(_scatter_rows(cand_g[r], slot, p * cap, -1).reshape(p, cap, k1))
        send_d.append(_scatter_rows(cand_d[r], slot, p * cap, _INF).reshape(p, cap, k1))
    recv_g = group.all_to_all(torch.stack(send_g)).reshape(p, p * cap)
    recv_c = group.all_to_all(torch.stack(send_c)).reshape(p, p * cap, k1)
    recv_d = group.all_to_all(torch.stack(send_d)).reshape(p, p * cap, k1)

    rank = group.axis_index()[:, None]
    local_gid = torch.where(recv_g >= 0, recv_g - rank * local_n, local_n).long()
    out_c = torch.full((p, local_n + 1, k1), -1, dtype=torch.int32, device=dev)
    out_d = torch.full((p, local_n + 1, k1), _INF, dtype=torch.int32, device=dev)
    for r in range(p):
        out_c[r].index_put_((local_gid[r],), recv_c[r])
        out_d[r].index_put_((local_gid[r],), recv_d[r])
    return out_c[:, :local_n], out_d[:, :local_n], overflow


def _merge_sharded(best_id, best_d, new_id, new_d, k2: int):
    """Deduped running top-k2 of (n, k2) best and (n, k1) new candidates.

    Ids sorted stably, all but the first of an equal run and every id < 0
    set to 2**30, then the k2 smallest distances, ties lower column first.
    """
    ids = torch.cat([best_id, new_id], dim=1)
    ds = torch.cat([best_d, new_d], dim=1)
    ids_s, sort_idx = torch.sort(ids, dim=1, stable=True)
    ds_s = ds.gather(1, sort_idx)
    dup = torch.zeros_like(ids_s, dtype=torch.bool)
    dup[:, 1:] = ids_s[:, 1:] == ids_s[:, :-1]
    ds_s = torch.where(dup | (ids_s < 0), _INF, ds_s)
    top_d, idx = _topk_smallest(ds_s, k2)
    return ids_s.gather(1, idx), top_d


def _final_adc(points, best_id, quant: quantize.Quantizer, codes, k: int,
               row_start: int = 0):
    """4-bit ADC distances of each row to its k2 survivors; the k smallest.

    ``codes`` is the (n, d) uint8 code table; ids < 0 and the row itself
    (row ``row_start + i`` for ``points[i]``) are +inf.
    """
    cand_codes = codes[best_id.clamp_min(0).long()]  # (C, k2, d)
    d2 = quantize.adc_distance(quant, points, cand_codes)
    rows = torch.arange(row_start, row_start + points.shape[0], dtype=torch.int32,
                        device=points.device)
    d2 = torch.where((best_id < 0) | (best_id == rows[:, None]), torch.inf, d2)
    dist, idx = _topk_smallest(d2, k)
    return best_id.gather(1, idx), dist


def graph_order(
    group: ShardGroup,
    points: torch.Tensor,
    sketches: torch.Tensor,
    cfg: ForestConfig,
    lo: torch.Tensor,
    hi: torch.Tensor,
    perm: torch.Tensor,
    flip: torch.Tensor,
    best_id: torch.Tensor,
    best_d: torch.Tensor,
    k1: int,
    stage: Optional[Callable[[str], None]] = None,
) -> int:
    """One Hilbert order of :func:`distributed_knn_graph`, over the shards.

    The order's keys, the sample sort, the halo windows, the routing home
    and the running merge into ``best_id``/``best_d`` (n, k2), which are
    updated in place.  ``stage``, if given, is called with each stage's
    name as it ends.  Returns the order's overflow over the shards.
    """
    mark = stage or (lambda name: None)
    n, k2 = best_id.shape
    keys = hilbert.hilbert_keys(points, bits=cfg.bits, key_bits=cfg.key_bits,
                                lo=lo, hi=hi, perm=perm, flip=flip)
    mark("keys")
    _, pay_o, n_valid, ovf1 = _sort_rows(group, keys, {"sk": sketches})
    del keys
    mark("sample_sort")
    cand_g, cand_d = halo_window_candidates(group, pay_o["gid"], pay_o["sk"], n_valid, k1)
    mark("halo")
    home_c, home_d, ovf2 = route_home(group, pay_o["gid"], cand_g, cand_d, n)
    del pay_o, cand_g, cand_d
    mark("route_home")
    home_c, home_d = home_c.reshape(n, -1), home_d.reshape(n, -1)
    for s in range(0, n, _ROW_CHUNK):
        best_id[s : s + _ROW_CHUNK], best_d[s : s + _ROW_CHUNK] = _merge_sharded(
            best_id[s : s + _ROW_CHUNK], best_d[s : s + _ROW_CHUNK],
            home_c[s : s + _ROW_CHUNK], home_d[s : s + _ROW_CHUNK], k2)
    mark("merge")
    return int(ovf1.sum()) + int(ovf2.sum())


def final_ranking(points, best_id, quant: quantize.Quantizer, codes, k: int):
    """Each row's k nearest of its (n, k2) survivors by 4-bit ADC distance,
    self excluded: ``(ids (n, k) int32, d2 (n, k) float32)``, ranked in
    passes of a bounded number of rows."""
    n = points.shape[0]
    ids = torch.empty((n, k), dtype=torch.int32, device=points.device)
    dists = torch.empty((n, k), dtype=torch.float32, device=points.device)
    for s in range(0, n, _ROW_CHUNK):
        ids[s : s + _ROW_CHUNK], dists[s : s + _ROW_CHUNK] = _final_adc(
            points[s : s + _ROW_CHUNK], best_id[s : s + _ROW_CHUNK], quant, codes, k,
            row_start=s)
    return ids, dists


def distributed_knn_graph(
    points,
    params: GraphParams,
    forest_cfg: ForestConfig,
    n_shards: int,
    *,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Task 2 over ``n_shards`` logical shards.

    Returns ``(ids (n, k) int32, d2 (n, k) float32, total_overflow)``:
    each row's k nearest by 4-bit ADC distance to its k2 sketch-filtered
    survivors, self excluded.  ``n`` must be a multiple of ``n_shards``.
    Per order (:func:`graph_order`) the sample sort, the halo windows and
    the routing home run over the shards; the quantizer, codes and bounds
    are global.  ``device`` is ``None`` (the GPU; raises without one) or
    any torch device.
    """
    from repro_torch.index.facade import resolve_device

    dev = resolve_device(device)
    points = torch.as_tensor(points, dtype=torch.float32, device=dev)
    n, d = points.shape
    if n % n_shards:
        raise ValueError(f"{n} rows do not split into {n_shards} equal shards")
    group = ShardGroup(n_shards, dev)
    quant = quantize.fit(points, bits=4)
    codes = quantize.encode(quant, points)
    sks = sketch.sketches_from_codes(codes, bits=4)
    lo = points.amin(0)
    hi = points.amax(0)

    rng = np.random.default_rng(params.seed)
    best_id = torch.full((n, params.k2), -1, dtype=torch.int32, device=dev)
    best_d = torch.full((n, params.k2), _INF, dtype=torch.int32, device=dev)
    total_overflow = 0
    for _ in range(params.n_orders):
        perm = torch.as_tensor(rng.permutation(d).astype(np.int32), device=dev)
        flip = torch.as_tensor(rng.integers(0, 2, d).astype(bool), device=dev)
        total_overflow += graph_order(group, points, sks, forest_cfg, lo, hi, perm, flip,
                                      best_id, best_d, params.k1)
    ids, dists = final_ranking(points, best_id, quant, codes, params.k)
    return ids, dists, total_overflow


# ---------------------------------------------------------------------------
# Cross-shard top-k merge (the sharded facades' reduction tail)
# ---------------------------------------------------------------------------


def is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def resolve_merge(merge: str, n_shards: int) -> str:
    """Resolve a ``merge`` knob ("auto" | "gather" | "tree") to a concrete path.

    ``"auto"`` picks the butterfly tree when the shard count is a power of
    two (its XOR-partner schedule needs one) and the flat gather otherwise;
    an explicit ``"tree"`` on another count raises.
    """
    if merge not in ("auto", "gather", "tree"):
        raise ValueError(f"merge={merge!r}: expected 'auto', 'gather' or 'tree'")
    if merge == "auto":
        return "tree" if is_pow2(n_shards) else "gather"
    if merge == "tree" and not is_pow2(n_shards):
        raise ValueError(
            f"merge='tree' needs a power-of-two shard count, got {n_shards}; "
            "use merge='auto' to fall back to 'gather'"
        )
    return merge


def merge_topk_rows(ids: torch.Tensor, d2: torch.Tensor, k: int):
    """:func:`search.merge_topk` over every row of (S, Q, C) stacks."""
    s, qn, c = ids.shape
    out_i, out_d = search_lib.merge_topk(ids.reshape(s * qn, c),
                                         d2.reshape(s * qn, c), k=k)
    return out_i.reshape(s, qn, k), out_d.reshape(s, qn, k)


def tree_merge_topk(group: ShardGroup, ids: torch.Tensor, d2: torch.Tensor, *,
                    k: int, prune: bool = False):
    """Butterfly all-reduce of :func:`search.merge_topk`.

    ``ids``/``d2`` (S, Q, C) are each rank's local candidates (global ids,
    -1 padding, +inf masked distances).  Each rank deflates its pool to a
    true local top-k, then makes log2(S) hops on the XOR-partner schedule:
    at step ``s`` rank ``r`` takes rank ``r ^ s``'s (Q, k) partial and
    merges, the lower rank's block first, so both ranks of a pair merge the
    same columns and every rank ends with the same (Q, k).  Returns the
    (S, Q, k) per-rank results.

    ``prune`` first takes the ``pmin`` over ranks of each rank's k-th best
    distance λ and masks local candidates worse than it: some rank holds k
    distinct ids at or below λ, so nothing masked could enter the top-k,
    and results stay bit-equal, ids included.  S must be a power of two.
    """
    s = group.size
    qn = ids.shape[1]
    ids_k, d_k = merge_topk_rows(ids, d2, k)  # shard-local deflation
    if s == 1:
        return ids_k, d_k
    rank = group.axis_index()
    if prune:
        lam = group.pmin(d_k[:, :, -1])
        keep = d_k <= lam[:, :, None]
        ids_k = torch.where(keep, ids_k, -1)
        d_k = torch.where(keep, d_k, torch.inf)
    step = 1
    while step < s:
        perm = [(r, r ^ step) for r in range(s)]
        other_ids = group.ppermute(ids_k, perm)
        other_d = group.ppermute(d_k, perm)
        first = ((rank & step) == 0)[:, None].expand(s, qn).reshape(s * qn, 1)
        ids_k, d_k = search_lib.merge_topk_pair(
            ids_k.reshape(s * qn, k), d_k.reshape(s * qn, k),
            other_ids.reshape(s * qn, k), other_d.reshape(s * qn, k), first, k=k)
        ids_k, d_k = ids_k.reshape(s, qn, k), d_k.reshape(s, qn, k)
        step *= 2
    return ids_k, d_k


def gather_merge_topk(group: ShardGroup, ids: torch.Tensor, d2: torch.Tensor, *,
                      k: int):
    """Flat reduction: all-gather every rank's (Q, C) pool, merge once.

    The parity reference of the tree and the path of non-power-of-two
    shard counts.  Returns the (S, Q, k) per-rank results (all equal).
    """
    s, qn, c = ids.shape
    pool_i = group.all_gather(ids).transpose(0, 1).reshape(qn, s * c)
    pool_d = group.all_gather(d2).transpose(0, 1).reshape(qn, s * c)
    out_i, out_d = search_lib.merge_topk(pool_i, pool_d, k=k)
    return out_i.expand(s, qn, k), out_d.expand(s, qn, k)


def cross_shard_merge_topk(group: ShardGroup, ids: torch.Tensor, d2: torch.Tensor,
                           *, k: int, merge: str, prune: bool = False):
    """The one cross-shard merge tail of the sharded facades.

    ``merge`` must already be ``"gather"`` or ``"tree"``
    (:func:`resolve_merge`); both return the same sorted distances bit for
    bit and the same ids up to distance ties (with ``prune``, ids are
    bit-equal to the unpruned tree).
    """
    if merge == "gather":
        return gather_merge_topk(group, ids, d2, k=k)
    if merge == "tree":
        return tree_merge_topk(group, ids, d2, k=k, prune=prune)
    raise ValueError(f"unresolved merge strategy {merge!r}")
