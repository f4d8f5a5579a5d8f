"""Plain reference of the Hilbert forest: index build, Algorithm-1 search, Algorithm-2 graph.

Written from the semantics of the configuration, in plain PyTorch, and
independent of the program under test: it imports nothing of the program
and takes nothing the program made.  The benchmark hands it the same points
and queries it handed the program, and it works the index out again.

What it computes, and how it differs in method from the program:

* Quantizer: per-dimension quantiles k/16 (boundaries) and (k+1/2)/16
  (centroids) of a fixed sample of rows (``numpy.random.default_rng(0)
  .choice(n, sample_limit)``), by linear interpolation; the interpolation
  is rounded as ``jnp.quantile`` under XLA's fused multiply-add rounds it,
  the arithmetic the configuration pins.  Codes count the boundaries at or
  below each value.  A sketch bit is the code's top bit.
* Hilbert keys: points on a uniform grid of ``2**bits`` cells between the
  per-dimension minimum and maximum, reflected and permuted per tree, then
  Skilling's AxesToTranspose, run literally (one dimension after another,
  vectorised over points and over a group of trees).  Passes that can only
  change bit planes below the last plane a key keeps are skipped.
* Stage 1: a query's rank among a tree's points comes from one stable sort
  of the query keys ahead of the point keys, not from a directory search;
  the window is centred on the middle of the query's leaf.  The survivors
  are the ``k2`` smallest (Hamming, position) pairs of the union of every
  tree's candidates, taken in one sort, not by a running merge.
* Stage 2 and the graph's re-rank: distances summed in float32 by
  ``torch.sum``; top-k by (distance, position) or by (distance, survivor
  order).  ``low`` rounds the distance inputs to bfloat16: the control.

Words of packed bits are int32 tensors holding unsigned 32-bit patterns,
word 0 most significant, bit 31 first.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

INF_HAMMING = 1 << 30
_GROUP_BYTES = 3 << 30  # grid coordinates of a group of trees, uint8


# ---------------------------------------------------------------------------
# Bits and words
# ---------------------------------------------------------------------------


def _popcount_table(device) -> torch.Tensor:
    """Set bits of every 16-bit value."""
    v = np.arange(1 << 16, dtype=np.uint32)
    counts = np.zeros(1 << 16, dtype=np.int32)
    for b in range(16):
        counts += ((v >> b) & 1).astype(np.int32)
    return torch.as_tensor(counts, device=device)


def hamming(a: torch.Tensor, b: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Hamming distance of int32 word rows (broadcast): popcounts of the
    XOR's two 16-bit halves, looked up and summed."""
    x = (a ^ b).long() & 0xFFFFFFFF
    return (table[x & 0xFFFF] + table[x >> 16]).sum(-1).to(torch.int32)


def to_word(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 holding the same 32 bits."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def pack_rows(bits: torch.Tensor) -> torch.Tensor:
    """(m, K) {0, 1} -> (m, ceil(K/32)) int32 words, column 0 into bit 31 of word 0."""
    m, k = bits.shape
    w = -(-k // 32)
    b = torch.zeros((m, w * 32), dtype=torch.int64, device=bits.device)
    b[:, :k] = bits.long()
    weights = torch.tensor([1 << (31 - j) for j in range(32)], dtype=torch.int64,
                           device=bits.device)
    return to_word((b.view(m, w, 32) * weights).sum(-1))


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """(m, d) 4-bit codes -> (m, ceil(d/8)) int32: dim 8w + s in bits 4s..4s+3 of word w."""
    m, d = codes.shape
    w = -(-d // 8)
    c = torch.zeros((m, w * 8), dtype=torch.int64, device=codes.device)
    c[:, :d] = codes.long()
    weights = torch.tensor([1 << (4 * s) for s in range(8)], dtype=torch.int64,
                           device=codes.device)
    return to_word((c.view(m, w, 8) * weights).sum(-1))


# ---------------------------------------------------------------------------
# Quantizer and sketches
# ---------------------------------------------------------------------------


def fit_quantizer(points: torch.Tensor, bits: int, sample_limit: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(boundaries (d, L-1), centroids (d, L)) float32, L = 2**bits."""
    n = points.shape[0]
    data = points
    if n > sample_limit:
        rows = np.random.default_rng(0).choice(n, sample_limit, replace=False)
        data = points[torch.as_tensor(rows, device=points.device)]
    srt = torch.sort(data, dim=0).values
    m = srt.shape[0]
    levels = 1 << bits

    def at(fracs: np.ndarray) -> torch.Tensor:
        pos = fracs.astype(np.float32) * np.float32(m - 1)
        lo = np.floor(pos)
        hi = np.ceil(pos)
        w_hi = (pos - lo).astype(np.float32)
        w_lo = (np.float32(1.0) - w_hi).astype(np.float32)
        dev = points.device
        a_lo = srt[torch.as_tensor(lo.astype(np.int64), device=dev)]
        a_hi = srt[torch.as_tensor(hi.astype(np.int64), device=dev)]
        hi_part = a_hi * torch.as_tensor(w_hi, device=dev)[:, None]  # rounded to f32
        val = (a_lo.double() * torch.as_tensor(w_lo, device=dev).double()[:, None]
               + hi_part.double())
        return val.float().T.contiguous()

    f_b = np.arange(1, levels, dtype=np.float32) / np.float32(levels)
    f_c = (np.arange(levels, dtype=np.float32) + np.float32(0.5)) / np.float32(levels)
    return at(f_b), at(f_c)


def encode(points: torch.Tensor, boundaries: torch.Tensor, rows: int = 1 << 17
           ) -> torch.Tensor:
    """(n, d) codes, uint8: how many boundaries lie at or below each value."""
    out = torch.empty(points.shape, dtype=torch.uint8, device=points.device)
    for s in range(0, points.shape[0], rows):
        x = points[s : s + rows]
        out[s : s + rows] = (x[:, :, None] >= boundaries[None, :, :]).sum(-1)
    return out


def sketch_words(codes: torch.Tensor, bits: int) -> torch.Tensor:
    return pack_rows(codes >= (1 << (bits - 1)))


# ---------------------------------------------------------------------------
# Hilbert keys
# ---------------------------------------------------------------------------


def grid(points: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor, bits: int
         ) -> torch.Tensor:
    """(n, d) uint8 grid cells: round((p - lo) / max(hi - lo, 1e-12) * (2**bits - 1))."""
    levels = (1 << bits) - 1
    span = torch.clamp(hi - lo, min=1e-12)
    cell = torch.round((points - lo) / span * levels)
    return torch.clamp(cell, 0, levels).to(torch.uint8)


def transpose_planes(x: torch.Tensor, bits: int, low_plane: int) -> torch.Tensor:
    """Skilling's AxesToTranspose on (d, m) uint8 coordinates, in place.

    Only bit planes ``>= low_plane`` of the result are exact: an undo pass
    at level Q changes planes below log2(Q) only, so passes with
    ``Q <= 2**low_plane`` are skipped.
    """
    d = x.shape[0]
    top = 1 << (bits - 1)
    q = top
    while q > 1 and q > (1 << low_plane):
        p = q - 1
        x0 = x[0].clone()
        for i in range(d):
            xi = x0 if i == 0 else x[i]
            inv = (xi & q) != 0
            if i == 0:
                x0 = torch.where(inv, x0 ^ p, x0)
                continue
            t = ((x0 ^ xi) & p).masked_fill_(inv, 0)
            x[i] ^= t
            x0 = torch.where(inv, x0 ^ p, x0 ^ t)
        x[0] = x0
        q >>= 1
    for i in range(1, d):  # Gray encode
        x[i] ^= x[i - 1]
    t = torch.zeros_like(x[0])
    q = top
    while q > 1:
        t = torch.where((x[d - 1] & q) != 0, t ^ (q - 1), t)
        q >>= 1
    x ^= t
    return x


def key_words_from_planes(x: torch.Tensor, bits: int, key_bits: int) -> torch.Tensor:
    """(d, m) transposed coordinates -> (ceil(key_bits/32), m) int32 words.

    Key bit k is bit plane ``bits - 1 - k // d`` of dimension ``k % d``."""
    d, m = x.shape
    n_words = -(-key_bits // 32)
    out = torch.zeros((n_words, m), dtype=torch.int32, device=x.device)
    for k in range(key_bits):
        plane = bits - 1 - k // d
        bit = ((x[k % d] >> plane) & 1).to(torch.int32)
        out[k // 32] |= bit << (31 - k % 32)
    return out


def tree_keys(cells_t: torch.Tensor, perms: Sequence[np.ndarray],
              flips: Sequence[np.ndarray], bits: int, key_bits: int) -> torch.Tensor:
    """Keys of every column of ``cells_t`` (d, m) under each (perm, flip):
    (G, n_words, m) int32, a group of trees transformed together."""
    d, m = cells_t.shape
    g = len(perms)
    levels = (1 << bits) - 1
    x = torch.empty((d, g * m), dtype=torch.uint8, device=cells_t.device)
    for j, (perm, flip) in enumerate(zip(perms, flips)):
        perm_t = torch.as_tensor(np.asarray(perm, dtype=np.int64), device=cells_t.device)
        flip_t = torch.as_tensor(np.asarray(flip, dtype=bool), device=cells_t.device)
        cols = cells_t[perm_t]
        x[:, j * m : (j + 1) * m] = torch.where(flip_t[perm_t][:, None], levels - cols, cols)
    low_plane = bits - -(-key_bits // d)
    transpose_planes(x, bits, max(low_plane, 0))
    words = key_words_from_planes(x, bits, key_bits)
    return words.view(words.shape[0], g, m).transpose(0, 1)


def lexsort_rows(keys: torch.Tensor) -> torch.Tensor:
    """(G, W, m) int32 words -> (G, m) int64 stable ascending order, word 0
    primary, words compared unsigned."""
    g, w, m = keys.shape
    order = torch.arange(m, device=keys.device).expand(g, m).contiguous()
    for i in range(w - 1, -1, -1):
        col = torch.gather(keys[:, i, :].long() & 0xFFFFFFFF, 1, order)
        order = torch.gather(order, 1, torch.sort(col, dim=1, stable=True).indices)
    return order


def _group_size(d: int, m: int, total: int) -> int:
    return max(1, min(total, _GROUP_BYTES // max(1, d * m)))


def randomization(n_trees: int, d: int, seed: int):
    """The forest's per-tree permutations and reflections, in the configuration's draw order."""
    rng = np.random.default_rng(seed)
    perms = [rng.permutation(d) for _ in range(n_trees)]
    flips = rng.integers(0, 2, size=(n_trees, d)).astype(bool)
    return perms, list(flips)


def graph_randomization(n_orders: int, d: int, seed: int):
    """Algorithm 2's per-order permutation and reflection, drawn in turn."""
    rng = np.random.default_rng(seed)
    perms, flips = [], []
    for _ in range(n_orders):
        perms.append(rng.permutation(d))
        flips.append(rng.integers(0, 2, d).astype(bool))
    return perms, flips


# ---------------------------------------------------------------------------
# Index build
# ---------------------------------------------------------------------------


def build_base(points: torch.Tensor, cfg: Dict) -> SimpleNamespace:
    """Quantizer, codes, sketches, bounds and the master order."""
    bits, kb = cfg["bits"], cfg["key_bits"]
    boundaries, centroids = fit_quantizer(points, cfg["quant_bits"], cfg["sample_limit"])
    codes = encode(points, boundaries)
    sketches = sketch_words(codes, cfg["quant_bits"])
    lo, hi = points.amin(0), points.amax(0)
    cells_t = grid(points, lo, hi, bits).T.contiguous()
    d, n = cells_t.shape
    master_keys = tree_keys(cells_t, [np.arange(d)], [np.zeros(d, bool)], bits, kb)
    master_order = lexsort_rows(master_keys)[0]
    master_rank = torch.empty_like(master_order)
    master_rank[master_order] = torch.arange(n, device=points.device)
    return SimpleNamespace(
        boundaries=boundaries, centroids=centroids, codes=codes, sketches=sketches,
        lo=lo, hi=hi, cells_t=cells_t, master_order=master_order,
        master_rank=master_rank,
        codes_master=pack_nibbles(codes[master_order]),
        sketches_master=sketches[master_order])


def build_forest(base: SimpleNamespace, cfg: Dict, extra_cells_t: Optional[torch.Tensor]
                 = None, on_tree=None) -> None:
    """Sort every tree; call ``on_tree(t, order, keys_sorted, query_rank)``.

    ``extra_cells_t`` (d, S) are query cells sorted ahead of the points:
    ``query_rank`` (S,) counts the points whose key is strictly below each
    query's.  ``keys_sorted`` is (W, n) int32.
    """
    bits, kb = cfg["bits"], cfg["key_bits"]
    perms, flips = randomization(cfg["n_trees"], base.cells_t.shape[0], cfg["forest_seed"])
    cells = base.cells_t
    s = 0
    if extra_cells_t is not None:
        s = extra_cells_t.shape[1]
        cells = torch.cat([extra_cells_t, base.cells_t], dim=1)
    d, m = cells.shape
    g = _group_size(d, m, len(perms))
    for t0 in range(0, len(perms), g):
        keys = tree_keys(cells, perms[t0 : t0 + g], flips[t0 : t0 + g], bits, kb)
        orders = lexsort_rows(keys)
        for j in range(orders.shape[0]):
            full = orders[j]
            is_q = full < s
            order = full[~is_q] - s
            q_rank = None
            if s:
                where_q = torch.nonzero(is_q).squeeze(1)
                q_before = torch.cumsum(is_q.long(), 0)[where_q] - 1
                q_rank = torch.empty(s, dtype=torch.int64, device=cells.device)
                q_rank[full[where_q]] = where_q - q_before
            on_tree(t0 + j, order, keys[j][:, s:][:, order], q_rank)


def build_index(points: torch.Tensor, cfg: Dict) -> SimpleNamespace:
    """The whole index, in the program's layout, for the build comparison."""
    base = build_base(points, cfg)
    orders, dirs = [], []

    def keep(t, order, keys_sorted, _):
        orders.append(order.to(torch.int32))
        dirs.append(keys_sorted[:, :: cfg["leaf_size"]].T.contiguous())

    build_forest(base, cfg, on_tree=keep)
    perms, flips = randomization(cfg["n_trees"], points.shape[1], cfg["forest_seed"])
    dev = points.device
    return SimpleNamespace(
        boundaries=base.boundaries, centroids=base.centroids,
        codes_master=base.codes_master, sketches_master=base.sketches_master,
        master_order=base.master_order.to(torch.int32),
        master_rank=base.master_rank.to(torch.int32),
        lo=base.lo, hi=base.hi,
        perms=torch.as_tensor(np.stack(perms).astype(np.int32), device=dev),
        flips=torch.as_tensor(np.stack(flips), device=dev),
        orders=torch.stack(orders), directories=torch.stack(dirs))


# ---------------------------------------------------------------------------
# Algorithm 1: search
# ---------------------------------------------------------------------------


def _first_distinct(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Per row, the k smallest distinct int64 keys ascending; -1 where fewer."""
    srt = torch.sort(keys, dim=1).values
    new = torch.ones_like(srt, dtype=torch.bool)
    new[:, 1:] = srt[:, 1:] != srt[:, :-1]
    rank = torch.cumsum(new.long(), 1) - 1
    out = torch.full((keys.shape[0], k), -1, dtype=torch.int64, device=keys.device)
    take = new & (rank < k)
    rows = torch.nonzero(take)
    out[rows[:, 0], rank[take]] = srt[take]
    return out


def search_survivors(points, queries, cfg: Dict, params: Dict,
                     base: Optional[SimpleNamespace] = None,
                     block: int = 256) -> Tuple[SimpleNamespace, torch.Tensor]:
    """Stage 1: (base, (S, k2) int64 master positions, -1 where fewer)."""
    if base is None:
        base = build_base(points, cfg)
    n, leaf, k1, k2 = points.shape[0], cfg["leaf_size"], params["k1"], params["k2"]
    qcells = grid(queries, base.lo, base.hi, cfg["bits"]).T.contiguous()
    qcodes = encode(queries, base.boundaries)
    qsk = sketch_words(qcodes, cfg["quant_bits"])
    table = _popcount_table(points.device)
    s_total = queries.shape[0]
    dev = points.device
    per_tree: List[torch.Tensor] = []
    offs = torch.arange(k1, device=dev)

    def tree(t, order, _keys, q_rank):
        j = torch.clamp((q_rank + leaf - 1) // leaf, max=-(-n // leaf))
        rank = torch.clamp(j * leaf - leaf // 2, 0, n - 1)
        start = torch.clamp(rank - k1 // 2, 0, max(n - k1, 0))
        pos = torch.clamp(start[:, None] + offs, 0, n - 1)
        mpos = base.master_rank[order[pos]]
        ham = hamming(qsk[:, None, :], base.sketches_master[mpos], table)
        per_tree.append((ham.long() << 32) | mpos)

    build_forest(base, cfg, extra_cells_t=qcells, on_tree=tree)
    out = torch.empty((s_total, k2), dtype=torch.int64, device=dev)
    for s in range(0, s_total, block):
        allk = torch.cat([p[s : s + block] for p in per_tree], dim=1)
        best = _first_distinct(allk, k2)
        out[s : s + block] = torch.where(best >= 0, best & 0xFFFFFFFF, -1)
    return base, out


def adc(queries: torch.Tensor, codes: torch.Tensor, centroids: torch.Tensor,
        low: bool = False) -> torch.Tensor:
    """(S, d) float32 vs (S, C, d) uint8 codes -> (S, C) squared distances."""
    if low:
        queries = queries.to(torch.bfloat16).float()
        centroids = centroids.to(torch.bfloat16).float()
    dims = torch.arange(codes.shape[-1], device=codes.device)
    recon = centroids[dims, codes.long()]
    return ((queries[:, None, :] - recon) ** 2).sum(-1)


def search_answers(queries, base: SimpleNamespace, survivors: torch.Tensor,
                   params: Dict, low: bool = False, block: int = 16
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 2 from the survivors: (ids (S, k) int64, d2 (S, k) float32)."""
    n = base.master_order.shape[0]
    h, k = params["h"], params["k"]
    w = min(2 * h + 1, n)
    codes_m = base.codes[base.master_order]
    ids_out, d_out = [], []
    for s in range(0, survivors.shape[0], block):
        surv = survivors[s : s + block]
        start = torch.clamp(surv - h, 0, n - w)
        pos = (start[:, :, None] + torch.arange(w, device=surv.device)).flatten(1)
        valid = (surv >= 0)[:, :, None].expand(-1, -1, w).flatten(1)
        d2 = adc(queries[s : s + block], codes_m[pos], base.centroids, low)
        d2 = torch.where(valid, d2, torch.inf)
        by_pos = torch.sort(pos, dim=1, stable=True).indices
        pos, d2 = pos.gather(1, by_pos), d2.gather(1, by_pos)
        dup = torch.zeros_like(pos, dtype=torch.bool)
        dup[:, 1:] = pos[:, 1:] == pos[:, :-1]
        d2 = torch.where(dup, torch.inf, d2)
        kk = min(k, d2.shape[1])
        top = torch.sort(d2, dim=1, stable=True).indices[:, :kk]
        dist = d2.gather(1, top)
        ids = torch.where(torch.isfinite(dist), base.master_order[pos.gather(1, top)], -1)
        if kk < k:
            ids = torch.nn.functional.pad(ids, (0, k - kk), value=-1)
            dist = torch.nn.functional.pad(dist, (0, k - kk), value=float("inf"))
        ids_out.append(ids)
        d_out.append(dist)
    return torch.cat(ids_out), torch.cat(d_out)


# ---------------------------------------------------------------------------
# Algorithm 2: k-NN graph
# ---------------------------------------------------------------------------


def graph_rows(points: torch.Tensor, rows: torch.Tensor, cfg: Dict, graph: Dict,
               low: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The graph's (ids, d2) of ``rows``: (S, k) each."""
    n, d = points.shape
    dev = points.device
    boundaries, _ = fit_quantizer(points, cfg["quant_bits"], cfg["sample_limit"])
    sk = sketch_words(encode(points, boundaries), cfg["quant_bits"])
    lo, hi = points.amin(0), points.amax(0)
    cells_t = grid(points, lo, hi, cfg["bits"]).T.contiguous()
    k1, k2, k = graph["k1"], graph["k2"], graph["k"]
    half = k1 // 2
    deltas = torch.tensor(list(range(-half, 0)) + list(range(1, k1 - half + 1)),
                          device=dev)
    table = _popcount_table(dev)
    perms, flips = graph_randomization(graph["n_orders"], d, graph["seed"])
    rows = rows.long()
    per_order = []
    g = _group_size(d, n, len(perms))
    for o0 in range(0, len(perms), g):
        keys = tree_keys(cells_t, perms[o0 : o0 + g], flips[o0 : o0 + g],
                         cfg["bits"], cfg["key_bits"])
        orders = lexsort_rows(keys)
        for order in orders:
            rank = torch.empty_like(order)
            rank[order] = torch.arange(n, device=dev)
            cand = order[torch.clamp(rank[rows][:, None] + deltas, 0, n - 1)]
            ham = hamming(sk[rows][:, None, :], sk[cand], table).long()
            ham = torch.where(cand == rows[:, None], INF_HAMMING, ham)
            per_order.append((ham << 32) | cand)
    best = _first_distinct(torch.cat(per_order, dim=1), k2)
    surv = torch.where(best >= 0, best & 0xFFFFFFFF, -1)
    src = points.to(torch.bfloat16).float() if low else points
    d2 = ((src[surv.clamp_min(0)] - src[rows][:, None, :]) ** 2).sum(-1)
    d2 = torch.where((surv < 0) | (surv == rows[:, None]), torch.inf, d2)
    top = torch.sort(d2, dim=1, stable=True).indices[:, :k]
    return surv.gather(1, top), d2.gather(1, top)
