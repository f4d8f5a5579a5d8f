"""Truncated Hilbert keys and their lexicographic sort (port of ``repro.core.hilbert``).

Per point, the top ``key_bits`` bits of the Hilbert index via Skilling's
transform ("Programming the Hilbert curve", AIP Conf. Proc. 707, 2004), in
the JAX package's scan-free form: each level pass is a cummax + cumsum +
gather over the dims, fully data-parallel over points.

Key layout: a key is ``W = ceil(key_bits/32)`` 32-bit words, word 0 most
significant, bit 31 of word 0 the most significant bit.  Words are int32
tensors holding the JAX package's uint32 bits; every compare and sort
first flips the sign bit (``^ INT32_MIN``), which maps unsigned order onto
signed order exactly.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core.quantize import ROW_CHUNK
from repro_torch.kernels import bitpack

__all__ = [
    "axes_to_transpose",
    "transpose_to_axes",
    "quantize_points",
    "hilbert_keys",
    "hilbert_sort",
    "lex_less",
    "lex_searchsorted",
    "key_words",
]

INT32_MIN = -(2**31)


def key_words(key_bits: int) -> int:
    """Number of 32-bit words used to store a ``key_bits``-bit key."""
    return -(-key_bits // 32)


# ---------------------------------------------------------------------------
# Skilling transform (coordinates carried in int32: bits <= 31)
# ---------------------------------------------------------------------------


def _level_pass(x: torch.Tensor, level: int, reverse: bool) -> torch.Tensor:
    """One level of Skilling's "inverse undo", without a sequential scan.

    Each step of Skilling's per-level loop either inverts the carry register
    (``X[i] & Q``) or swaps its low bits with column i, so the value a
    column receives is the low bits of the previous swap column (or the
    initial register), inverted when the count of intervening inverts is
    odd: a cummax (previous swap index) + cumsum (invert parity) + gather.
    ``reverse=True`` runs the involution backwards (the inverse pass of
    :func:`transpose_to_axes`).
    """
    n, d = x.shape
    q = 1 << level
    p = q - 1
    np_ = ~p  # int32 mask of the bits above the level

    x0 = x[:, 0]
    cond0 = (x0 & q) != 0
    if d == 1:
        return torch.where(cond0, x0 ^ p, x0)[:, None]

    body = x[:, 1:]
    if reverse:
        body = body.flip(1)

    cond = (body & q) != 0  # invert ops (n, d-1)
    swap = ~cond  # swap ops
    inv = cond.to(torch.int32)
    s_excl = torch.cumsum(inv, dim=1, dtype=torch.int32) - inv  # inverts before t
    total = inv.sum(1, dtype=torch.int32)
    if not reverse:
        # forward: the i==0 self-invert happens before everything
        c0 = cond0.to(torch.int32)
        s_excl = s_excl + c0[:, None]
        total = total + c0

    tpos = torch.arange(d - 1, dtype=torch.int32, device=x.device).expand(n, d - 1)
    swap_pos = torch.where(swap, tpos, -1)
    run_max = torch.cummax(swap_pos, dim=1).values
    prev = torch.cat(
        [torch.full((n, 1), -1, dtype=torch.int32, device=x.device), run_max[:, :-1]],
        dim=1,
    )  # previous swap strictly before t
    prev_idx = prev.clamp_min(0).long()
    no_prev = prev < 0

    src_low = torch.where(no_prev, x0[:, None], body.gather(1, prev_idx)) & p
    s_j = torch.where(no_prev, 0, s_excl.gather(1, prev_idx))
    parity = ((s_excl - s_j) & 1) == 1
    new_low = torch.where(parity, src_low ^ p, src_low)
    body_new = torch.where(swap, (body & np_) | new_low, body)

    # final register -> column 0
    last_swap = run_max[:, -1]
    last_idx = last_swap.clamp_min(0).long()[:, None]
    no_last = last_swap < 0
    v_src = torch.where(no_last, x0, body.gather(1, last_idx)[:, 0]) & p
    s_last = torch.where(no_last, 0, s_excl.gather(1, last_idx)[:, 0])
    par_end = total - s_last
    if reverse:
        # reverse: the i==0 self-invert happens after everything
        par_end = par_end + cond0.to(torch.int32)
    v_end = torch.where((par_end & 1) == 1, v_src ^ p, v_src)
    x0_new = (x0 & np_) | v_end

    if reverse:
        body_new = body_new.flip(1)
    return torch.cat([x0_new[:, None], body_new], dim=1)


def _prefix_xor(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix-XOR over axis 1 via Hillis-Steele doubling."""
    d = x.shape[1]
    s = 1
    while s < d:
        x = x.clone()
        x[:, s:] = x[:, s:] ^ x[:, :-s]
        s <<= 1
    return x


def _check_bits(bits: int) -> None:
    if not 1 <= bits <= 31:
        raise ValueError(f"bits={bits}: coordinates are carried in int32 (1..31)")


def axes_to_transpose(coords: torch.Tensor, bits: int) -> torch.Tensor:
    """Skilling's AxesToTranspose, vectorized over points.

    Args:
      coords: (n, d) integer grid coordinates, each in [0, 2**bits).
      bits: number of bits per coordinate (b).

    Returns:
      (n, d) int32 "transpose" representation: bit ``l`` of output column
      ``i`` is Hilbert-index bit at stream position ``(bits-1-l)*d + i``.
    """
    _check_bits(bits)
    x = coords.to(torch.int32)
    n = x.shape[0]
    for level in range(bits - 1, 0, -1):
        x = _level_pass(x, level, reverse=False)
    # Gray encode: X[i] ^= X[i-1] (already-updated) == prefix-XOR.
    x = _prefix_xor(x)
    t = torch.zeros((n,), dtype=torch.int32, device=x.device)
    last = x[:, -1]
    for level in range(bits - 1, 0, -1):
        q = 1 << level
        t = torch.where((last & q) != 0, t ^ (q - 1), t)
    return x ^ t[:, None]


def transpose_to_axes(transpose: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`axes_to_transpose` (used by tests/oracles)."""
    _check_bits(bits)
    x = transpose.to(torch.int32)
    n = x.shape[0]
    # Gray decode: t's contribution to bit `level` comes only from the
    # already-reconstructed higher levels, so probe (z ^ t_sofar).
    t = torch.zeros((n,), dtype=torch.int32, device=x.device)
    last = x[:, -1]
    for level in range(bits - 1, 0, -1):
        q = 1 << level
        t = torch.where(((last ^ t) & q) != 0, t ^ (q - 1), t)
    x = x ^ t[:, None]
    # prefix-xor y[i] = x[0]^..^x[i]  =>  x[i] = y[i] ^ y[i-1].
    x = torch.cat([x[:, :1], x[:, 1:] ^ x[:, :-1]], dim=1)
    for level in range(1, bits):
        x = _level_pass(x, level, reverse=True)
    return x


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------


def quantize_points(points: torch.Tensor, bits: int, lo: torch.Tensor,
                    hi: torch.Tensor) -> torch.Tensor:
    """Uniformly quantize fp points (n, d) into [0, 2**bits) int32 grid coords.

    The same float32 steps as the JAX package — ``(p - lo) / max(hi - lo,
    1e-12)``, round half to even, clip — so the coordinates are bit-equal.
    """
    span = torch.maximum(hi - lo, torch.tensor(1e-12, dtype=hi.dtype, device=hi.device))
    levels = (1 << bits) - 1
    t = (points - lo) / span
    g = torch.clamp(torch.round(t * levels), 0, levels)
    return g.to(torch.int32)


def _hilbert_keys_rows(points, bits, key_bits, lo, hi, perm, flip):
    n, d = points.shape
    coords = quantize_points(points, bits, lo, hi)
    if flip is not None:
        coords = torch.where(flip[None, :], ((1 << bits) - 1) - coords, coords)
    if perm is not None:
        coords = coords[:, perm.long()]
    tr = axes_to_transpose(coords, bits)
    if bits <= 8:
        tr = tr.to(torch.uint8)  # every level's bit column in one byte
    # Interleave MSB-level-first (level b-1 of all dims, then b-2, ...) into
    # an (n, key_bits) byte matrix, one byte per bit, and pack it.
    bit_mat = torch.empty((n, key_bits), dtype=torch.uint8, device=points.device)
    for j in range(-(-key_bits // d)):
        c0 = j * d
        cols = min(d, key_bits - c0)
        bit_mat[:, c0 : c0 + cols] = (tr[:, :cols] >> (bits - 1 - j)) & 1
    return bitpack.pack_bits(bit_mat)


def hilbert_keys(
    points: torch.Tensor,
    *,
    bits: int,
    key_bits: int,
    lo: torch.Tensor,
    hi: torch.Tensor,
    perm: Optional[torch.Tensor] = None,
    flip: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Truncated Hilbert keys for fp points, built in row chunks.

    Args:
      points: (n, d) float32.
      bits: grid bits per axis (curve depth).
      key_bits: number of leading Hilbert-index bits to keep.
      lo/hi: (d,) quantization bounds.
      perm: optional (d,) axis permutation (the forest's randomization).
      flip: optional (d,) bool, per-axis reflection.

    Returns:
      (n, W) int32 packed keys, word 0 most significant.
    """
    n, d = points.shape
    if key_bits > d * bits:
        raise ValueError(f"key_bits={key_bits} exceeds d*bits={d * bits}")
    _check_bits(bits)
    out = torch.empty((n, key_words(key_bits)), dtype=torch.int32, device=points.device)
    for s in range(0, n, ROW_CHUNK):
        out[s : s + ROW_CHUNK] = _hilbert_keys_rows(
            points[s : s + ROW_CHUNK], bits, key_bits, lo, hi, perm, flip
        )
    return out


def _lexsort_words(keys: torch.Tensor) -> torch.Tensor:
    """Stable argsort (int64) of (n, W) packed keys, word 0 primary.

    Least-significant word first, one stable sort per word carrying the
    permutation, so equal keys keep index order as ``jnp.lexsort`` does.
    """
    n, w = keys.shape
    perm = torch.arange(n, device=keys.device)
    for i in range(w - 1, -1, -1):
        col = keys[perm, i] ^ INT32_MIN
        perm = perm[torch.sort(col, stable=True).indices]
    return perm


def hilbert_sort(
    points: torch.Tensor,
    *,
    bits: int,
    key_bits: int,
    lo: torch.Tensor,
    hi: torch.Tensor,
    perm: Optional[torch.Tensor] = None,
    flip: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hilbert-sort ``points``; returns (order int32, sorted_keys)."""
    keys = hilbert_keys(
        points, bits=bits, key_bits=key_bits, lo=lo, hi=hi, perm=perm, flip=flip
    )
    order = _lexsort_words(keys)
    return order.to(torch.int32), keys[order]


# ---------------------------------------------------------------------------
# Lexicographic search over packed keys
# ---------------------------------------------------------------------------


def lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lexicographic unsigned ``a < b`` over the trailing word axis (word 0 primary)."""
    w = a.shape[-1]
    out = torch.zeros(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]),
                      dtype=torch.bool, device=a.device)
    for i in range(w - 1, -1, -1):
        ai, bi = a[..., i] ^ INT32_MIN, b[..., i] ^ INT32_MIN
        out = (ai < bi) | ((ai == bi) & out)
    return out


def lex_searchsorted(sorted_keys: torch.Tensor, query_keys: torch.Tensor
                     ) -> torch.Tensor:
    """Vectorized left-insertion binary search on packed multi-word keys.

    Returns (q,) int64 positions ``searchsorted(..., side='left')``.  Runs
    the JAX package's fixed ``ceil(log2(m+1))`` steps and, like its
    gather, clamps the probe index to ``m - 1``: a query above every key
    then ends at ``m + 1``, as in the JAX result.
    """
    m = sorted_keys.shape[0]
    q = query_keys.shape[0]
    steps = max(1, int(math.ceil(math.log2(m + 1))))
    lo = torch.zeros((q,), dtype=torch.int64, device=query_keys.device)
    hi = torch.full((q,), m, dtype=torch.int64, device=query_keys.device)
    for _ in range(steps):
        mid = (lo + hi) // 2
        go_right = lex_less(sorted_keys[mid.clamp_max(m - 1)], query_keys)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lo
