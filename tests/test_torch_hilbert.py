"""Port parity: Hilbert keys, sort and lexicographic search against repro.

Keys, transposes, orders and search positions are integers and must be
bit-equal to the JAX package on the same numpy inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hilbert as jh
from repro_torch.core import hilbert as th
from repro_torch.data import ann_datasets as tdata


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint32)


def _both_keys(points, bits, key_bits, perm, flip):
    lo, hi = points.min(0), points.max(0)
    jk = jh.hilbert_keys(
        jnp.asarray(points), bits=bits, key_bits=key_bits, lo=jnp.asarray(lo),
        hi=jnp.asarray(hi),
        perm=None if perm is None else jnp.asarray(perm),
        flip=None if flip is None else jnp.asarray(flip))
    tk = th.hilbert_keys(
        torch.from_numpy(points), bits=bits, key_bits=key_bits,
        lo=torch.from_numpy(lo), hi=torch.from_numpy(hi),
        perm=None if perm is None else torch.from_numpy(perm),
        flip=None if flip is None else torch.from_numpy(flip))
    return jk, tk


# (2, 2, 4) is the shape behind test_hilbert_keys_jit_matches_eager.
@pytest.mark.parametrize("n,d,bits,key_bits,randomize", [
    (64, 2, 2, 4, False),
    (500, 5, 3, 15, True),
    (3000, 64, 4, 128, True),
    (3000, 384, 4, 448, True),
])
def test_hilbert_keys_and_sort_bit_equal(n, d, bits, key_bits, randomize):
    rng = np.random.default_rng(d)
    points = tdata.lowrank_embeddings(n, d, n_clusters=8, r=min(4, d), seed=d)
    perm = rng.permutation(d).astype(np.int32) if randomize else None
    flip = rng.integers(0, 2, size=d).astype(bool) if randomize else None
    jk, tk = _both_keys(points, bits, key_bits, perm, flip)
    assert tk.dtype == torch.int32 and tk.shape == (n, th.key_words(key_bits))
    np.testing.assert_array_equal(np.asarray(jk), _bits(tk))

    lo, hi = points.min(0), points.max(0)
    jorder, jsorted = jh.hilbert_sort(
        jnp.asarray(points), bits=bits, key_bits=key_bits, lo=jnp.asarray(lo),
        hi=jnp.asarray(hi))
    torder, tsorted = th.hilbert_sort(
        torch.from_numpy(points), bits=bits, key_bits=key_bits,
        lo=torch.from_numpy(lo), hi=torch.from_numpy(hi))
    assert torder.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jorder), torder.numpy())
    np.testing.assert_array_equal(np.asarray(jsorted), _bits(tsorted))


def test_lexsort_keeps_index_order_on_equal_keys():
    keys = np.array([[1, 0], [0, 5], [1, 0], [0xFFFFFFFF, 0], [0, 5], [1, 0]],
                    dtype=np.uint32)
    torder = th._lexsort_words(torch.from_numpy(keys.view(np.int32)))
    np.testing.assert_array_equal(np.asarray(jh._lexsort_words(jnp.asarray(keys))),
                                  torder.numpy())
    np.testing.assert_array_equal(torder.numpy(), [1, 4, 0, 2, 5, 3])


@pytest.mark.parametrize("d,bits", [(1, 4), (2, 2), (7, 5), (33, 3)])
def test_transpose_bit_equal_and_round_trip(d, bits):
    rng = np.random.default_rng(bits)
    coords = rng.integers(0, 1 << bits, size=(257, d), dtype=np.uint32)
    jt = np.asarray(jh.axes_to_transpose(jnp.asarray(coords), bits))
    tt = th.axes_to_transpose(torch.from_numpy(coords.astype(np.int32)), bits)
    np.testing.assert_array_equal(jt, _bits(tt))
    np.testing.assert_array_equal(th.transpose_to_axes(tt, bits).numpy(), coords)
    np.testing.assert_array_equal(
        np.asarray(jh.transpose_to_axes(jnp.asarray(jt), bits)),
        _bits(th.transpose_to_axes(tt, bits)))


def test_quantize_points_bit_equal():
    points = tdata.lowrank_embeddings(1000, 16, n_clusters=4, r=3, seed=4)
    points[:, 3] = 0.25  # a constant dim: span falls back to 1e-12
    lo, hi = points.min(0), points.max(0)
    jg = jh.quantize_points(jnp.asarray(points), 4, jnp.asarray(lo), jnp.asarray(hi))
    tg = th.quantize_points(torch.from_numpy(points), 4, torch.from_numpy(lo),
                            torch.from_numpy(hi))
    np.testing.assert_array_equal(np.asarray(jg), tg.numpy())


def test_lex_less_and_searchsorted_bit_equal():
    rng = np.random.default_rng(11)
    # Few distinct words so equal prefixes are common; top bit set often.
    pool = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], dtype=np.uint32)
    a = pool[rng.integers(0, 5, size=(400, 3))]
    b = pool[rng.integers(0, 5, size=(400, 3))]
    np.testing.assert_array_equal(
        np.asarray(jh.lex_less(jnp.asarray(a), jnp.asarray(b))),
        th.lex_less(torch.from_numpy(a.view(np.int32)),
                    torch.from_numpy(b.view(np.int32))).numpy())

    sorted_keys = a[np.lexsort(a.T[::-1])]
    queries = np.concatenate([
        sorted_keys[::7],  # exact matches
        b[:50],
        np.full((1, 3), 0xFFFFFFFF, np.uint32),  # above every key
        np.zeros((1, 3), np.uint32),
    ])
    for m in (1, 2, 5, 400):
        jpos = np.asarray(jh.lex_searchsorted(jnp.asarray(sorted_keys[:m]),
                                              jnp.asarray(queries)))
        tpos = th.lex_searchsorted(torch.from_numpy(sorted_keys[:m].view(np.int32)),
                                   torch.from_numpy(queries.view(np.int32)))
        np.testing.assert_array_equal(jpos, tpos.numpy())


def test_bits_outside_int32_range_raise():
    with pytest.raises(ValueError, match="int32"):
        th.axes_to_transpose(torch.zeros((2, 3), dtype=torch.int32), 32)
