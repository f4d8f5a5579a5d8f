"""Port parity: the plain versions of the Hopper kernels against repro.

``hamming_rows_ref`` and ``hamming_matrix_ref`` must equal the JAX
``hamming_rows`` and ``hamming_matrix`` exactly, in both their
interpret-mode Pallas kernels and their oracles, and so must
``pack_bits_ref`` the JAX ``pack_bits``; ``qdist_windows_ref`` must agree
with ``qdist_windows_from_packed`` (interpret-mode kernel and oracle)
within the repo's distance contract, and ``qdist_u8_ref`` and
``qdist_packed_ref`` with ``qdist`` and ``qdist_from_packed`` (the
oracles within that contract, the interpret-mode kernels within
``tests/test_kernels.py``'s rtol 1e-5 / atol 1e-5: their expanded
``|q|^2 - 2 q.r + |r|^2`` form cancels digits).  On CPU tensors the wrappers
take the plain versions and launch nothing; the kernels themselves run in
``tests/test_torch_cuda.py`` on a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitpack import pack_bits as j_pack_bits
from repro.kernels.hamming import hamming_matrix as j_hamming_matrix
from repro.kernels.hamming import hamming_matrix_ref as j_hamming_matrix_ref
from repro.kernels.hamming import hamming_rows as j_hamming_rows
from repro.kernels.qdist import qdist as j_qdist
from repro.kernels.qdist import qdist_from_packed as j_qdist_from_packed
from repro.kernels.qdist import qdist_windows_from_packed
from repro_torch.kernels import _build
from repro_torch.kernels.bitpack import pack_bits, pack_bits_ref
from repro_torch.kernels.hamming import (hamming_matrix, hamming_matrix_ref,
                                         hamming_rows, hamming_rows_indexed,
                                         hamming_rows_indexed_ref, hamming_rows_ref)
from repro_torch.kernels.qdist import (qdist, qdist_from_packed, qdist_packed_ref,
                                       qdist_u8_ref, qdist_windows, qdist_windows_ref,
                                       qdist_windows_rows, qdist_windows_rows_ref)
from test_kernels_integration import DIST_ATOL, DIST_RTOL


def _words(rng, *shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


@pytest.mark.parametrize("q,k,w", [(1, 4, 3), (7, 33, 12), (130, 16, 14), (37, 48, 12)])
def test_hamming_rows_ref_matches_jax_kernel_and_oracle(q, k, w):
    rng = np.random.default_rng(q * 1000 + k)
    a, c = _words(rng, q, w), _words(rng, q, k, w)
    ta, tc = torch.from_numpy(a.view(np.int32)), torch.from_numpy(c.view(np.int32))
    ref = hamming_rows_ref(ta, tc)
    assert ref.dtype == torch.int32 and ref.shape == (q, k)
    for use_kernel in (True, False):
        want = j_hamming_rows(jnp.asarray(a), jnp.asarray(c), use_kernel=use_kernel,
                              interpret=True)
        np.testing.assert_array_equal(np.asarray(want), ref.numpy())
    before = hamming_rows.launches
    np.testing.assert_array_equal(hamming_rows(ta, tc).numpy(), ref.numpy())
    assert hamming_rows.launches == before  # CPU tensors launch nothing


# W of 1, 12 and 14; int32 and int64 indices; indices outside [0, n)
# clamped, as jnp.take(..., mode="clip") clamps them.
@pytest.mark.parametrize("q,k,w,n,idx_dtype,out_of_range", [
    (1, 4, 1, 9, np.int32, False),
    (7, 33, 12, 500, np.int64, False),
    (130, 16, 14, 40, np.int32, True),
    (37, 48, 12, 3000, np.int64, True),
])
def test_hamming_rows_indexed_ref_matches_jax_kernel_and_oracle(q, k, w, n, idx_dtype,
                                                                out_of_range):
    rng = np.random.default_rng(q * 1000 + k)
    a, table = _words(rng, q, w), _words(rng, n, w)
    idx = rng.integers(0, n, size=(q, k)).astype(idx_dtype)
    idx[:, 0], idx[:, -1] = 0, n - 1
    if out_of_range:
        idx[0, 1], idx[-1, 2], idx[q // 2, 3] = -1, n, -(2**20)
    ta = torch.from_numpy(a.view(np.int32))
    tt, ti = torch.from_numpy(table.view(np.int32)), torch.from_numpy(idx)
    ref = hamming_rows_indexed_ref(ta, tt, ti)
    assert ref.dtype == torch.int32 and ref.shape == (q, k)
    gathered = jnp.take(jnp.asarray(table), jnp.asarray(idx), axis=0, mode="clip")
    for use_kernel in (True, False):
        want = j_hamming_rows(jnp.asarray(a), gathered, use_kernel=use_kernel,
                              interpret=True)
        np.testing.assert_array_equal(np.asarray(want), ref.numpy())
    before = hamming_rows.launches
    np.testing.assert_array_equal(hamming_rows_indexed(ta, tt, ti).numpy(), ref.numpy())
    assert hamming_rows.launches == before  # CPU tensors launch nothing


@pytest.mark.parametrize("q,c,d", [(3, 130, 64), (2, 40, 384), (3, 17, 61)])
def test_qdist_windows_ref_matches_jax_kernel_and_oracle(q, c, d):
    rng = np.random.default_rng(q * 100 + d)
    w = -(-d // 8)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    codes = rng.integers(0, 16, size=(q, c, w * 8), dtype=np.uint32)
    codes[..., d:] = 0  # pack_codes leaves the padding nibbles zero
    shifts = np.arange(8, dtype=np.uint32) * 4
    packed = (codes.reshape(q, c, w, 8) << shifts).sum(-1, dtype=np.uint32)
    cent = np.sort(rng.normal(size=(d, 16)).astype(np.float32), axis=1)
    tq, tp, tc = (torch.from_numpy(queries), torch.from_numpy(packed.view(np.int32)),
                  torch.from_numpy(cent))
    ref = qdist_windows_ref(tq, tp, tc)
    assert ref.dtype == torch.float32 and ref.shape == (q, c)
    for use_kernel in (True, False):
        want = qdist_windows_from_packed(
            jnp.asarray(queries), jnp.asarray(packed), jnp.asarray(cent), d=d,
            use_kernel=use_kernel, interpret=True)
        np.testing.assert_allclose(ref.numpy(), np.asarray(want),
                                   rtol=DIST_RTOL, atol=DIST_ATOL)
    before = qdist_windows.launches
    np.testing.assert_array_equal(qdist_windows(tq, tp, tc).numpy(), ref.numpy())
    assert qdist_windows.launches == before


@pytest.mark.parametrize("q,s,window,d,n", [(3, 24, 5, 64, 200), (2, 9, 3, 61, 40),
                                            (4, 17, 1, 384, 90), (1, 3, 5, 8, 5)])
def test_qdist_windows_rows_ref_matches_jax_kernel_and_oracle(q, s, window, d, n):
    """Windows read from resident codes: the plain version against the JAX
    ``qdist_windows_from_packed`` (interpret-mode kernel and oracle) on the
    same windows gathered with numpy, within the distance contract; starts
    at 0 and n - window in every query."""
    rng = np.random.default_rng(q * 1000 + s * 10 + d)
    w = -(-d // 8)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    nib = rng.integers(0, 16, size=(n, w * 8), dtype=np.uint32)
    nib[:, d:] = 0  # pack_codes leaves the padding nibbles zero
    codes = (nib.reshape(n, w, 8) << (np.arange(8, dtype=np.uint32) * 4)).sum(
        -1, dtype=np.uint32)
    starts = rng.integers(0, n - window + 1, size=(q, s)).astype(np.int32)
    starts[:, 0], starts[:, -1] = 0, n - window
    cent = np.sort(rng.normal(size=(d, 16)).astype(np.float32), axis=1)
    windows = codes[starts[:, :, None] + np.arange(window)].reshape(q, s * window, w)
    tq, tc, ts, tcent = (torch.from_numpy(queries), torch.from_numpy(codes.view(np.int32)),
                         torch.from_numpy(starts), torch.from_numpy(cent))
    ref = qdist_windows_rows_ref(tq, tc, ts, window, tcent)
    assert ref.dtype == torch.float32 and ref.shape == (q, s * window)
    for use_kernel in (True, False):
        want = qdist_windows_from_packed(
            jnp.asarray(queries), jnp.asarray(windows), jnp.asarray(cent), d=d,
            use_kernel=use_kernel, interpret=True)
        np.testing.assert_allclose(ref.numpy(), np.asarray(want),
                                   rtol=DIST_RTOL, atol=DIST_ATOL)
    before = qdist_windows.launches
    np.testing.assert_array_equal(qdist_windows_rows(tq, tc, ts, window, tcent).numpy(),
                                  ref.numpy())
    np.testing.assert_array_equal(
        qdist_windows(tq, torch.from_numpy(windows.view(np.int32)), tcent).numpy(),
        ref.numpy())
    assert qdist_windows.launches == before  # CPU tensors launch nothing


def _bad_rows_args():
    q = torch.zeros((2, 61), dtype=torch.float32)
    rows = torch.zeros((9, 8), dtype=torch.int32)
    st = torch.zeros((2, 3), dtype=torch.int32)
    cent = torch.zeros((61, 16), dtype=torch.float32)
    return [
        (q, rows, st.long(), 2, cent, TypeError),
        (q, rows.to(torch.int64), st, 2, cent, TypeError),
        (q, rows[:, :7].contiguous(), st, 2, cent, ValueError),  # W != ceil(D/8)
        (q, rows, st[:1], 2, cent, ValueError),  # Q mismatch
        (q, rows, st, 0, cent, ValueError),  # window < 1
        (q, rows, st, 2.0, cent, ValueError),  # window not an int
        (q, rows, st.t().contiguous().t(), 2, cent, ValueError),  # strided starts
        (q, rows, st, 2, cent[:, :8].contiguous(), ValueError),  # not 16 levels
    ]


@pytest.mark.parametrize("case", range(8))
def test_qdist_windows_rows_rejects_bad_arguments(case):
    q, rows, st, window, cent, err = _bad_rows_args()[case]
    with pytest.raises(err):
        qdist_windows_rows(q, rows, st, window, cent)


@pytest.mark.parametrize("caller", ["hilbert_keys", "make_sketches", "sketches_from_codes"])
def test_pack_bits_callers_give_only_zero_and_one(monkeypatch, caller):
    """The kernel's 16-byte path turns four bytes into four bits by one
    multiply, which holds only for bytes in {0, 1}: both callers give no
    other value (the key bits are masked with & 1, the sketches are a bool
    comparison)."""
    from repro_torch.core import hilbert, quantize, sketch
    from repro_torch.kernels import bitpack

    seen = []
    real = bitpack.pack_bits

    def record(bits, **kw):
        seen.append(bits.clone())
        return real(bits, **kw)

    monkeypatch.setattr(bitpack, "pack_bits", record)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(300, 64)).astype(np.float32))
    if caller == "hilbert_keys":
        keys = hilbert.hilbert_keys(x, bits=4, key_bits=200, lo=x.min(0).values,
                                    hi=x.max(0).values)
        assert keys.shape == (300, 7)
    else:
        quant = quantize.fit(x, bits=4)
        if caller == "make_sketches":
            sketch.make_sketches(quant, x)
        else:
            sketch.sketches_from_codes(quantize.encode(quant, x))
    assert seen
    for bits in seen:
        assert bits.dtype in (torch.uint8, torch.bool)
        values = set(torch.unique(bits.view(torch.uint8)).tolist())
        assert values <= {0, 1} and values == {0, 1}


@pytest.mark.parametrize("q,c,w", [(1, 1, 1), (7, 129, 12), (130, 257, 16)])
def test_hamming_matrix_ref_matches_jax_kernel_and_oracle(q, c, w):
    rng = np.random.default_rng(q * 1000 + c)
    a, b = _words(rng, q, w), _words(rng, c, w)
    ta, tb = torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32))
    ref = hamming_matrix_ref(ta, tb)
    assert ref.dtype == torch.int32 and ref.shape == (q, c)
    for want in (j_hamming_matrix(jnp.asarray(a), jnp.asarray(b), use_kernel=True,
                                  interpret=True),
                 j_hamming_matrix_ref(jnp.asarray(a), jnp.asarray(b))):
        np.testing.assert_array_equal(np.asarray(want), ref.numpy())
    before = hamming_matrix.launches
    np.testing.assert_array_equal(hamming_matrix(ta, tb).numpy(), ref.numpy())
    assert hamming_matrix.launches == before  # CPU tensors launch nothing


def _dense_codes(q, c, d):
    """Queries, 4-bit codes (uint8 and nibble-packed) and sorted centroids."""
    rng = np.random.default_rng(q * 100 + d)
    w = -(-d // 8)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    codes = rng.integers(0, 16, size=(c, d), dtype=np.uint8)
    wide = np.zeros((c, w * 8), np.uint32)
    wide[:, :d] = codes  # pack_codes leaves the padding nibbles zero
    shifts = np.arange(8, dtype=np.uint32) * 4
    packed = (wide.reshape(c, w, 8) << shifts).sum(-1, dtype=np.uint32)
    cent = np.sort(rng.normal(size=(d, 16)).astype(np.float32), axis=1)
    return queries, codes, packed, cent


@pytest.mark.parametrize("layout", ["u8", "packed"])
@pytest.mark.parametrize("q,c,d", [(5, 200, 48), (16, 64, 100), (9, 130, 384)])
def test_dense_qdist_refs_match_jax_kernel_and_oracle(q, c, d, layout):
    queries, codes, packed, cent = _dense_codes(q, c, d)
    tq, tc = torch.from_numpy(queries), torch.from_numpy(cent)
    if layout == "u8":
        arg, wrapper, ref_fn = torch.from_numpy(codes), qdist, qdist_u8_ref
        jq, jcodes, jcent = jnp.asarray(queries), jnp.asarray(codes), jnp.asarray(cent)
        oracle = j_qdist(jq, jcodes, jcent)
        kernel = j_qdist(jq, jcodes, jcent, use_kernel=True, interpret=True)
    else:
        arg = torch.from_numpy(packed.view(np.int32))
        wrapper, ref_fn = qdist_from_packed, qdist_packed_ref
        jq, jp, jcent = jnp.asarray(queries), jnp.asarray(packed), jnp.asarray(cent)
        oracle = j_qdist_from_packed(jq, jp, jcent, d=d)
        kernel = j_qdist_from_packed(jq, jp, jcent, d=d, use_kernel=True, interpret=True)
    ref = ref_fn(tq, arg, tc)
    assert ref.dtype == torch.float32 and ref.shape == (q, c)
    np.testing.assert_allclose(ref.numpy(), np.asarray(oracle), rtol=DIST_RTOL,
                               atol=DIST_ATOL)
    np.testing.assert_allclose(ref.numpy(), np.asarray(kernel), rtol=1e-5, atol=1e-5)
    before = wrapper.launches
    np.testing.assert_array_equal(wrapper(tq, arg, tc).numpy(), ref.numpy())
    assert wrapper.launches == before  # CPU tensors launch nothing


def test_dense_qdist_refs_chunk_without_changing_a_bit(monkeypatch):
    """The plain versions walk the queries in blocks (the bench shape would
    need 12.9 GB at once); block boundaries move no bit."""
    from repro_torch.kernels.hamming import ops as hops
    from repro_torch.kernels.qdist import ops as qops

    queries, codes, packed, cent = _dense_codes(9, 130, 61)
    tq, tc = torch.from_numpy(queries), torch.from_numpy(cent)
    tp = torch.from_numpy(packed.view(np.int32))
    words = torch.from_numpy(_words(np.random.default_rng(0), 9, 3).view(np.int32))
    whole = (qdist_u8_ref(tq, torch.from_numpy(codes), tc), qdist_packed_ref(tq, tp, tc),
             hamming_matrix_ref(words, tp[:, :3].contiguous()))
    monkeypatch.setattr(qops, "_REF_ELEMS", 2 * 130 * 61)  # 2 queries a block
    monkeypatch.setattr(hops, "_REF_ELEMS", 2 * 130 * 3)
    blocks = (qdist_u8_ref(tq, torch.from_numpy(codes), tc), qdist_packed_ref(tq, tp, tc),
              hamming_matrix_ref(words, tp[:, :3].contiguous()))
    for a, b in zip(whole, blocks):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,k", [(1, 1), (37, 61), (300, 384), (257, 448)])
def test_pack_bits_ref_matches_jax_kernel_and_oracle(n, k):
    bits = np.random.default_rng(n * 7 + k).integers(0, 2, size=(n, k), dtype=np.uint8)
    ref = pack_bits_ref(torch.from_numpy(bits))
    assert ref.dtype == torch.int32 and ref.shape == (n, -(-k // 32))
    for use_kernel in (True, False):
        want = j_pack_bits(jnp.asarray(bits), use_kernel=use_kernel, interpret=True)
        np.testing.assert_array_equal(np.asarray(want).view(np.int32), ref.numpy())
    before = pack_bits.launches
    np.testing.assert_array_equal(pack_bits(torch.from_numpy(bits)).numpy(), ref.numpy())
    np.testing.assert_array_equal(pack_bits(torch.from_numpy(bits.astype(bool))).numpy(),
                                  ref.numpy())
    assert pack_bits.launches == before  # CPU tensors launch nothing


def _bad_pack_args():
    b = torch.zeros((4, 40), dtype=torch.uint8)
    return [
        (b.to(torch.int32), TypeError),
        (b[0], ValueError),  # rank
        (b[:, ::2], ValueError),  # strided
        (b.numpy(), TypeError),
    ]


@pytest.mark.parametrize("case", range(4))
def test_pack_bits_rejects_bad_arguments(case):
    bits, err = _bad_pack_args()[case]
    with pytest.raises(err):
        pack_bits(bits)


def _bad_hamming_args():
    a = torch.zeros((4, 3), dtype=torch.int32)
    c = torch.zeros((4, 5, 3), dtype=torch.int32)
    return [
        (a.to(torch.int64), c, TypeError),
        (a, c.to(torch.uint8), TypeError),
        (a, c[:, :, :2], ValueError),  # W mismatch
        (a, c[:3], ValueError),  # Q mismatch
        (a, c.transpose(0, 1).contiguous().transpose(0, 1), ValueError),  # strided
        (a[:, :, None], c, ValueError),  # rank
        (a.numpy(), c, TypeError),
    ]


@pytest.mark.parametrize("case", range(7))
def test_hamming_rows_rejects_bad_arguments(case):
    a, c, err = _bad_hamming_args()[case]
    with pytest.raises(err):
        hamming_rows(a, c)


def _bad_hamming_indexed_args():
    a = torch.zeros((4, 3), dtype=torch.int32)
    t = torch.zeros((9, 3), dtype=torch.int32)
    i = torch.zeros((4, 5), dtype=torch.int32)
    return [
        (a, t, i.to(torch.int16), TypeError),
        (a, t, i.float(), TypeError),
        (a, t.to(torch.int64), i, TypeError),
        (a, t[:, :2].contiguous(), i, ValueError),  # W mismatch
        (a, t, i[:3], ValueError),  # Q mismatch
        (a, t, i[:, None, :], ValueError),  # rank
        (a, t, i.t().contiguous().t(), ValueError),  # strided
        (a, t[:0], i, ValueError),  # empty table
        (a, t, i.numpy(), TypeError),
    ]


@pytest.mark.parametrize("case", range(9))
def test_hamming_rows_indexed_rejects_bad_arguments(case):
    a, t, i, err = _bad_hamming_indexed_args()[case]
    with pytest.raises(err):
        hamming_rows_indexed(a, t, i)


def _bad_qdist_args():
    q = torch.zeros((2, 61), dtype=torch.float32)
    p = torch.zeros((2, 9, 8), dtype=torch.int32)
    cent = torch.zeros((61, 16), dtype=torch.float32)
    return [
        (q.double(), p, cent, TypeError),
        (q, p.to(torch.int64), cent, TypeError),
        (q, p[:, :, :7].contiguous(), cent, ValueError),  # W != ceil(D/8)
        (q, p, cent[:, :8].contiguous(), ValueError),  # not 16 levels
        (q, p, cent[:60], ValueError),
        (q, p[:1], cent, ValueError),
        (q.t().contiguous().t(), p, cent, ValueError),  # strided queries
    ]


@pytest.mark.parametrize("case", range(7))
def test_qdist_windows_rejects_bad_arguments(case):
    q, p, cent, err = _bad_qdist_args()[case]
    with pytest.raises(err):
        qdist_windows(q, p, cent)


def _bad_hamming_matrix_args():
    a = torch.zeros((4, 3), dtype=torch.int32)
    c = torch.zeros((5, 3), dtype=torch.int32)
    return [
        (a.to(torch.int64), c, TypeError),
        (a, c.to(torch.uint8), TypeError),
        (a, c[:, :2].contiguous(), ValueError),  # W mismatch
        (a, c[:, None, :], ValueError),  # rank
        (a, c.t().contiguous().t(), ValueError),  # strided
        (a.numpy(), c, TypeError),
    ]


@pytest.mark.parametrize("case", range(6))
def test_hamming_matrix_rejects_bad_arguments(case):
    a, c, err = _bad_hamming_matrix_args()[case]
    with pytest.raises(err):
        hamming_matrix(a, c)


def _bad_dense_qdist_args(packed):
    q = torch.zeros((2, 61), dtype=torch.float32)
    codes = (torch.zeros((9, 8), dtype=torch.int32) if packed
             else torch.zeros((9, 61), dtype=torch.uint8))
    cent = torch.zeros((61, 16), dtype=torch.float32)
    wrong_type = torch.int64 if packed else torch.int32
    return [
        (q.double(), codes, cent, TypeError),
        (q, codes.to(wrong_type), cent, TypeError),
        (q, codes[:, :7].contiguous(), cent, ValueError),  # width != D (u8), ceil(D/8)
        (q, codes, cent[:60], ValueError),  # centroids D
        (q, codes, cent.double(), TypeError),
        (q.t().contiguous().t(), codes, cent, ValueError),  # strided queries
        (q, codes[:, None, :], cent, ValueError),  # rank
    ]


@pytest.mark.parametrize("case", range(7))
@pytest.mark.parametrize("layout", ["u8", "packed"])
def test_dense_qdist_rejects_bad_arguments(layout, case):
    q, codes, cent, err = _bad_dense_qdist_args(layout == "packed")[case]
    with pytest.raises(err):
        (qdist_from_packed if layout == "packed" else qdist)(q, codes, cent)


def test_qdist_from_packed_needs_16_levels():
    q = torch.zeros((2, 61), dtype=torch.float32)
    with pytest.raises(ValueError):
        qdist_from_packed(q, torch.zeros((9, 8), dtype=torch.int32),
                          torch.zeros((61, 8), dtype=torch.float32))
    # the uint8 layout takes any number of levels, as the JAX wrapper does
    assert qdist(q, torch.zeros((9, 61), dtype=torch.uint8),
                 torch.zeros((61, 8), dtype=torch.float32)).shape == (2, 9)


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_build_targets_are_keyed_by_source_and_flags():
    targets = {n: _build._target(n) for n in _build.SOURCES}
    assert set(_build.SOURCES) == {p.stem for p in _build.CSRC.glob("*.cu")}
    for name, path in targets.items():
        assert path.parent == _build.BUILD_DIR and path.name.startswith(name + "-")
        assert path.suffix == ".so"
    assert len(set(targets.values())) == len(targets)
