"""The Hopper kernels of repro_torch on the card, against their plain versions.

Every test here needs an NVIDIA GPU with nvcc (marker ``cuda``) and skips
elsewhere.  On the card: ``python -m pytest -q tests/test_torch_cuda.py``.
The file imports torch and repro_torch only, so it runs without jax.
"""

import pytest
import torch

from repro_torch.kernels.bitpack import pack_bits, pack_bits_ref
from repro_torch.kernels.hamming import (hamming_matrix, hamming_matrix_ref,
                                         hamming_rows, hamming_rows_indexed,
                                         hamming_rows_indexed_ref, hamming_rows_ref)
from repro_torch.kernels.qdist import (qdist, qdist_from_packed, qdist_packed_ref,
                                       qdist_u8_ref, qdist_windows, qdist_windows_ref,
                                       qdist_windows_rows, qdist_windows_rows_ref,
                                       window_rows)

pytestmark = pytest.mark.cuda

DIST_RTOL = 1e-5  # the contract of tests/test_kernels_integration.py
DIST_ATOL = 1e-6


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.Generator(device="cuda").manual_seed(0)


def _words(gen, *shape):
    return torch.randint(-(2**31), 2**31, shape, generator=gen, device="cuda",
                         dtype=torch.int32)


@pytest.mark.parametrize("q,k,w", [(2048, 48, 12), (37, 33, 14), (1, 1, 1), (5, 3, 100)])
def test_hamming_rows_kernel_exact(gen, q, k, w):
    a, c = _words(gen, q, w), _words(gen, q, k, w)
    before = hamming_rows.launches
    got = hamming_rows(a, c)
    torch.cuda.synchronize()
    assert hamming_rows.launches == before + 1
    assert torch.equal(got, hamming_rows_ref(a, c))


# Ragged Q and K; W of 1, 12 (16-byte loads), 14 and 17 (4-byte loads);
# int32 and int64 indices; a table whose base is 4 bytes off 16.
@pytest.mark.parametrize("q,k,w,n,idx_dtype,table_offset", [
    (2048, 48, 12, 100_000, torch.int32, 0),  # the search's shape
    (37, 33, 12, 5000, torch.int64, 0),
    (129, 7, 12, 300, torch.int32, 1),        # 4-byte loads: base off 16
    (5, 130, 14, 1000, torch.int32, 0),
    (3, 1, 17, 50, torch.int64, 3),
    (1, 1, 1, 1, torch.int32, 0),             # one row
    (200, 96, 1, 7, torch.int64, 1),          # many repeats of few rows
])
def test_hamming_rows_indexed_kernel_exact(gen, q, k, w, n, idx_dtype, table_offset):
    """Rows read by index from the table against the plain version and
    against the pre-gathered launch on the same rows; rows 0 and n - 1,
    repeated rows and indices outside [0, n) (clamped) in every query; one
    launch counted under ``hamming_rows``."""
    a, table = _words(gen, q, w), _words(gen, n, w)
    if table_offset:
        table = _offset_view(table, table_offset)
    idx = torch.randint(0, n, (q, k), generator=gen, device="cuda", dtype=idx_dtype)
    idx[:, 0] = 0
    idx[:, -1] = n - 1
    if k > 3:
        idx[:, 1] = idx[:, 2]
        idx[0, 1], idx[-1, 2] = -5, n + 7
    want = hamming_rows_indexed_ref(a, table, idx)
    before = hamming_rows.launches
    got = hamming_rows_indexed(a, table, idx)
    torch.cuda.synchronize()
    assert hamming_rows.launches == before + 1
    assert got.shape == (q, k) and got.dtype == torch.int32
    assert torch.equal(got, want)
    gathered = table[idx.clamp(0, n - 1)].contiguous()
    assert torch.equal(hamming_rows(a, gathered), got)
    assert hamming_rows.launches == before + 2


@pytest.mark.parametrize("q,c,d", [(2048, 1920, 384), (37, 333, 61), (3, 1025, 8), (2, 5, 1)])
def test_qdist_windows_kernel_within_contract(gen, q, c, d):
    w = -(-d // 8)
    queries = torch.randn(q, d, generator=gen, device="cuda")
    win = _words(gen, q, c, w)
    cent = torch.sort(torch.randn(d, 16, generator=gen, device="cuda"), dim=1).values
    before = qdist_windows.launches
    got = qdist_windows(queries, win, cent)
    torch.cuda.synchronize()
    assert qdist_windows.launches == before + 1
    torch.testing.assert_close(got, qdist_windows_ref(queries, win, cent),
                               rtol=DIST_RTOL, atol=DIST_ATOL)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n,k", [(3000, 384), (262, 448), (37, 61), (1, 1), (5, 33),
                                 (1, 448), (64, 33), (300, 100), (7, 61), (129, 48)])
def test_pack_bits_kernel_exact(gen, n, k, offset):
    """Both paths of the kernel (16 bytes where the base lies on 16 bytes
    and K % 16 == 0, bytes elsewhere), a base offset by ``offset`` bytes,
    and bool input: bit-equal to the plain version."""
    bits = torch.randint(0, 2, (n, k), generator=gen, device="cuda", dtype=torch.uint8)
    if offset:
        bits = _offset_view(bits, offset)
    want = pack_bits_ref(bits)
    before = pack_bits.launches
    got = pack_bits(bits)
    torch.cuda.synchronize()
    assert pack_bits.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(pack_bits(bits.bool()), want)


@pytest.mark.parametrize("q,c,w", [(37, 333, 14), (64, 256, 12), (1, 1, 1), (5, 3, 20)])
def test_hamming_matrix_kernel_exact(gen, q, c, w):
    a, b = _words(gen, q, w), _words(gen, c, w)
    before = hamming_matrix.launches
    got = hamming_matrix(a, b)
    torch.cuda.synchronize()
    assert hamming_matrix.launches == before + 1
    assert torch.equal(got, hamming_matrix_ref(a, b))


# Edges of the 128 x 128 tile (Q and C of 1, 127, 128, 129, 333) at W of
# 1 to 33: one and several 8-word stages, ragged stages, 16-byte copies
# (W % 4 == 0) and 4-byte ones, C % 4 != 0 (scalar stores).
@pytest.mark.parametrize("w", [1, 8, 12, 14, 16, 17, 33])
def test_hamming_matrix_kernel_at_tile_edges(gen, w):
    for q, c in ((1, 1), (1, 333), (127, 128), (128, 129), (129, 127), (333, 1),
                 (128, 128), (333, 333)):
        a, b = _words(gen, q, w), _words(gen, c, w)
        got = hamming_matrix(a, b)
        torch.cuda.synchronize()
        assert torch.equal(got, hamming_matrix_ref(a, b)), (q, c, w)


@pytest.mark.parametrize("w", [1, 12, 17])
def test_hamming_matrix_kernel_on_constant_sketches(gen, w):
    """All-ones and all-zeros sketches: distances 0 and 32 W exactly, the
    extremes of popc(a) + popc(b) - 2 popc(a & b); a row against itself 0."""
    ones = torch.full((129, w), -1, dtype=torch.int32, device="cuda")
    zeros = torch.zeros((131, w), dtype=torch.int32, device="cuda")
    both = torch.cat([ones, zeros])
    got = hamming_matrix(both, both)
    torch.cuda.synchronize()
    assert torch.equal(got, hamming_matrix_ref(both, both))
    assert int(got[:129, :129].max()) == 0 and int(got[129:, 129:].max()) == 0
    assert int(got[:129, 129:].min()) == 32 * w
    rows = _words(gen, 140, w)
    assert torch.equal(torch.diagonal(hamming_matrix(rows, rows)),
                       torch.zeros(140, dtype=torch.int32, device="cuda"))


@pytest.mark.parametrize("q,c,w", [(130, 300, 12), (37, 333, 16)])
def test_hamming_matrix_kernel_on_unaligned_views(gen, q, c, w):
    """Queries and candidates that are views at odd word offsets (rows whose
    length would allow 16-byte copies, base pointers that do not)."""
    a, b = _words(gen, q, w), _words(gen, c, w)
    want = hamming_matrix_ref(a, b)
    for qa, cb in ((1, 0), (0, 1), (3, 2)):
        a_v = _offset_view(a, qa) if qa else a
        b_v = _offset_view(b, cb) if cb else b
        got = hamming_matrix(a_v, b_v)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (qa, cb)


@pytest.mark.parametrize("q,c,d", [(37, 333, 61), (64, 256, 384), (1, 1, 1), (5, 3, 100)])
def test_dense_qdist_kernels_within_contract(gen, q, c, d):
    """Kernels 5-6 (uint8 and nibble-packed codes) against their plain
    versions; a ragged last word must add nothing."""
    from repro_torch.core.quantize import pack_codes

    queries = torch.randn(q, d, generator=gen, device="cuda")
    codes = torch.randint(0, 16, (c, d), generator=gen, device="cuda", dtype=torch.uint8)
    cent = torch.sort(torch.randn(d, 16, generator=gen, device="cuda"), dim=1).values
    packed = pack_codes(codes)
    for fn, ref, arg in ((qdist, qdist_u8_ref, codes),
                         (qdist_from_packed, qdist_packed_ref, packed)):
        before = fn.launches
        got = fn(queries, arg, cent)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        torch.testing.assert_close(got, ref(queries, arg, cent),
                                   rtol=DIST_RTOL, atol=DIST_ATOL)


def _dense_launchers(codes):
    """(name, wrapper, plain version, codes argument) of kernels 5-6."""
    from repro_torch.core.quantize import pack_codes

    return (("qdist", qdist, qdist_u8_ref, codes),
            ("qdist_from_packed", qdist_from_packed, qdist_packed_ref, pack_codes(codes)))


# Tile edges of the 128 x 128 block and the 32-dim stage: Q and C of 1,
# 127, 128, 129, 257; D of 1, 7, 8, 15, 16, 17, 383, 384, 385 (rows not
# 16-byte aligned take the slower copies); one ragged shape of many blocks.
@pytest.mark.parametrize("q,c,d", [
    (1, 257, 1), (127, 128, 7), (128, 129, 8), (129, 127, 15), (257, 1, 16),
    (128, 128, 17), (129, 257, 383), (127, 129, 384), (257, 128, 385),
    (300, 20000, 385),
])
def test_dense_qdist_kernels_at_tile_edges(gen, q, c, d):
    queries = torch.randn(q, d, generator=gen, device="cuda")
    codes = torch.randint(0, 16, (c, d), generator=gen, device="cuda", dtype=torch.uint8)
    cent = torch.sort(torch.randn(d, 16, generator=gen, device="cuda"), dim=1).values
    for name, fn, ref, arg in _dense_launchers(codes):
        before = fn.launches
        got = fn(queries, arg, cent)
        torch.cuda.synchronize()
        assert fn.launches == before + 1, name
        torch.testing.assert_close(got, ref(queries, arg, cent),
                                   rtol=DIST_RTOL, atol=DIST_ATOL, msg=name)


@pytest.mark.parametrize("levels", [5, 256])
@pytest.mark.parametrize("q,c,d", [(129, 257, 384), (37, 333, 61)])
def test_dense_qdist_u8_kernel_other_levels(gen, levels, q, c, d):
    """The u8 kernel with L other than 16 (every code < L): L = 5 stages
    its centroid rows 4 bytes at a time, L = 256 a 32 KB table a stage."""
    queries = torch.randn(q, d, generator=gen, device="cuda")
    codes = torch.randint(0, levels, (c, d), generator=gen, device="cuda",
                          dtype=torch.uint8)
    cent = torch.randn(d, levels, generator=gen, device="cuda")
    before = qdist.launches
    got = qdist(queries, codes, cent)
    torch.cuda.synchronize()
    assert qdist.launches == before + 1
    torch.testing.assert_close(got, qdist_u8_ref(queries, codes, cent),
                               rtol=DIST_RTOL, atol=DIST_ATOL)


@pytest.mark.parametrize("q,c,d", [(130, 300, 385), (256, 1024, 384)])
def test_dense_qdist_kernels_read_exact_zero_on_equal_rows(gen, q, c, d):
    """A query equal to a dequantized candidate row reads exactly 0.0: the
    kernels sum (q - r)^2 directly.  The expanded |q|^2 - 2 q.r + |r|^2
    would leave an error that grows with |q|^2 (here ~100 d)."""
    codes = torch.randint(0, 16, (c, d), generator=gen, device="cuda", dtype=torch.uint8)
    cent = 10 * torch.sort(torch.randn(d, 16, generator=gen, device="cuda"), dim=1).values
    rows = torch.randperm(c, generator=gen, device="cuda")[:q]
    queries = cent[torch.arange(d, device="cuda"), codes[rows].long()].contiguous()
    for name, fn, _, arg in _dense_launchers(codes):
        before = fn.launches
        got = fn(queries, arg, cent)
        torch.cuda.synchronize()
        assert fn.launches == before + 1, name
        on_equal = got[torch.arange(q, device="cuda"), rows]
        assert torch.equal(on_equal, torch.zeros_like(on_equal)), name
        assert bool((got >= 0).all()), name


def _offset_view(x, offset):
    """A contiguous copy of ``x`` that starts ``offset`` elements into a
    larger buffer, so its base pointer is not 16-byte aligned."""
    buf = torch.zeros(x.numel() + offset, dtype=x.dtype, device=x.device)
    view = buf[offset:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.storage_offset() == offset
    return view


@pytest.mark.parametrize("q,c,d", [(257, 300, 384), (37, 333, 64)])
def test_dense_qdist_kernels_on_unaligned_views(gen, q, c, d):
    """Queries, codes and centroids that are views at an odd storage offset
    (rows whose length would allow 16-byte copies, base pointers that do
    not) read as their aligned copies do."""
    queries = torch.randn(q, d, generator=gen, device="cuda")
    codes = torch.randint(0, 16, (c, d), generator=gen, device="cuda", dtype=torch.uint8)
    cent = torch.sort(torch.randn(d, 16, generator=gen, device="cuda"), dim=1).values
    for name, fn, ref, arg in _dense_launchers(codes):
        want = ref(queries, arg, cent)
        for views in ((1, 0, 0), (0, 1, 0), (0, 0, 1), (3, 1, 1)):
            q_v, arg_v, cent_v = (_offset_view(x, k) if k else x
                                  for x, k in zip((queries, arg, cent), views))
            before = fn.launches
            got = fn(q_v, arg_v, cent_v)
            torch.cuda.synchronize()
            assert fn.launches == before + 1, name
            torch.testing.assert_close(got, want, rtol=DIST_RTOL, atol=DIST_ATOL,
                                       msg=f"{name} offsets {views}")


def _window_case(gen, q, s, window, d, n, word_offset):
    """Queries, centroids, codes (at ``word_offset`` words into a buffer)
    and starts with neighbouring windows overlapping, every query with a
    window at 0 and one at n - window."""
    w = -(-d // 8)
    queries = torch.randn(q, d, generator=gen, device="cuda")
    cent = torch.sort(torch.randn(d, 16, generator=gen, device="cuda"), dim=1).values
    codes = _words(gen, n, w)  # padding nibbles too: both versions skip them
    if word_offset:
        codes = _offset_view(codes, word_offset)
    centre = torch.randint(0, n, (q, 1), generator=gen, device="cuda")
    spread = torch.randint(-3 * s, 3 * s + 1, (q, s), generator=gen, device="cuda")
    starts = (centre + spread).clamp(0, n - window)
    starts[:, 0] = 0
    starts[:, -1] = n - window
    return queries, cent, codes, starts.to(torch.int32).contiguous()


@pytest.mark.parametrize("q,s,window,d,n,word_offset", [
    (64, 384, 5, 384, 5000, 0),   # the engine's pool, 1920 a query
    (33, 111, 3, 384, 700, 1),    # codes at an odd word offset: 4-byte copies
    (17, 300, 1, 384, 2000, 0),   # L = 1
    (9, 53, 5, 61, 400, 0),       # ragged last word, 265 candidates
    (5, 7, 5, 100, 50, 0),        # W = 13: 4-byte copies; 35 candidates
    (3, 1, 1, 8, 1, 0),           # one row
])
def test_qdist_windows_rows_kernel_within_contract(gen, q, s, window, d, n, word_offset):
    """Windows read from the resident codes against the plain version
    (gather, then qdist_windows_ref); both wrappers bit-equal on the same
    rows; one launch counted per call."""
    queries, cent, codes, starts = _window_case(gen, q, s, window, d, n, word_offset)
    before = qdist_windows.launches
    got = qdist_windows_rows(queries, codes, starts, window, cent)
    torch.cuda.synchronize()
    assert qdist_windows.launches == before + 1
    assert got.shape == (q, s * window)
    torch.testing.assert_close(
        got, qdist_windows_rows_ref(queries, codes, starts, window, cent),
        rtol=DIST_RTOL, atol=DIST_ATOL)
    gathered = window_rows(codes, starts, window).reshape(q, s * window, -1).contiguous()
    pre = qdist_windows(queries, gathered, cent)
    torch.cuda.synchronize()
    assert qdist_windows.launches == before + 2
    assert torch.equal(pre, got)


def test_qdist_windows_rows_reads_nan_outside_the_rows(gen):
    queries, cent, codes, starts = _window_case(gen, 4, 10, 5, 64, 100, 0)
    starts[1, 3] = 96  # rows 96..100: the last one is past the end
    starts[2, 0] = -1
    got = qdist_windows_rows(queries, codes, starts, 5, cent)
    torch.cuda.synchronize()
    nan = torch.zeros_like(got, dtype=torch.bool)
    nan[1, 19] = nan[2, 0] = True
    assert torch.equal(torch.isnan(got), nan)


def test_wrappers_reject_mixed_devices(gen):
    a = _words(gen, 4, 3)
    with pytest.raises(ValueError):
        hamming_rows(a, a.cpu()[:, None, :].contiguous())
    with pytest.raises(ValueError):
        hamming_rows_indexed(a, a.cpu(), torch.zeros((4, 2), dtype=torch.int32,
                                                     device="cuda"))
    q = torch.zeros((2, 8), device="cuda")
    with pytest.raises(ValueError):
        qdist_windows(q, torch.zeros((2, 3, 1), dtype=torch.int32),
                      torch.zeros((8, 16), device="cuda"))


def test_streamed_mutable_index_on_card_equals_cpu(gen):
    """The same inserts, deletes, seals, tier merges and compaction on the
    card and on the CPU: every state array bit-equal, search within the
    contract (queries off the point set)."""
    import numpy as np

    from repro_torch.data import ann_datasets
    from repro_torch.index import (ForestConfig, IndexConfig, MutableHilbertIndex,
                                   SearchParams)

    data, queries = ann_datasets.lowrank_dataset_with_queries(3000, 32, 64,
                                                              n_clusters=8, seed=0)
    cfg = IndexConfig(forest=ForestConfig(n_trees=4, bits=4, key_bits=128,
                                          leaf_size=16), seal_pow2=True)
    params = SearchParams(k1=16, k2=64, h=1, k=10)
    out = {}
    for dev in ("cuda", "cpu"):
        rng = np.random.default_rng(0)
        mut = MutableHilbertIndex(cfg, buffer_capacity=256, max_segments=3, device=dev)
        mut.bulk_load(data[:1000])
        for s in range(1000, 3000, 200):
            mut.insert(data[s : s + 200])
            mut.delete(rng.choice(mut.n_live + mut.n_deleted, 20, replace=False))
        res = []
        for compact in (False, True):
            if compact:
                mut.compact()
            ids, d2 = mut.search(queries, params)
            assert ids.device.type == dev
            segs = [(s.gen, s.n_valid, s.ids, s.index.array_bundle())
                    for s in mut.segments]
            res.append((mut._alive.copy(), mut._next_id, segs, ids.cpu(), d2.cpu()))
        out[dev] = res
    for (galive, gnext, gsegs, gids, gd), (calive, cnext, csegs, cids, cd) in zip(
            out["cuda"], out["cpu"]):
        assert np.array_equal(galive, calive) and gnext == cnext
        assert len(gsegs) == len(csegs)
        for (gg, gv, gi, ga), (cg, cv, ci, ca) in zip(gsegs, csegs):
            assert (gg, gv) == (cg, cv) and np.array_equal(gi, ci)
            assert sorted(ga) == sorted(ca)
            for k in ga:
                assert ga[k].dtype == ca[k].dtype and np.array_equal(ga[k], ca[k]), k
        torch.testing.assert_close(gd, cd, rtol=DIST_RTOL, atol=DIST_ATOL)
        mism = gids != cids
        for r, c in zip(*torch.nonzero(mism, as_tuple=True)):
            tied = torch.isclose(cd[r], cd[r, c], atol=1e-4, rtol=0)
            assert gids[r, c] in set(cids[r, tied].tolist())


def test_launch_counter_is_exact_under_two_threads(gen):
    """Two serve threads launch the same kernel at once: the counter sees
    every launch (a bare ``+= 1`` can lose one between read and write)."""
    import sys
    import threading

    a, c = _words(gen, 64, 12), _words(gen, 64, 48, 12)
    n = 2000
    hamming_rows(a, c)  # load the library before the race
    torch.cuda.synchronize()
    before = hamming_rows.launches

    def run():
        for _ in range(n):
            hamming_rows(a, c)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    torch.cuda.synchronize()
    assert hamming_rows.launches == before + 2 * n
