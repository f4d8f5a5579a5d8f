"""The Hopper kernels of repro_torch on the card, against their plain versions.

Every test here needs an NVIDIA GPU with nvcc (marker ``cuda``) and skips
elsewhere.  On the card: ``python -m pytest -q tests/test_torch_cuda.py``.
The file imports torch and repro_torch only, so it runs without jax.
"""

import pytest
import torch

from repro_torch.kernels.bitpack import pack_bits, pack_bits_ref
from repro_torch.kernels.hamming import hamming_rows, hamming_rows_ref
from repro_torch.kernels.qdist import qdist_windows, qdist_windows_ref

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


@pytest.mark.parametrize("n,k", [(3000, 384), (262, 448), (37, 61), (1, 1), (5, 33)])
def test_pack_bits_kernel_exact(gen, n, k):
    bits = torch.randint(0, 2, (n, k), generator=gen, device="cuda", dtype=torch.uint8)
    before = pack_bits.launches
    got = pack_bits(bits)
    torch.cuda.synchronize()
    assert pack_bits.launches == before + 1
    assert torch.equal(got, pack_bits_ref(bits))
    assert torch.equal(pack_bits(bits.bool()), got)


def test_wrappers_reject_mixed_devices(gen):
    a = _words(gen, 4, 3)
    with pytest.raises(ValueError):
        hamming_rows(a, a.cpu()[:, None, :].contiguous())
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
