"""Port parity: the plain versions of the Hopper kernels against repro.

``hamming_rows_ref`` must equal the JAX ``hamming_rows`` exactly, in both
its interpret-mode Pallas kernel and its oracle, and so must
``pack_bits_ref`` the JAX ``pack_bits``; ``qdist_windows_ref`` must agree
with ``qdist_windows_from_packed`` (interpret-mode kernel and oracle)
within the repo's distance contract.  On CPU tensors the wrappers
take the plain versions and launch nothing; the kernels themselves run in
``tests/test_torch_cuda.py`` on a GPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bitpack import pack_bits as j_pack_bits
from repro.kernels.hamming import hamming_rows as j_hamming_rows
from repro.kernels.qdist import qdist_windows_from_packed
from repro_torch.kernels import _build
from repro_torch.kernels.bitpack import pack_bits, pack_bits_ref
from repro_torch.kernels.hamming import hamming_rows, hamming_rows_ref
from repro_torch.kernels.qdist import qdist_windows, qdist_windows_ref
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
