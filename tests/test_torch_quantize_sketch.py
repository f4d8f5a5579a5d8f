"""Port parity: quantizer, sketches and configs of repro_torch against repro.

The same numpy inputs go through the JAX function and its port; integer
outputs (codes, packed codes, sketches, Hamming distances) and the fitted
grid must be bit-equal, ADC distances within the repo's distance contract.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jq
from repro.core import sketch as jsk
from repro.data import ann_datasets as jdata
from repro.index.config import IndexConfig as JIndexConfig
from repro_torch.core import quantize as tq
from repro_torch.core import sketch as tsk
from repro_torch.data import ann_datasets as tdata
from repro_torch.index import ForestConfig, IndexConfig, QuantizerConfig
from test_kernels_integration import DIST_ATOL, DIST_RTOL


def _bits(a) -> np.ndarray:
    """Raw 32-bit patterns of a float32/int32/uint32 array or tensor."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize("n,d,sample_limit", [
    (3000, 64, 262144), (3000, 384, 262144), (3001, 64, 1000),
])
def test_fit_encode_pack_sketch_bit_equal(n, d, sample_limit):
    x = tdata.lowrank_embeddings(n, d, n_clusters=8, r=4, seed=1)
    jquant = jq.fit(jnp.asarray(x), bits=4, sample_limit=sample_limit)
    tquant = tq.fit(torch.from_numpy(x), bits=4, sample_limit=sample_limit)
    np.testing.assert_array_equal(_bits(jquant.boundaries), _bits(tquant.boundaries))
    np.testing.assert_array_equal(_bits(jquant.centroids), _bits(tquant.centroids))
    assert tquant.bits == jquant.bits == 4

    xt = torch.from_numpy(x)
    jcodes = np.asarray(jq.encode(jquant, jnp.asarray(x)))
    tcodes = tq.encode(tquant, xt)
    assert tcodes.dtype == torch.uint8
    np.testing.assert_array_equal(jcodes, tcodes.numpy())

    tpacked = tq.pack_codes(tcodes)
    np.testing.assert_array_equal(
        _bits(jq.pack_codes(jnp.asarray(jcodes))), _bits(tpacked))
    np.testing.assert_array_equal(tq.unpack_codes(tpacked, d).numpy(), jcodes)

    np.testing.assert_array_equal(
        _bits(jsk.make_sketches(jquant, jnp.asarray(x))),
        _bits(tsk.make_sketches(tquant, xt)))
    np.testing.assert_array_equal(
        _bits(jsk.sketches_from_codes(jnp.asarray(jcodes))),
        _bits(tsk.sketches_from_codes(tcodes)))
    np.testing.assert_array_equal(
        _bits(jq.decode(jquant, jnp.asarray(jcodes))),
        _bits(tq.decode(tquant, tcodes)))


@pytest.mark.parametrize("d", [64, 61, 384])
def test_adc_distance_within_contract(d):
    rng = np.random.default_rng(d)
    x = tdata.lowrank_embeddings(2000, d, n_clusters=8, r=4, seed=2)
    jquant = jq.fit(jnp.asarray(x))
    tquant = tq.fit(torch.from_numpy(x))
    queries = rng.normal(size=(5, d)).astype(np.float32)
    codes = rng.integers(0, 16, size=(5, 40, d), dtype=np.uint8)
    want = np.asarray(jq.adc_distance(jquant, jnp.asarray(queries), jnp.asarray(codes)))
    got = tq.adc_distance(tquant, torch.from_numpy(queries), torch.from_numpy(codes))
    np.testing.assert_allclose(got.numpy(), want, rtol=DIST_RTOL, atol=DIST_ATOL)
    packed = tq.pack_codes(torch.from_numpy(codes.reshape(-1, d))).reshape(5, 40, -1)
    want_p = np.asarray(jq.adc_distance_packed(
        jquant, jnp.asarray(queries), jnp.asarray(_bits(packed)), d=d))
    got_p = tq.adc_distance_packed(tquant, torch.from_numpy(queries), packed, d=d)
    np.testing.assert_allclose(got_p.numpy(), want_p, rtol=DIST_RTOL, atol=DIST_ATOL)


def test_hamming_distance_and_popcount_bit_equal():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2**32, size=(9, 12), dtype=np.uint32)
    b = rng.integers(0, 2**32, size=(9, 7, 12), dtype=np.uint32)
    a[0, :] = 0xFFFFFFFF
    b[0, 0, :] = 0
    want = np.asarray(jsk.hamming_distance(jnp.asarray(a)[:, None, :], jnp.asarray(b)))
    got = tsk.hamming_distance(torch.from_numpy(a.view(np.int32))[:, None, :],
                               torch.from_numpy(b.view(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    words = torch.from_numpy(a.view(np.int32))
    np.testing.assert_array_equal(
        tsk.popcount32(words).numpy(),
        np.unpackbits(a.view(np.uint8), axis=-1).reshape(9, 12, 32).sum(-1))


def test_synthetic_data_copy_matches():
    jd, jqs = jdata.lowrank_dataset_with_queries(500, 7, 32, n_clusters=4, r=3, seed=5)
    td, tqs = tdata.lowrank_dataset_with_queries(500, 7, 32, n_clusters=4, r=3, seed=5)
    np.testing.assert_array_equal(_bits(jd), _bits(td))
    np.testing.assert_array_equal(_bits(jqs), _bits(tqs))
    ids, dists = tdata.exact_knn(td, tqs, 5)
    jids, jdists = jdata.exact_knn(jd, jqs, 5)
    np.testing.assert_array_equal(ids, jids)
    assert tdata.recall_at_k(ids, jids) == 1.0


def test_lowrank_torch_generator_distribution():
    g = torch.Generator().manual_seed(0)
    x = tdata.lowrank_embeddings_torch(3000, 64, generator=g, chunk=1000)
    assert x.shape == (3000, 64) and x.dtype == torch.float32
    np.testing.assert_allclose(torch.linalg.vector_norm(x, dim=1).numpy(), 1.0,
                               rtol=1e-5)
    # Clustered like the numpy version: most nearest neighbours are close.
    nn_cos = (x[:500] @ x.T).topk(2, dim=1).values[:, 1]
    ref = tdata.lowrank_embeddings(3000, 64, seed=0)
    ref_cos = np.sort(ref[:500] @ ref.T, axis=1)[:, -2]
    assert abs(float(nn_cos.median()) - float(np.median(ref_cos))) < 0.05


def test_config_round_trips_between_packages():
    cfg = IndexConfig(forest=ForestConfig(n_trees=3, bits=5, key_bits=64,
                                          leaf_size=7, seed=9),
                      quantizer=QuantizerConfig(sample_limit=1234),
                      store_points=False, query_chunk=64, shards=2)
    jcfg = JIndexConfig.from_dict(cfg.to_dict())
    assert jcfg.to_dict() == cfg.to_dict()
    assert IndexConfig.from_dict(jcfg.to_dict()) == cfg
    assert IndexConfig.from_dict(JIndexConfig().to_dict()) == IndexConfig()
