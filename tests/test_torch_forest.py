"""Port parity: Hilbert forest build and per-tree candidates against repro."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import forest as jf
from repro.core.types import ForestConfig as JForestConfig
from repro_torch.core import forest as tf
from repro_torch.core.types import ForestConfig
from repro_torch.data import ann_datasets as tdata


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize("d,n_trees,key_bits,leaf_size,k1", [
    (64, 4, 128, 16, 16),
    (384, 2, 448, 32, 48),
])
def test_build_forest_and_tree_candidates_bit_equal(d, n_trees, key_bits,
                                                    leaf_size, k1):
    data, queries = tdata.lowrank_dataset_with_queries(3000, 40, d, n_clusters=8,
                                                       r=4, seed=3)
    kw = dict(n_trees=n_trees, bits=4, key_bits=key_bits, leaf_size=leaf_size, seed=2)
    jforest = jf.build_forest(jnp.asarray(data), JForestConfig(**kw))
    tforest = tf.build_forest(torch.from_numpy(data), ForestConfig(**kw))

    jp, jfl = jf.forest_randomization(JForestConfig(**kw), d)
    tp, tfl = tf.forest_randomization(ForestConfig(**kw), d)
    np.testing.assert_array_equal(jp, tp)
    np.testing.assert_array_equal(jfl, tfl)
    for name in ("perms", "flips", "orders", "directories", "lo", "hi"):
        want, got = np.asarray(getattr(jforest, name)), getattr(tforest, name).numpy()
        assert want.shape == got.shape, name
        if want.dtype == np.bool_:
            np.testing.assert_array_equal(want, got, err_msg=name)
        else:
            np.testing.assert_array_equal(_bits(want), _bits(got), err_msg=name)
    assert tforest.n_trees == n_trees and tforest.n_points == 3000
    assert tforest.memory_bytes() == jforest.memory_bytes()

    for t in range(n_trees):
        common = dict(bits=4, key_bits=key_bits, leaf_size=leaf_size, k1=k1)
        want = jf.tree_candidates(
            jnp.asarray(queries), jforest.orders[t], jforest.directories[t],
            jforest.lo, jforest.hi, jforest.perms[t], jforest.flips[t], **common)
        got = tf.tree_candidates(
            torch.from_numpy(queries), tforest.orders[t], tforest.directories[t],
            tforest.lo, tforest.hi, tforest.perms[t], tforest.flips[t], **common)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_tree_candidates_at_the_edges():
    # Queries outside the data range land before the first / after the last
    # directory key; n a multiple of leaf_size exercises the clamped probe.
    data = tdata.lowrank_embeddings(256, 8, n_clusters=4, r=3, seed=6)
    queries = np.concatenate([data[:3] * 50.0, -data[:3] * 50.0, data[3:6]])
    kw = dict(n_trees=2, bits=4, key_bits=32, leaf_size=16, seed=1)
    jforest = jf.build_forest(jnp.asarray(data), JForestConfig(**kw))
    tforest = tf.build_forest(torch.from_numpy(data), ForestConfig(**kw))
    for t in range(2):
        for k1 in (8, 300):
            common = dict(bits=4, key_bits=32, leaf_size=16, k1=k1)
            want = jf.tree_candidates(
                jnp.asarray(queries), jforest.orders[t], jforest.directories[t],
                jforest.lo, jforest.hi, jforest.perms[t], jforest.flips[t], **common)
            got = tf.tree_candidates(
                torch.from_numpy(queries), tforest.orders[t],
                tforest.directories[t], tforest.lo, tforest.hi,
                tforest.perms[t], tforest.flips[t], **common)
            np.testing.assert_array_equal(np.asarray(want), got.numpy())
