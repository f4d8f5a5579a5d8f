"""Shared inputs of the port's serving-layer parity tests.

Both packages get the same numpy inputs and, for indexes, the same bundle:
``repro`` builds and saves it, and each package loads it
(``repro_torch`` on the CPU).  Float results are held to the contract of
``tests/test_kernels_integration.py``.
"""

import numpy as np
import torch

from repro.core.types import ForestConfig as JForestConfig
from repro.core.types import SearchParams as JSearchParams
from repro.index import HilbertIndex as JIndex
from repro.index import IndexConfig as JIndexConfig
from repro.index import MutableHilbertIndex as JMutable
from repro_torch.data import ann_datasets
from repro_torch.index import (ForestConfig, HilbertIndex, IndexConfig,
                               MutableHilbertIndex, SearchParams)
from test_kernels_integration import (DIST_ATOL, DIST_RTOL,
                                      _assert_ids_equal_up_to_distance_ties)

N, D, Q = 2000, 32, 48
FOREST = dict(n_trees=4, bits=4, key_bits=128, leaf_size=16, seed=0)
SPD = dict(k1=16, k2=64, h=1, k=10)
JCFG = JIndexConfig(forest=JForestConfig(**FOREST), query_chunk=16)
TCFG = IndexConfig(forest=ForestConfig(**FOREST), query_chunk=16)
JSP, TSP = JSearchParams(**SPD), SearchParams(**SPD)


def dataset():
    """(data (N, D), queries (Q, D)) float32, queries off the point set."""
    return ann_datasets.lowrank_dataset_with_queries(N, Q, D, n_clusters=8, seed=0)


def static_pair(path, data):
    """A ``repro`` static index saved at ``path``, loaded in both packages."""
    JIndex.build(data, JCFG).save(path)
    return JIndex.load(path), HilbertIndex.load(path, device="cpu")


def mutable_pair(path, data, n=1500, deletes=True, buffer_capacity=256,
                 max_segments=8):
    """A streamed ``repro`` mutable index (segments, buffer rows and
    tombstones) saved at ``path``, loaded in both packages."""
    jm = JMutable(JCFG, buffer_capacity=buffer_capacity, max_segments=max_segments)
    ids = jm.insert(data[:n])
    if deletes:
        jm.delete(ids[::7])
    jm.save(path)
    return JMutable.load(path), MutableHilbertIndex.load(path, device="cpu")


def host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_within_contract(jids, jd, tids, td):
    """Port results against ``repro``'s: distances within DIST_RTOL /
    DIST_ATOL, ids equal except inside runs of tied distances."""
    jids, jd, tids, td = host(jids), host(jd), host(tids), host(td)
    assert jids.shape == tids.shape and jd.shape == td.shape
    np.testing.assert_allclose(td, jd, rtol=DIST_RTOL, atol=DIST_ATOL)
    _assert_ids_equal_up_to_distance_ties(jids, tids, jd)
