"""Port parity: the benchmark modules of ``repro_torch`` and their config.

``repro_torch.configs.pubmed23`` is a copy of ``repro.configs.pubmed23``;
``repro_torch.benchmarks.kernel_bench`` counts the bytes each of its
kernels reads and writes; a Table-1 row of
``repro_torch.benchmarks.task1_table1`` scores the ids that ``repro``'s
``HilbertIndex.search`` gives for the same config (both packages search
one bundle that ``repro`` built and saved).
"""

import dataclasses

import numpy as np
import pytest

from repro.configs import pubmed23 as jpubmed23
from repro.core.types import ForestConfig as JForestConfig
from repro.core.types import SearchParams as JSearchParams
from repro.index import HilbertIndex as JIndex
from repro.index import IndexConfig as JIndexConfig
from repro_torch.benchmarks import kernel_bench, task1_table1
from repro_torch.configs import pubmed23
from repro_torch.data import ann_datasets
from repro_torch.index import HilbertIndex, SearchParams
from _torch_parity import assert_within_contract, host


def test_pubmed23_config_equals_repro():
    for name in ("N_POINTS", "DIM"):
        assert getattr(pubmed23, name) == getattr(jpubmed23, name)
    for name in ("FOREST", "QUANT"):
        assert (dataclasses.asdict(getattr(pubmed23, name))
                == dataclasses.asdict(getattr(jpubmed23, name)))
    assert ([dataclasses.asdict(p) for p in pubmed23.TABLE1]
            == [dataclasses.asdict(p) for p in jpubmed23.TABLE1])
    assert pubmed23.TABLE1_TREES == jpubmed23.TABLE1_TREES
    for n in (160, 120, 1):
        assert pubmed23.memory_budget_bytes(n) == jpubmed23.memory_budget_bytes(n)
    assert task1_table1.GRID == [(n, p.k1, p.k2, p.h) for n, p in
                                 zip(jpubmed23.TABLE1_TREES, jpubmed23.TABLE1)]


def test_kernel_bench_counts_the_bytes_each_kernel_moves(capsys):
    (q, c, w), (cq, cc, d) = (5, 70, 3), (6, 33, 61)
    rows = kernel_bench.main("cpu", hamming_shape=(q, c, w), qdist_shape=(cq, cc, d))
    words = -(-d // 8)
    common = cq * d * 4 + d * 16 * 4 + cq * cc * 4  # queries, centroids, output
    want = {
        f"hamming_{q}x{c}x{32 * w}b": ((q * w + c * w + q * c) * 4, 3 * q * c * w),
        f"qdist_u8_{cq}x{cc}x{d}": (common + cc * d, 3 * cq * cc * d),  # a byte a dim
        f"qdist_packed_{cq}x{cc}x{d}": (common + cc * words * 4, 3 * cq * cc * d),
    }
    assert [r["name"] for r in rows] == list(want)
    for r in rows:
        n_bytes, n_ops = want[r["name"]]
        assert (r["bytes_per_call"], r["ops_per_call"]) == (n_bytes, n_ops)
        assert (r["bound_ms"], r["bound_by"]) == kernel_bench.bound(n_bytes, n_ops)
        # no device on the CPU: nothing is timed
        assert r["device_ms"] is r["plain_ms"] is r["library_ms"] is None
        assert r["max_abs_err"] == 0.0
    out = capsys.readouterr().out
    assert out.splitlines()[0] == ",".join(kernel_bench.COLUMNS)
    assert "kernel_vs_plain_check,ok" in out and "not measured" in out


def test_kernel_bench_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(kernel_bench.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kernel_bench.main()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        task1_table1.main()


def test_table1_row_scores_the_ids_repro_searches(tmp_path):
    """One small row: the port's recall is that of the ids its own search
    of ``repro``'s bundle gives, and those equal ``repro``'s up to ties."""
    n_trees, k1, k2, h = row = (4, 96, 192, 2)
    data, queries = ann_datasets.lowrank_dataset_with_queries(3000, 40, 384,
                                                              n_clusters=16, seed=0)
    truth, _ = ann_datasets.exact_knn(data, queries, 30)
    (got,) = task1_table1.main([row], points=data, queries=queries, truth=truth,
                               device="cpu")
    assert got["peak_gib"] is None and got["search_ms_per_query"] > 0
    runs = got["search_ms_per_query_runs"]
    assert len(runs) == task1_table1.TIMED_SEARCHES
    assert got["search_ms_per_query"] == float(np.median(runs))

    forest = dataclasses.replace(jpubmed23.FOREST, n_trees=n_trees)
    JIndex.build(data, JIndexConfig(forest=JForestConfig(**dataclasses.asdict(forest)),
                                    store_points=False)).save(str(tmp_path))
    jids, jd = JIndex.load(str(tmp_path)).search(
        queries, JSearchParams(k1=k1, k2=k2, h=h, k=30))
    tindex = HilbertIndex.load(str(tmp_path), device="cpu")
    assert tindex.config.forest == dataclasses.replace(pubmed23.FOREST, n_trees=n_trees)
    tids, td = tindex.search(queries, SearchParams(k1=k1, k2=k2, h=h, k=30))
    assert_within_contract(jids, jd, tids, td)
    assert got["recall_at_30"] == ann_datasets.recall_at_k(host(tids), truth)
    # each id swapped inside a run of ties moves recall by at most one hit
    swapped = int((host(tids) != np.asarray(jids)).sum())
    jrecall = ann_datasets.recall_at_k(np.asarray(jids), truth)
    assert abs(got["recall_at_30"] - jrecall) <= swapped / truth.size
    assert got["recall_at_30"] > task1_table1.RECALL_FLOOR
