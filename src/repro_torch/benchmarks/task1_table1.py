"""Paper Table 1: Task-1 recall@30 and search time over the submitted rows.

Counterpart of ``benchmarks/task1_table1.py``.  The grid is the paper's
own: the 16 rows of ``repro_torch.configs.pubmed23.TABLE1`` at
``TABLE1_TREES`` (8 rows at 160 trees, 8 at 120), each index built once
per tree count with the PUBMED23 forest (``leaf_size`` 100, 448-bit keys)
and ``store_points=False``.  Per row it reports n, k1, k2, h, recall@30
against exact neighbours, search time per query (the median of
``timed_searches``, by default ``TIMED_SEARCHES``, host-clocked,
synchronized ``search`` calls of every query after one warm-up search per
built index; each run's time is returned too), the build time of its tree count and the peak device
memory of the build and search (not measured on the CPU).  The check is the JAX module's: the best row's recall@30
exceeds 0.7.

Without data the module draws the JAX module's 20,000 x 384 points and
500 queries (``lowrank_dataset_with_queries``, seed 0) and their exact
neighbours, so it runs on the CPU too (``device="cpu"``); ``points``,
``queries`` and ``truth`` (exact top-30 ids per query) let a caller run
it on its own data.

    python -m repro_torch.benchmarks.task1_table1 [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import pubmed23
from repro_torch.data import ann_datasets
from repro_torch.index import HilbertIndex, IndexConfig, SearchParams

__all__ = ["main", "GRID", "RECALL_FLOOR"]

N, D, Q = 20000, 384, 500
K = 30
TIMED_SEARCHES = 3  # per row; the row's ms/query is their median
RECALL_FLOOR = 0.7  # the challenge's recall@30 target

# (n_trees, k1, k2, h) of every row of the paper's Table 1.
GRID: List[Tuple[int, int, int, int]] = [
    (n, p.k1, p.k2, p.h) for n, p in zip(pubmed23.TABLE1_TREES, pubmed23.TABLE1)]


def _device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("task1_table1 runs on CUDA by default and no GPU is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(rows: Optional[Sequence[Tuple[int, int, int, int]]] = None, *,
         points=None, queries=None, truth=None, device: str = "cuda",
         timed_searches: int = TIMED_SEARCHES) -> List[Dict]:
    """Build, search and score every ``(n_trees, k1, k2, h)`` of ``rows``
    (default: :data:`GRID`); print a CSV line per row and return the rows.

    Raises if the best row's recall@30 does not exceed :data:`RECALL_FLOOR`.
    """
    dev = _device(device)
    if points is None:
        data, qs = ann_datasets.lowrank_dataset_with_queries(N, Q, D, n_clusters=64,
                                                             seed=0)
        truth, _ = ann_datasets.exact_knn(data, qs, K)
        points, queries = torch.from_numpy(data), torch.from_numpy(qs)
    points = torch.as_tensor(points, dtype=torch.float32, device=dev)
    queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    truth = np.asarray(torch.as_tensor(truth).cpu())
    nq = queries.shape[0]
    on_card = dev.type == "cuda"

    def peak_gib():
        return torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else None

    built: Dict[int, Tuple[HilbertIndex, float, Optional[float]]] = {}
    out = []
    print("n,k1,k2,h,recall@30,search_ms_per_query,build_s,peak_gib")
    for n_trees, k1, k2, h in rows or GRID:
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        if n_trees not in built:
            built.clear()  # one forest on the device at a time
            index = None
            cfg = IndexConfig(forest=dataclasses.replace(pubmed23.FOREST,
                                                         n_trees=n_trees),
                              store_points=False)
            _sync(dev)
            t0 = time.perf_counter()
            index = HilbertIndex.build(points, cfg, device=dev)
            _sync(dev)
            built[n_trees] = (index, time.perf_counter() - t0, peak_gib())
            index.search(queries, SearchParams(k1=k1, k2=k2, h=h, k=K))  # warm-up
        index, build_s, build_peak = built[n_trees]
        params = SearchParams(k1=k1, k2=k2, h=h, k=K)
        times = []
        for _ in range(timed_searches):
            _sync(dev)
            t0 = time.perf_counter()
            ids, _ = index.search(queries, params)
            _sync(dev)
            times.append(time.perf_counter() - t0)
        runs_ms = [t * 1e3 / nq for t in times]
        rec = ann_datasets.recall_at_k(ids.cpu().numpy(), truth)
        peak = None if not on_card else max(peak_gib(), build_peak or 0.0)
        row = {"n_trees": n_trees, "k1": k1, "k2": k2, "h": h, "recall_at_30": rec,
               "search_ms_per_query": float(np.median(runs_ms)), "build_s": build_s,
               "peak_gib": peak, "search_ms_per_query_runs": runs_ms}
        print(",".join("not measured" if v is None else str(v)
                       for v in list(row.values())[:-1]), flush=True)
        out.append(row)
    best = max(r["recall_at_30"] for r in out)
    if not best > RECALL_FLOOR:
        raise AssertionError(f"best recall@30 {best} does not exceed {RECALL_FLOOR}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
