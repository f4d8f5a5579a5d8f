"""A run with the timed path broken underneath: ``correct`` comes out false.

Each fault is planted in the program (by patching one of its functions for
the run) where its answers are produced; the rest of the run, the check
included, is the benchmark's own.  The cells run on one card, so there is
no exchange between cards to leave out.
"""

from __future__ import annotations

import time

import pytest
import torch

import repro_torch.core.forest as forest_mod
import repro_torch.core.hilbert as hilbert_mod
import repro_torch.core.knn_graph as graph_mod
import repro_torch.core.quantize as quant_mod
import repro_torch.core.search as search_mod
import repro_torch.index.facade as facade_mod
from hfbench import runner


def _unchanged_tree(queries, qsk, best_pos, best_dist, *a, **k):
    return best_pos, best_dist  # stage 1 returns its state unchanged


def _half_search(orig):
    def search(self, queries, *a, **k):
        ids, d = orig(self, queries, *a, **k)
        half = queries.shape[0] // 2  # the second half is left out: the first repeated
        ids[half : 2 * half], d[half : 2 * half] = ids[:half], d[:half]
        return ids, d
    return search


def _altered_stage2(orig):
    def stage2(*a, **k):
        ids, d = orig(*a, **k)
        ids = ids.clone()
        ids[:, 0] = (ids[:, 0] + 1) % 3000  # the nearest id altered where it is produced
        return ids, d
    return stage2


def _unchanged_merge(best_id, best_dist, *a, **k):
    return best_id, best_dist


def _half_graph(orig):
    def knn_graph(self, *a, **k):
        ids, d = orig(self, *a, **k)
        half = ids.shape[0] // 2
        ids[half:], d[half:] = ids[:half][: ids.shape[0] - half], d[:half][: ids.shape[0] - half]
        return ids, d
    return knn_graph


def _altered_select(orig):
    def select(*a, **k):
        ids, d = orig(*a, **k)
        return torch.where(ids >= 0, (ids + 1) % 3000, ids), d
    return select


def _unchanged_sort(points, **k):
    n = points.shape[0]
    keys = hilbert_mod.hilbert_keys(points, **k)
    return torch.arange(n, dtype=torch.int32, device=points.device), keys


def _half_encode(orig):
    def encode(quant, x):
        out = orig(quant, x)
        out[x.shape[0] // 2 :] = 0  # the second half of the rows left out
        return out
    return encode


def _altered_forest(orig):
    def build_forest(points, cfg):
        f = orig(points, cfg)
        orders = f.orders.clone()
        orders[:, [0, 1]] = orders[:, [1, 0]]
        return f._replace(orders=orders)
    return build_forest


FAULTS = {
    "search": {
        "state_unchanged": (search_mod, "stage1_tree_merge", lambda o: _unchanged_tree),
        "half_left_out": (facade_mod.HilbertIndex, "search", _half_search),
        "answer_altered": (search_mod, "stage2_packed_windows", _altered_stage2),
    },
    "graph": {
        "state_unchanged": (graph_mod, "merge_order", lambda o: _unchanged_merge),
        "half_left_out": (facade_mod.HilbertIndex, "knn_graph", _half_graph),
        "answer_altered": (graph_mod, "final_select_chunk", _altered_select),
    },
    "build": {
        "state_unchanged": (hilbert_mod, "hilbert_sort", lambda o: _unchanged_sort),
        "half_left_out": (quant_mod, "encode", _half_encode),
        "answer_altered": (forest_mod, "build_forest", _altered_forest),
    },
}
CASES = [(kind, fault) for kind, faults in FAULTS.items() for fault in faults]


@pytest.mark.parametrize("kind,fault", CASES, ids=[f"{k}-{f}" for k, f in CASES])
def test_broken_timed_path_reads_not_correct(toy_root, monkeypatch, kind, fault):
    owner, name, make = FAULTS[kind][fault]
    monkeypatch.setattr(owner, name, make(getattr(owner, name)))
    r = runner.run(toy_root, f"toy.{kind}", 2**31 + 23, 0.1, False, torch.device("cpu"),
                   time.perf_counter())
    assert r["correct"] is False, r["checks"]
