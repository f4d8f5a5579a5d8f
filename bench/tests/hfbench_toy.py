"""A toy checkout for the harness's CPU tests: the real ``bench/`` and
``BENCHMARK.json`` plus a toy configuration, toy traffic and toy cells added
as files only."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TOY_CONFIG = {
    "name": "toy", "source": "a toy deployment for the CPU tests",
    "rows": 3000, "dim": 32, "n_trees": 6, "bits": 4, "key_bits": 64,
    "leaf_size": 20, "forest_seed": 0, "quant_bits": 4, "sample_limit": 1000,
    "store_points": True,
    "graph": {"n_orders": 5, "k1": 16, "k2": 12, "k": 5, "seed": 0},
    "reduced": {}, "assumed": {"n_clusters": 8, "intrinsic_rank": 4, "noise": 0.9},
}
TOY_TRAFFIC = {
    "search": {"kind": "search", "batch": 64, "pool_batches": 3, "warm_queries": 64,
               "k1": 40, "k2": 30, "h": 2, "k": 10},
    "graph": {"kind": "graph"},
    "build": {"kind": "build"},
}
TOY_CELLS = {
    "toy.search": {"sample": 100, "limits": {"id_miss": 0.002, "dist_gap": 1e-4}},
    "toy.graph": {"sample": 300, "limits": {"id_miss": 0.002, "dist_gap": 1e-4}},
    "toy.build": {"limits": {"quant": 0, "codes": 0, "forest": 0, "master": 0}},
}


def make_toy_root(tmp: Path) -> Path:
    """A checkout holding the real ``bench/`` and ``BENCHMARK.json`` plus a toy
    configuration ``toy``, toy traffic files and cells ``toy.<kind>`` added
    as files only."""
    root = tmp / "checkout"
    shutil.copytree(REPO / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "bench" / "configs" / "toy.json").write_text(json.dumps(TOY_CONFIG))
    for kind, tr in TOY_TRAFFIC.items():
        (root / "bench" / "traffic" / f"toy_{kind}.json").write_text(json.dumps(tr))
        bench["workloads"].append({"name": f"toy.{kind}", "config": "toy",
                                   "traffic": f"toy_{kind}", "chips": 1, "why": "toy"})
    for name, cell in TOY_CELLS.items():
        (root / "bench" / "cells" / f"{name}.json").write_text(json.dumps(cell))
    kinds = {"search": "search_qps", "graph": "rows_per_s", "build": "rows_per_s"}
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"] += [f"toy.{k}" for k, v in kinds.items() if v == m["name"]]
    for m in bench["per_layer"]:
        kind = m["name"].rsplit(".", 1)[1]
        m["workloads"].append(f"toy.{kind}")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
