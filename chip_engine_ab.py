#!/usr/bin/env python3
"""The serving engine's launch lock, on and off, on one NVIDIA GPU.

Runs ``chip_smoke.phase_engine`` (the ``RetrievalEngine`` phase at full
width: 2,500,000 bulk rows, two serve threads, four clients, a writer and
background compaction) several times on the same points, with the
engine's one-at-a-time launch lock in place (``on``) or replaced by a
no-op (``off``), in the order given by ``--order`` (default
``on,off,off,on``: each setting once early and once late). The last line
is a JSON summary of the baseline and churn windows of each run; a run
whose checks fail is reported there with its error, the others still
run, and the exit code is 1.

    python3 chip_engine_ab.py [--order on,off,off,on] [--n 3000000]
"""

from __future__ import annotations

import argparse
import gc
import os
import sys
import time

import chip_smoke as smoke


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--order", default="on,off,off,on",
                    help="comma-separated launch-lock settings, one run each")
    ap.add_argument("--n", type=int, default=3_000_000, help="corpus rows")
    ap.add_argument("--queries", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    order = [s.strip() for s in args.order.split(",")]
    if not order or set(order) - {"on", "off"}:
        ap.error("--order takes 'on' and 'off' only")

    import torch

    if not torch.cuda.is_available():
        print("chip_engine_ab: no CUDA device; nothing run", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(smoke.SRC, "repro_torch")):
        print(f"chip_engine_ab: {smoke.SRC}/repro_torch missing; run from a "
              "checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, smoke.SRC)
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.index import ForestConfig, IndexConfig, SearchParams
    from repro_torch.kernels import _build

    cfg = IndexConfig(
        forest=ForestConfig(n_trees=16, bits=4, key_bits=448, leaf_size=32),
        store_points=True, seal_pow2=True,
    )
    params = SearchParams(k1=48, k2=384, h=2, k=30)
    smoke.phase_device()
    smoke.phase_build(_build)
    points, queries = smoke.phase_data(torch, args.n, args.queries, args.seed)
    windows = []
    inner_emit = smoke.emit

    def emit(obj):  # keep each window's statistics, even of a failed run
        if obj.get("phase") == "engine_window":
            windows.append(obj)
        inner_emit(obj)

    smoke.emit = emit
    runs = []
    for setting in order:
        t0 = time.perf_counter()
        windows.clear()
        row = {"launch_lock": setting, "error": None}
        try:
            smoke.phase_engine(torch, cfg, params, points, queries, args.seed,
                               launch_lock=setting == "on")
        except Exception as e:  # reported in the summary; the exit code is 1
            row["error"] = repr(e)
        row["phase_s"] = time.perf_counter() - t0
        for w in windows:
            if w["window"] in ("baseline", "churn_maintained"):
                row[w["window"]] = {k: w[k] for k in (
                    "requests", "seconds", "qps", "requests_per_s", "request_ms",
                    "search_ms", "swaps", "overlap_batch_ms", "writes",
                    "last_swap_timeline")}
        runs.append(row)
        gc.collect()  # a failed run's engine sits in reference cycles
        torch.cuda.empty_cache()
    inner_emit({"engine_ab": runs, "n": args.n})
    return 1 if any(r["error"] for r in runs) else 0


if __name__ == "__main__":
    sys.exit(main())
