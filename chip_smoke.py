#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Builds the CUDA kernels from ``src/repro_torch/csrc`` with nvcc, holds each
against its plain PyTorch version at the search path's shapes, checks that
a build on the card is bit-equal to a build on the CPU, then drives the main
path at full width — ``HilbertIndex.build`` of 3,000,000 x 384 points with
the README quickstart configuration and ``.search`` of 8192 queries — and
checks recall@30 against exact ground truth, the kernel route against the
plain route, and save -> load -> search bit-equality.

Each phase prints one JSON line; the line before the last is the kernel
table, the last line is ``{"ok": true, "device": {...}}``.  Any failure
raises and the script exits non-zero.  Without a GPU, or run from a
directory without ``src/repro_torch``, it prints no result and exits 2.

    python3 chip_smoke.py [--n 3000000] [--queries 8192] [--seed 0]
                          [--recall-floor 0.50]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# Published peaks of one H100 SXM (dense, at its 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# Distance contract of tests/test_kernels_integration.py.
DIST_RTOL = 1e-5
DIST_ATOL = 1e-6
TIE_ATOL = 1e-4

# recall@30 floor of the full-width run at --seed 0: the first full run on
# an H100 measured 0.5327 (PERF.md); the margin covers another torch
# release drawing other random numbers from the same seed.
RECALL_FLOOR = 0.50

KERNEL_REPS = 20  # timed runs per kernel (after warm-up)
PARITY_ROWS = 20_000  # rows of the cuda-vs-cpu build check


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by) from bytes over HBM rate and ops over fp32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def median_ms(torch, fn, reps: int) -> float:
    """Median device time of ``fn()`` over ``reps`` back-to-back runs.

    After two warm-up calls the stream is held busy by a spin kernel while
    the host enqueues ``reps`` runs with a CUDA event between each, so the
    events see device time and not the host's launch latency.
    """
    fn()
    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(20_000_000)
    events[0].record()
    for i in range(reps):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    times = sorted(events[i].elapsed_time(events[i + 1]) for i in range(reps))
    return times[len(times) // 2]


def assert_ids_equal_up_to_ties(ids_ref, ids_got, d_ref) -> int:
    """Mismatched ids must sit inside a run of reference distances tied
    within TIE_ATOL.  Returns the number of mismatched positions."""
    import numpy as np

    ids_ref, ids_got, d_ref = (np.asarray(a) for a in (ids_ref, ids_got, d_ref))
    rows, cols = np.nonzero(ids_ref != ids_got)
    for r, c in zip(rows, cols):
        tied = np.isclose(d_ref[r], d_ref[r, c], atol=TIE_ATOL)
        if ids_got[r, c] not in set(ids_ref[r, tied].tolist()):
            raise AssertionError(
                f"row {r} col {c}: id {ids_got[r, c]} not among ids tied at "
                f"{d_ref[r, c]} (reference id {ids_ref[r, c]})")
    return len(rows)


def phase_device():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(out, flush=True)


def phase_build(build_mod):
    t0 = time.perf_counter()
    per_source = build_mod.build()
    seconds = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in build_mod.build_log(name).splitlines()
               if "registers" in ln or "spill" in ln]
        for name in build_mod.SOURCES
    }
    emit({"phase": "build", "seconds": seconds, "per_source": per_source,
          "ptxas": ptxas})


def phase_kernel_parity(torch, reps: int):
    from repro_torch.kernels.hamming import hamming_rows, hamming_rows_ref
    from repro_torch.kernels.qdist import qdist_windows, qdist_windows_ref

    g = torch.Generator(device="cuda").manual_seed(1234)
    dev = "cuda"

    def words(*shape):
        return torch.randint(-(2**31), 2**31, shape, generator=g, device=dev,
                             dtype=torch.int32)

    rows = []
    # --- hamming_rows: exact --------------------------------------------
    ham = {}
    for qn, k, w in ((2048, 48, 12), (37, 33, 14)):
        a, c = words(qn, w), words(qn, k, w)
        got, ref = hamming_rows(a, c), hamming_rows_ref(a, c)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"hamming_rows != plain version at {(qn, k, w)}")
        ham[(qn, k, w)] = (a, c, got, ref)
    a, c, got, ref = ham[(2048, 48, 12)]
    qn, k, w = 2048, 48, 12
    ms = median_ms(torch, lambda: hamming_rows(a, c), reps)
    plain_ms = median_ms(torch, lambda: hamming_rows_ref(a, c), reps)
    b_ms, b_by = bound((qn * w + qn * k * w + qn * k) * 4, 3 * qn * k * w)
    rows.append({
        "name": "hamming_rows", "route": "cuda",
        "source": "src/repro_torch/csrc/hamming_rows.cu",
        "replaces": "src/repro/kernels/hamming/kernel.py:83",
        "max_abs_err": float((got - ref).abs().max()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "shape": [qn, k, w],
    })
    emit({"phase": "kernel_parity", "kernel": "hamming_rows", "exact": True,
          "shapes": [list(s) for s in ham], **{x: rows[-1][x] for x in
          ("ms", "plain_ms", "bound_ms", "bound_by")}})

    # --- qdist_windows: rtol 1e-5, atol 1e-6 ------------------------------
    errs = {}
    keep = None
    for qn, c, d in ((2048, 1920, 384), (37, 333, 61)):
        w = -(-d // 8)
        q = torch.randn(qn, d, generator=g, device=dev)
        win = words(qn, c, w)
        cent = torch.sort(torch.randn(d, 16, generator=g, device=dev), dim=1).values
        got, ref = qdist_windows(q, win, cent), qdist_windows_ref(q, win, cent)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, rtol=DIST_RTOL, atol=DIST_ATOL)
        errs[(qn, c, d)] = float((got - ref).abs().max())
        if keep is None:
            keep = (q, win, cent, errs[(qn, c, d)])
        del got, ref
    q, win, cent, err = keep
    qn, c, d = 2048, 1920, 384
    w = -(-d // 8)
    ms = median_ms(torch, lambda: qdist_windows(q, win, cent), reps)
    plain_ms = median_ms(torch, lambda: qdist_windows_ref(q, win, cent), max(5, reps // 4))
    b_ms, b_by = bound((qn * d + qn * c * w + d * 16 + qn * c) * 4, 3 * qn * c * d)
    rows.append({
        "name": "qdist_windows", "route": "cuda",
        "source": "src/repro_torch/csrc/qdist_windows.cu",
        "replaces": "src/repro/kernels/qdist/kernel.py:179",
        "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "shape": [qn, c, d],
    })
    emit({"phase": "kernel_parity", "kernel": "qdist_windows",
          "rtol": DIST_RTOL, "atol": DIST_ATOL,
          "max_abs_err": {str(list(s)): e for s, e in errs.items()},
          **{x: rows[-1][x] for x in ("ms", "plain_ms", "bound_ms", "bound_by")}})
    del q, win, cent, keep
    torch.cuda.empty_cache()
    return rows


def phase_device_parity(torch, cfg, n: int, seed: int):
    import numpy as np

    from repro_torch.data import ann_datasets
    from repro_torch.index import HilbertIndex

    pts = ann_datasets.lowrank_embeddings(n, 384, seed=seed)
    t0 = time.perf_counter()
    gpu = HilbertIndex.build(pts, cfg, device="cuda").array_bundle()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = HilbertIndex.build(pts, cfg, device="cpu").array_bundle()
    t_cpu = time.perf_counter() - t0
    differ = sorted(k for k in cpu if not (
        cpu[k].dtype == gpu[k].dtype and np.array_equal(cpu[k], gpu[k])))
    emit({"phase": "device_parity", "n": n, "arrays": sorted(cpu),
          "differ": differ, "gpu_build_s": t_gpu, "cpu_build_s": t_cpu})
    if differ:
        raise AssertionError(f"cuda build differs from cpu build in {differ}")


def exact_topk(torch, points, queries, k: int):
    """Exact squared-L2 top-k ids by matmul over the corpus (a check only)."""
    chunk = max(1, min(512, 2**30 // points.shape[0]))  # <= 4 GiB of d2
    xsq = (points * points).sum(1)
    out = []
    for s in range(0, queries.shape[0], chunk):
        q = queries[s : s + chunk]
        d2 = xsq[None, :] - 2.0 * (q @ points.T) + (q * q).sum(1)[:, None]
        out.append(torch.topk(d2, k, dim=1, largest=False).indices)
        del d2
    return torch.cat(out)


def phase_profile(torch, index, queries, params, top: int = 12):
    """Device time by kernel over one warm search, and the device's busy share.

    The profiler's host overhead lengthens the wall time, so the busy share
    read here is a lower bound.
    """
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        index.search(queries, params)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    emit({"phase": "profile", "wall_ms": wall_ms, "device_ms": device_ms,
          "busy_share": device_ms / wall_ms if device_ms else None,
          "top": [{"ms": ms, "count": n, "name": k[:80]} for ms, n, k in rows[:top]]})


def phase_main_path(torch, cfg, params, n: int, nq: int, seed: int,
                    recall_floor: float):
    from repro_torch.data import ann_datasets
    from repro_torch.index import HilbertIndex, build_with_timings
    from repro_torch.kernels.hamming import hamming_rows
    from repro_torch.kernels.qdist import qdist_windows

    g = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    allpts = ann_datasets.lowrank_embeddings_torch(n + nq, 384, generator=g)
    torch.cuda.synchronize()
    points, queries = allpts[:n], allpts[n:]
    emit({"phase": "data", "n": n, "queries": nq, "d": 384,
          "seconds": time.perf_counter() - t0})

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index, timings = build_with_timings(points, cfg, device="cuda")
    build_s = time.perf_counter() - t0
    emit({"phase": "build_index", "n": n, "timings_s": timings,
          "total_s": build_s, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "memory": index.memory_report()})

    # The counted run of the main path: counts at 0 just before, read after.
    hamming_rows.launches = 0
    qdist_windows.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, dists = index.search(queries, params)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"hamming_rows": hamming_rows.launches,
                "qdist_windows": qdist_windows.launches}
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path was not launched: {launches}")
    t0 = time.perf_counter()
    ids2, dists2 = index.search(queries, params)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    if not (torch.equal(ids, ids2) and torch.equal(dists, dists2)):
        raise AssertionError("two searches of the same queries differ")
    if ids.shape != (nq, params.k) or not torch.isfinite(dists).all():
        raise AssertionError(f"bad result: shape {tuple(ids.shape)}")
    emit({"phase": "search", "queries": nq, "launches": launches,
          "first_ms_per_query": first_s * 1e3 / nq,
          "warm_ms_per_query": warm_s * 1e3 / nq, "warm_s": warm_s})

    t0 = time.perf_counter()
    truth = exact_topk(torch, points, queries, params.k)
    hits = (ids.long()[:, :, None] == truth[:, None, :]).any(-1).sum().item()
    recall = hits / (nq * params.k)
    emit({"phase": "recall", "recall_at_30": recall, "floor": recall_floor,
          "ground_truth_s": time.perf_counter() - t0})
    if recall < recall_floor:
        raise AssertionError(f"recall@30 {recall} below floor {recall_floor}")

    t0 = time.perf_counter()
    ids_r, dists_r = index.search(queries, params, backend="ref")
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    torch.testing.assert_close(dists, dists_r, rtol=DIST_RTOL, atol=DIST_ATOL)
    mism = assert_ids_equal_up_to_ties(ids_r.cpu(), ids.cpu(), dists_r.cpu())
    emit({"phase": "kernel_vs_plain_route", "id_mismatches_within_ties": mism,
          "max_abs_dist_diff": float((dists - dists_r).abs().max()),
          "plain_route_ms_per_query": ref_s * 1e3 / nq})

    phase_profile(torch, index, queries, params)

    path = os.path.join(ROOT, "build", "smoke_index")
    shutil.rmtree(path, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        index.save(path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = HilbertIndex.load(path)
        load_s = time.perf_counter() - t0
        ids_l, dists_l = loaded.search(queries, params)
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(path, ignore_errors=True)
    same = torch.equal(ids, ids_l) and torch.equal(dists, dists_l)
    emit({"phase": "save_load", "bit_equal": same, "save_s": save_s,
          "load_s": load_s})
    if not same:
        raise AssertionError("search after save -> load differs")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=3_000_000, help="corpus rows")
    ap.add_argument("--queries", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--recall-floor", type=float, default=RECALL_FLOOR,
                    help="recall@30 the full-width search must reach (the "
                         "default was set at --n 3000000 --seed 0)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch missing; run from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.index import ForestConfig, IndexConfig, SearchParams
    from repro_torch.kernels import _build

    cfg = IndexConfig(
        forest=ForestConfig(n_trees=16, bits=4, key_bits=448, leaf_size=32),
        store_points=False,
    )
    params = SearchParams(k1=48, k2=384, h=2, k=30)

    phase_device()
    phase_build(_build)
    kernels = phase_kernel_parity(torch, KERNEL_REPS)
    phase_device_parity(torch, cfg, PARITY_ROWS, args.seed)
    launches = phase_main_path(torch, cfg, params, args.n, args.queries, args.seed,
                               args.recall_floor)
    for row in kernels:
        row["launches"] = launches[row["name"]]
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
