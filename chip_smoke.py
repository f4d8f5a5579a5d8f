#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Builds the CUDA kernels from ``src/repro_torch/csrc`` with nvcc, holds each
against its plain PyTorch version at the main paths' shapes, checks that
a build, a Task-2 graph and a streamed LSM index on the card equal those
on the CPU, then drives three paths at full width on 3,000,000 x 384
points:

* Task 1: ``HilbertIndex.build`` with the README quickstart configuration
  and ``.search`` of 8192 queries; recall@30 against exact ground truth,
  the kernel route against the plain route, save -> load -> search.
* LSM (phase ``lsm``): ``MutableHilbertIndex`` with the same forest and
  stored points bulk-loads 2,500,000 rows as one segment, saves, turns on
  its WAL, then streams the other 500,000 rows in inserts of 4096 with
  0.5 % deletes and a 2048-query search every 65,536 rows (seals and tier
  merges); recall@30 beside a fresh build's, ``compact()`` bit-equal to a
  fresh build over the live points, save -> load and WAL replay bit-equal.
* Task 2: ``HilbertIndex.build`` with the GOOAQ forest and
  ``.knn_graph(gooaq.TABLE2[0])`` (80 orders, k1 96, k2 60, k 15);
  recall@15 of 10,000 sampled rows against exact neighbours.

Each phase prints one JSON line; the line before the last is the kernel
table, the last line is ``{"ok": true, "device": {...}}``.  Any failure
raises and the script exits non-zero.  Without a GPU, or run from a
directory without ``src/repro_torch``, it prints no result and exits 2.

    python3 chip_smoke.py [--n 3000000] [--queries 8192] [--seed 0]
                          [--recall-floor 0.50] [--task2-orders 80]
                          [--task2-recall-floor F]

The LSM phase bulk-loads the first 5/6 of ``--n`` and streams the rest;
``--queries`` must be at least 6144 (2048 searched, 4096 inserted as the
WAL tail).
"""

from __future__ import annotations

import argparse
import dataclasses
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

# recall@15 floor of the full-width Task-2 graph at --seed 0, 80 orders:
# the first full run on an H100 measured 0.887 (PERF.md); the margin
# covers another torch release drawing other random numbers.
TASK2_RECALL_FLOOR = 0.85
TASK2_RECALL_ROWS = 10_000  # sampled rows of the exact recall@15 check

# The LSM phase: the README quickstart forest with stored points (which
# compaction re-sorts) and pow2 seals, a write buffer of 65,536 rows and
# at most 4 segments, so the 500,000 streamed rows seal 7 times and force
# tier merges; rounds of 65,536 inserted rows, each followed by deleting
# 0.5 % of the live ids and a search of 2048 queries, as a serving engine
# that expires entries runs it (benchmarks/churn.py's insert/expire/search).
LSM_BUFFER = 1 << 16
LSM_MAX_SEGMENTS = 4
LSM_BATCH = 4096  # rows per insert call
LSM_DELETE = 0.005  # share of the live ids deleted per round
LSM_QUERIES = 2048
LSM_TAIL = 4096  # rows inserted after the last save (the WAL tail)
LSM_TAIL_DELETES = 1000

KERNEL_REPS = 20  # timed runs per kernel (after warm-up)
PARITY_ROWS = 20_000  # rows of the cuda-vs-cpu build and graph checks
MERGE_CHUNK = 1 << 16  # rows of one Task-2 merge pass (knn_graph's default)


def kernel_fns():
    """The kernel wrappers of the port, by name (each counts its launches)."""
    from repro_torch.kernels.bitpack import pack_bits
    from repro_torch.kernels.hamming import hamming_rows
    from repro_torch.kernels.qdist import qdist_windows

    return {"hamming_rows": hamming_rows, "qdist_windows": qdist_windows,
            "pack_bits": pack_bits}


def reset_launches() -> None:
    for fn in kernel_fns().values():
        fn.launches = 0


def read_launches(torch) -> dict:
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in kernel_fns().items()}


def require_launched(path: str, launches: dict, names) -> None:
    missing = [n for n in names if launches[n] <= 0]
    if missing:
        raise AssertionError(f"{path}: kernels {missing} of the path were not "
                             f"launched: {launches}")


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
    from repro_torch.kernels.bitpack import pack_bits, pack_bits_ref
    from repro_torch.kernels.hamming import hamming_rows, hamming_rows_ref
    from repro_torch.kernels.qdist import qdist_windows, qdist_windows_ref

    g = torch.Generator(device="cuda").manual_seed(1234)
    dev = "cuda"

    def words(*shape):
        return torch.randint(-(2**31), 2**31, shape, generator=g, device=dev,
                             dtype=torch.int32)

    rows = []
    # --- hamming_rows: exact --------------------------------------------
    # Shapes: Task-1 search (Q, k1, W); Task-2 merge (chunk, k1, W); odd.
    ham, ham_times = {}, {}
    for qn, k, w in ((2048, 48, 12), (MERGE_CHUNK, 96, 12), (37, 33, 14)):
        a, c = words(qn, w), words(qn, k, w)
        got, ref = hamming_rows(a, c), hamming_rows_ref(a, c)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"hamming_rows != plain version at {(qn, k, w)}")
        ham[(qn, k, w)] = float((got - ref).abs().max())
        if qn != 37:
            b_ms, b_by = bound((qn * w + qn * k * w + qn * k) * 4, 3 * qn * k * w)
            ham_times[(qn, k, w)] = {
                "ms": median_ms(torch, lambda: hamming_rows(a, c), reps),
                "plain_ms": median_ms(torch, lambda: hamming_rows_ref(a, c), reps),
                "bound_ms": b_ms, "bound_by": b_by}
        del a, c, got, ref
    search_t, merge_t = ham_times[(2048, 48, 12)], ham_times[(MERGE_CHUNK, 96, 12)]
    rows.append({
        "name": "hamming_rows", "route": "cuda",
        "source": "src/repro_torch/csrc/hamming_rows.cu",
        "replaces": "src/repro/kernels/hamming/kernel.py:83",
        "max_abs_err": max(ham.values()), **search_t,
        "library_ms": None, "shape": [2048, 48, 12],
        "task2_shape": [MERGE_CHUNK, 96, 12],
        **{"task2_" + x: merge_t[x] for x in ("ms", "plain_ms", "bound_ms")},
    })
    emit({"phase": "kernel_parity", "kernel": "hamming_rows", "exact": True,
          "shapes": [list(s) for s in ham],
          "times": {str(list(s)): t for s, t in ham_times.items()}})

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

    # --- pack_bits: exact ---------------------------------------------------
    # Shapes: the sketches of the corpus, one key chunk of the curve, the
    # keys and sketches of one LSM seal, odd.
    pack_times = {}
    for n, k in ((3_000_000, 384), (262_144, 448), (LSM_BUFFER, 448),
                 (LSM_BUFFER, 384), (37, 61)):
        bits = torch.randint(0, 2, (n, k), generator=g, device=dev,
                             dtype=torch.uint8)
        got, ref = pack_bits(bits), pack_bits_ref(bits)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"pack_bits != plain version at {(n, k)}")
        if n != 37:
            w = -(-k // 32)
            b_ms, b_by = bound(n * k + n * w * 4, n * k)
            pack_times[(n, k)] = {
                "ms": median_ms(torch, lambda: pack_bits(bits), reps),
                "plain_ms": median_ms(torch, lambda: pack_bits_ref(bits),
                                      max(5, reps // 4)),
                "bound_ms": b_ms, "bound_by": b_by}
        del bits, got, ref
    torch.cuda.empty_cache()
    rows.append({
        "name": "pack_bits", "route": "cuda",
        "source": "src/repro_torch/csrc/pack_bits.cu",
        "replaces": "src/repro/kernels/bitpack/kernel.py:34",
        "max_abs_err": 0.0, **pack_times[(262_144, 448)],
        "library_ms": None, "shape": [262_144, 448],
        "sketch_shape": [3_000_000, 384],
        **{"sketch_" + x: pack_times[(3_000_000, 384)][x]
           for x in ("ms", "plain_ms", "bound_ms")},
        "lsm_seal_shape": [LSM_BUFFER, 448],
        **{"lsm_seal_" + x: pack_times[(LSM_BUFFER, 448)][x]
           for x in ("ms", "plain_ms", "bound_ms")},
    })
    emit({"phase": "kernel_parity", "kernel": "pack_bits", "exact": True,
          "shapes": [[3_000_000, 384], [262_144, 448], [LSM_BUFFER, 448],
                     [LSM_BUFFER, 384], [37, 61]],
          "times": {str(list(s)): t for s, t in pack_times.items()}})
    return rows


def lsm_state(mut) -> dict:
    """Every array of a MutableHilbertIndex's state, on the host."""
    import numpy as np

    n = mut._buf_count
    state = {"next_id": np.asarray(mut._next_id), "gen": np.asarray(mut._gen),
             "alive": mut._alive.copy(), "buf_ids": mut._buf_ids[:n].copy(),
             "buf_points": mut._buf_points[:n].copy()}
    for i, seg in enumerate(mut.segments):
        state[f"seg{i}.gen_n_valid"] = np.asarray([seg.gen, seg.n_valid])
        state[f"seg{i}.ids"] = seg.ids
        for k, v in seg.index.array_bundle().items():
            state[f"seg{i}.{k}"] = v
    return state


def lsm_differ(a: dict, b: dict) -> list:
    """Keys of two :func:`lsm_state` dicts whose arrays are not bit-equal."""
    import numpy as np

    return sorted(k for k in a.keys() | b.keys()
                  if k not in a or k not in b or a[k].dtype != b[k].dtype
                  or not np.array_equal(a[k], b[k]))


def phase_device_parity(torch, cfg, lsm_cfg, n: int, seed: int):
    import numpy as np

    from repro_torch.data import ann_datasets
    from repro_torch.index import HilbertIndex, IndexConfig

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

    # Task 2 on both devices: survivors bit-equal, graph within the contract.
    from repro_torch.configs import gooaq
    from repro_torch.core import knn_graph as knn_graph_lib
    from repro_torch.index import GraphParams

    tcfg = IndexConfig(forest=dataclasses.replace(gooaq.FOREST, n_trees=1),
                       store_points=True)
    gp = GraphParams(n_orders=8, k1=96, k2=60, k=15)
    out = {}
    for dev in ("cuda", "cpu"):
        idx = HilbertIndex.build(pts, tcfg, device=dev)
        fcfg = idx.config.forest
        t0 = time.perf_counter()
        surv = knn_graph_lib.graph_survivors(
            idx.points, idx.sketches_master[idx.master_rank.long()], gp,
            bits=fcfg.bits, key_bits=fcfg.key_bits, lo=idx.forest.lo,
            hi=idx.forest.hi)
        graph = idx.knn_graph(gp)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] = ([t.cpu() for t in surv], [t.cpu() for t in graph],
                    time.perf_counter() - t0)
    (gs, gg, t_gpu), (cs, cg, t_cpu) = out["cuda"], out["cpu"]
    surv_equal = torch.equal(gs[0], cs[0]) and torch.equal(gs[1], cs[1])
    emit({"phase": "device_parity_task2", "n": n, "params": dataclasses.asdict(gp),
          "survivors_bit_equal": surv_equal,
          "max_abs_dist_diff": float((gg[1] - cg[1]).abs().max()),
          "gpu_s": t_gpu, "cpu_s": t_cpu})
    if not surv_equal:
        raise AssertionError("cuda Task-2 survivors differ from cpu survivors")
    torch.testing.assert_close(gg[1], cg[1], rtol=DIST_RTOL, atol=DIST_ATOL)
    assert_ids_equal_up_to_ties(cg[0], gg[0], cg[1])
    phase_device_parity_lsm(torch, lsm_cfg, pts, seed)


def phase_device_parity_lsm(torch, cfg, pts, seed: int):
    """A streamed LSM index on both devices: half the rows bulk-loaded, the
    rest in inserts of 1000 with 100 deletes after every other one (seals of
    2048 and tier merges), then ``compact()``.  State bit-equal, search
    within the contract; queries lie off the point set (the buffer's
    Gram-form distances cancel on it)."""
    import numpy as np

    from repro_torch.data import ann_datasets
    from repro_torch.index import MutableHilbertIndex, SearchParams

    n = pts.shape[0]
    queries = ann_datasets.lowrank_embeddings(256, 384, seed=seed + 1)
    params = SearchParams(k1=48, k2=384, h=2, k=30)
    out = {}
    for dev in ("cuda", "cpu"):
        rng = np.random.default_rng(seed)
        t0 = time.perf_counter()
        mut = MutableHilbertIndex(cfg, buffer_capacity=2048, max_segments=3,
                                  device=dev)
        mut.bulk_load(pts[: n // 2])
        for i, s in enumerate(range(n // 2, n, 1000)):
            mut.insert(pts[s : s + 1000])
            if i % 2:
                mut.delete(rng.choice(mut.n_live + mut.n_deleted, 100, replace=False))
        res = {"segments": mut.n_segments}
        for stage in ("streamed", "compacted"):
            if stage == "compacted":
                mut.compact()
            ids, d2 = (t.cpu() for t in mut.search(queries, params))
            res[stage] = (lsm_state(mut), ids, d2)
        res["s"] = time.perf_counter() - t0
        out[dev] = res
    gpu, cpu = out["cuda"], out["cpu"]
    report = {"phase": "device_parity_lsm", "n": n, "gpu_s": gpu["s"],
              "cpu_s": cpu["s"], "segments_streamed": gpu["segments"]}
    for stage in ("streamed", "compacted"):
        report[stage] = {
            "differ": lsm_differ(cpu[stage][0], gpu[stage][0]),
            "max_abs_dist_diff": float((gpu[stage][2] - cpu[stage][2]).abs().max())}
    emit(report)
    for stage in ("streamed", "compacted"):
        if report[stage]["differ"]:
            raise AssertionError(f"cuda LSM state ({stage}) differs from cpu in "
                                 f"{report[stage]['differ']}")
        (_, gids, gd), (_, cids, cd) = gpu[stage], cpu[stage]
        torch.testing.assert_close(gd, cd, rtol=DIST_RTOL, atol=DIST_ATOL)
        assert_ids_equal_up_to_ties(cids, gids, cd)


def exact_topk(torch, points, queries, k: int, self_ids=None):
    """Exact squared-L2 top-k ids by matmul over the corpus (a check only).

    ``self_ids`` (one corpus row per query) are left out of each answer.
    """
    chunk = max(1, min(512, 2**30 // points.shape[0]))  # <= 4 GiB of d2
    xsq = (points * points).sum(1)
    out = []
    for s in range(0, queries.shape[0], chunk):
        q = queries[s : s + chunk]
        d2 = xsq[None, :] - 2.0 * (q @ points.T) + (q * q).sum(1)[:, None]
        if self_ids is not None:
            d2.scatter_(1, self_ids[s : s + chunk, None], torch.inf)
        out.append(torch.topk(d2, k, dim=1, largest=False).indices)
        del d2
    return torch.cat(out)


def device_time(prof, top: int):
    """(device ms, top kernels, top ops, copy ms by kind) of a
    ``torch.profiler`` run.

    The total sums the device-side events (kernels, copies, sets) only: a
    CPU op's device time repeats the time of the kernels it launched.  The
    ops are ranked by that attributed time, which names the launching op.
    """
    from torch.autograd import DeviceType

    kernels, ops = [], []
    for e in prof.key_averages():
        us = e.self_device_time_total
        if us > 0:
            (ops if e.device_type == DeviceType.CPU else kernels).append(
                (us / 1e3, e.count, e.key))
    kernels.sort(reverse=True)
    ops.sort(reverse=True)

    def fmt(rows):
        return [{"ms": ms, "count": n, "name": k[:80]} for ms, n, k in rows[:top]]

    copies = {k: {"ms": ms, "count": n} for ms, n, k in kernels if k.startswith("Memcpy")}
    return sum(r[0] for r in kernels), fmt(kernels), fmt(ops), copies


def phase_profile(torch, search, phase: str = "profile", top: int = 12):
    """Device time by kernel over one warm ``search()``, its host<->device
    copies, and the device's busy share.

    The profiler's host overhead lengthens the wall time, so the busy share
    read here is a lower bound.
    """
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        search()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms, kernels, ops, copies = device_time(prof, top)
    emit({"phase": phase, "wall_ms": wall_ms, "device_ms": device_ms,
          "busy_share": device_ms / wall_ms if device_ms else None,
          "copies": copies, "top_kernels": kernels, "top_ops": ops})


def phase_data(torch, n: int, nq: int, seed: int):
    """The corpus and the held-out queries, drawn on the card from ``seed``."""
    from repro_torch.data import ann_datasets

    g = torch.Generator(device="cuda").manual_seed(seed)
    t0 = time.perf_counter()
    allpts = ann_datasets.lowrank_embeddings_torch(n + nq, 384, generator=g)
    torch.cuda.synchronize()
    emit({"phase": "data", "n": n, "queries": nq, "d": 384,
          "seconds": time.perf_counter() - t0})
    return allpts[:n], allpts[n:]


def phase_main_path(torch, cfg, params, points, queries, recall_floor: float):
    """Task 1 at full width; returns the kernel launches of its build and search."""
    from repro_torch.index import HilbertIndex, build_with_timings

    n, nq = points.shape[0], queries.shape[0]
    # Each counted run of a path: counts at 0 just before, read just after.
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    index, timings = build_with_timings(points, cfg, device="cuda")
    build_s = time.perf_counter() - t0
    build_launches = read_launches(torch)
    emit({"phase": "build_index", "n": n, "timings_s": timings,
          "total_s": build_s, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "memory": index.memory_report(), "launches": build_launches})
    require_launched("task-1 build", build_launches, ["pack_bits"])

    reset_launches()
    t0 = time.perf_counter()
    ids, dists = index.search(queries, params)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = read_launches(torch)
    require_launched("task-1 search", launches,
                     ["hamming_rows", "qdist_windows", "pack_bits"])
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

    phase_profile(torch, lambda: index.search(queries, params))

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
    return {"build": build_launches, "search": launches}


def phase_lsm(torch, cfg, params, points, queries, seed: int, recall_floor: float):
    """The streaming LSM index at full width; returns the kernel launches of
    its path (bulk load, stream, searches, compaction).

    Bulk-load the first 5/6 of the points as one segment, save, turn on the
    WAL, stream the rest in inserts of ``LSM_BATCH`` rows with a delete and
    search round every ``LSM_BUFFER`` rows, then hold recall, compaction,
    save/load and WAL replay to their references.
    """
    import gc

    import numpy as np

    from repro_torch.index import HilbertIndex, MutableHilbertIndex, WalConfig

    n = points.shape[0]
    bulk = n * 5 // 6
    q = queries[:LSM_QUERIES]
    tail = queries[LSM_QUERIES : LSM_QUERIES + LSM_TAIL]
    if tail.shape[0] < LSM_TAIL:
        raise ValueError(f"--queries must be >= {LSM_QUERIES + LSM_TAIL}")
    rng = np.random.default_rng(seed)
    live = np.zeros(n, np.bool_)  # the smoke's own record of the live ids
    path = os.path.join(ROOT, "build", "smoke_lsm")
    shutil.rmtree(path, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    try:
        reset_launches()
        mut = MutableHilbertIndex(cfg, buffer_capacity=LSM_BUFFER,
                                  max_segments=LSM_MAX_SEGMENTS)
        t0 = time.perf_counter()
        live[mut.bulk_load(points[:bulk])] = True
        torch.cuda.synchronize()
        bulk_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        mut.save(path)
        save0_s = time.perf_counter() - t0
        mut.enable_wal(path, WalConfig())
        emit({"phase": "lsm_bulk", "rows": bulk, "bulk_load_s": bulk_s,
              "save_s": save0_s, "memory": mut.memory_report()["per_segment"]})

        # Time the seals (flush) and tier merges on the index itself.
        spent = {"seal": [0.0, 0], "merge": [0.0, 0]}

        def timed(fn, key):
            def run(*args, **kwargs):
                torch.cuda.synchronize()
                t = time.perf_counter()
                seg = fn(*args, **kwargs)
                torch.cuda.synchronize()
                spent[key][0] += time.perf_counter() - t
                spent[key][1] += seg is not None
                return seg
            return run

        mut.flush = timed(mut.flush, "seal")
        mut._merge_segments = timed(mut._merge_segments, "merge")
        pos, rnd = bulk, 0
        while pos < n:
            end = min(pos + LSM_BUFFER, n)
            before = {k: list(v) for k, v in spent.items()}
            t0 = time.perf_counter()
            for s in range(pos, end, LSM_BATCH):
                got = mut.insert(points[s : min(s + LSM_BATCH, end)])
                if not np.array_equal(got, np.arange(s, s + got.size)):
                    raise AssertionError(f"insert at row {s} returned ids {got[:4]}...")
                live[got] = True
            torch.cuda.synchronize()
            insert_s = time.perf_counter() - t0
            pos = end
            live_ids = np.flatnonzero(live)
            dead = rng.choice(live_ids, int(LSM_DELETE * live_ids.size), replace=False)
            if mut.delete(dead) != dead.size:
                raise AssertionError("delete of live ids did not tombstone them all")
            live[dead] = False
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids, d2 = mut.search(q, params, allow_rewrite=False)
            torch.cuda.synchronize()
            search_s = time.perf_counter() - t0
            emit({"phase": "lsm_round", "round": rnd, "rows_inserted": pos - bulk,
                  "deleted": int(dead.size), "insert_s": insert_s,
                  "ms_per_query": search_s * 1e3 / q.shape[0],
                  "n_segments": mut.n_segments, "n_buffered": mut.n_buffered,
                  "segment_rows": [seg.n_points for seg in mut.segments],
                  "seal_s": spent["seal"][0] - before["seal"][0],
                  "seals": spent["seal"][1] - before["seal"][1],
                  "merge_s": spent["merge"][0] - before["merge"][0],
                  "merges": spent["merge"][1] - before["merge"][1],
                  "rewrite_pressure": mut.rewrite_pressure(params)})
            rnd += 1
        live_ids = np.flatnonzero(live)
        found = ids[ids >= 0].cpu().numpy()
        if (mut.n_live != live_ids.size or ids.shape != (q.shape[0], params.k)
                or not torch.isfinite(d2).all() or not live[found].all()):
            raise AssertionError("streamed search returned dead ids or bad shapes")
        # A stream of max_segments + 1 buffers or more must merge twice.
        if ((n - bulk) // LSM_BUFFER > LSM_MAX_SEGMENTS and spent["merge"][1] < 2):
            raise AssertionError(f"the stream ran {spent['merge'][1]} tier merges, "
                                 "not the 2 or more it is sized for")
        stream_ids = ids
        # Where a streamed search's time goes: segments, buffer, host copies.
        phase_profile(torch, lambda: mut.search(q, params, allow_rewrite=False),
                      "lsm_profile")

        t0 = time.perf_counter()
        mut.compact()
        torch.cuda.synchronize()
        compact_s = time.perf_counter() - t0
        cids, cd = mut.search(q, params)
        launches = read_launches(torch)
        require_launched("lsm", launches, ["hamming_rows", "qdist_windows", "pack_bits"])

        # recall@30 of the streamed state, and of a fresh build over the live
        # points in insertion order, which compaction must equal bit for bit.
        live_t = torch.from_numpy(live_ids).to(points.device)
        live_pts = points[live_t]
        truth = live_t[exact_topk(torch, live_pts, q, params.k)]

        def recall(got):
            hits = (got.long()[:, :, None] == truth[:, None, :]).any(-1).sum().item()
            return hits / (q.shape[0] * params.k)

        t0 = time.perf_counter()
        fresh = HilbertIndex.build(live_pts, cfg)
        torch.cuda.synchronize()
        fresh_s = time.perf_counter() - t0
        del live_pts
        fids, fd = fresh.search(q, params)
        fids = live_t[fids.long()].to(torch.int32)
        del fresh
        same = torch.equal(cd, fd) and torch.equal(cids, fids)
        emit({"phase": "lsm_recall", "recall_at_30": recall(stream_ids),
              "fresh_build_recall_at_30": recall(fids), "floor": recall_floor,
              "live": int(live_ids.size), "compact_s": compact_s,
              "fresh_build_s": fresh_s, "compacted_equals_fresh_build": same,
              "launches": launches})
        if recall(stream_ids) < recall_floor:
            raise AssertionError(f"LSM recall@30 {recall(stream_ids)} below "
                                 f"floor {recall_floor}")
        if not same:
            raise AssertionError("search after compact() differs from a fresh "
                                 "build over the live points")

        # Persistence: save -> load bit-equal; then an unsaved WAL tail.
        t0 = time.perf_counter()
        mut.save(path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = MutableHilbertIndex.load(path)
        load_s = time.perf_counter() - t0
        lids, ld = loaded.search(q, params)
        loaded.detach_wal().close()
        del loaded
        load_equal = torch.equal(lids, cids) and torch.equal(ld, cd)
        tail_ids = mut.insert(tail)
        mut.delete(rng.choice(np.concatenate([live_ids, tail_ids]), LSM_TAIL_DELETES,
                              replace=False))
        mut.wal.sync()
        wids, wd = mut.search(q, params)
        want_state = (mut.n_live, mut.n_deleted, mut.n_buffered)
        mut.detach_wal().close()
        del mut
        t0 = time.perf_counter()
        rec = MutableHilbertIndex.load(path)
        replay_s = time.perf_counter() - t0
        rids, rd = rec.search(q, params)
        replay_equal = (torch.equal(rids, wids) and torch.equal(rd, wd)
                        and (rec.n_live, rec.n_deleted, rec.n_buffered) == want_state)
        rec.detach_wal().close()
        del rec
        emit({"phase": "lsm_persistence", "save_s": save_s, "load_s": load_s,
              "load_bit_equal": load_equal, "wal_replay_load_s": replay_s,
              "wal_replay_bit_equal": replay_equal,
              "wal_tail": {"rows": LSM_TAIL, "deletes": LSM_TAIL_DELETES}})
        if not (load_equal and replay_equal):
            raise AssertionError("LSM search after save -> load or WAL replay differs")
    finally:
        shutil.rmtree(path, ignore_errors=True)
    emit({"phase": "lsm", "seconds": time.perf_counter() - t_phase,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "seal": spent["seal"], "merge": spent["merge"], "launches": launches})
    gc.collect()
    torch.cuda.empty_cache()
    return {"lsm": launches}


def phase_task2(torch, points, params, seed: int, recall_floor: float):
    """Task 2 at full width: GOOAQ forest build, then ``knn_graph(params)``.

    Returns the kernel launches of the build and of the graph.
    """
    from repro_torch.configs import gooaq
    from repro_torch.index import IndexConfig, build_with_timings

    n = points.shape[0]
    cfg = IndexConfig(forest=dataclasses.replace(gooaq.FOREST, n_trees=1),
                      store_points=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    index, timings = build_with_timings(points, cfg, device="cuda")
    build_s = time.perf_counter() - t0
    build_launches = read_launches(torch)
    emit({"phase": "task2_build", "n": n, "forest": dataclasses.asdict(cfg.forest),
          "timings_s": timings, "total_s": build_s,
          "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
          "launches": build_launches})
    require_launched("task-2 build", build_launches, ["pack_bits"])

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    ids, d2 = index.knn_graph(params)
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    launches = read_launches(torch)
    peak = torch.cuda.max_memory_allocated() / 2**30
    require_launched("task-2 graph", launches, ["pack_bits", "hamming_rows"])
    rows = torch.arange(n, device=ids.device, dtype=ids.dtype)[:, None]
    if (ids.shape != (n, params.k) or not torch.isfinite(d2).all()
            or (ids < 0).any() or (ids == rows).any()
            or (d2[:, 1:] < d2[:, :-1]).any()):
        raise AssertionError(f"bad graph: shape {tuple(ids.shape)}, finite "
                             f"{bool(torch.isfinite(d2).all())}")
    emit({"phase": "task2", "n": n, "params": dataclasses.asdict(params),
          "graph_s": graph_s, "peak_gib": peak, "launches": launches})

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(seed)
    sample = torch.randperm(n, generator=g, device="cuda")[:TASK2_RECALL_ROWS]
    truth = exact_topk(torch, points, points[sample], params.k, self_ids=sample)
    got = ids[sample].long()
    hits = (got[:, :, None] == truth[:, None, :]).any(-1).sum().item()
    recall = hits / (sample.numel() * params.k)
    emit({"phase": "task2_recall", "recall_at_15": recall, "rows": sample.numel(),
          "floor": recall_floor, "ground_truth_s": time.perf_counter() - t0})
    if recall < recall_floor:
        raise AssertionError(f"task-2 recall@15 {recall} below floor {recall_floor}")

    phase_task2_profile(torch, index, params)
    return {"task2_build": build_launches, "task2": launches}


def phase_task2_profile(torch, index, params, top: int = 12):
    """Where one order of the graph goes: its stages timed one by one with a
    synchronize between, then the device time by kernel of one order and
    the exact re-rank under the profiler."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import knn_graph as knn_graph_lib

    fcfg = index.config.forest
    points = index.points
    n, d = points.shape
    curve = dict(bits=fcfg.bits, key_bits=fcfg.key_bits)
    rng = np.random.default_rng(params.seed)
    perm = torch.as_tensor(rng.permutation(d).astype(np.int32), device="cuda")
    flip = torch.as_tensor(rng.integers(0, 2, d).astype(bool), device="cuda")

    def one_order():
        stages = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sk = index.sketches_master[index.master_rank.long()]
        best_id = torch.full((n, params.k2), -1, dtype=torch.int32, device="cuda")
        best_d = torch.full((n, params.k2), 2**30, dtype=torch.int32, device="cuda")
        torch.cuda.synchronize()
        stages["setup_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        order, rank = knn_graph_lib.order_and_rank(points, index.forest.lo,
                                                   index.forest.hi, perm, flip, **curve)
        torch.cuda.synchronize()
        stages["order_and_rank_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        best_id, _ = knn_graph_lib.merge_order(best_id, best_d, order, rank, sk,
                                               k1=params.k1, k2=params.k2)
        torch.cuda.synchronize()
        stages["merge_order_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        for s in range(0, n, MERGE_CHUNK):
            knn_graph_lib.final_select_chunk(points, best_id[s : s + MERGE_CHUNK], s,
                                             k=params.k)
        torch.cuda.synchronize()
        stages["final_select_s"] = time.perf_counter() - t0
        return stages

    one_order()  # warm
    stages = one_order()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_order()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms, kernels, ops, _ = device_time(prof, top)
    emit({"phase": "task2_profile", "stages_s": stages,
          "graph_estimate_s": (params.n_orders * (stages["order_and_rank_s"]
                                                   + stages["merge_order_s"])
                               + stages["final_select_s"]),
          "profiled_wall_ms": wall_ms, "device_ms": device_ms,
          "busy_share": device_ms / wall_ms if device_ms else None,
          "top_kernels": kernels, "top_ops": ops})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=3_000_000, help="corpus rows")
    ap.add_argument("--queries", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--recall-floor", type=float, default=RECALL_FLOOR,
                    help="recall@30 the full-width search must reach (the "
                         "default was set at --n 3000000 --seed 0)")
    ap.add_argument("--task2-orders", type=int, default=None,
                    help="Hilbert orders of the Task-2 graph (default: "
                         "gooaq.TABLE2[0], 80)")
    ap.add_argument("--task2-recall-floor", type=float, default=TASK2_RECALL_FLOOR,
                    help="recall@15 the full-width graph must reach (the "
                         "default was set at --n 3000000 --seed 0, 80 orders)")
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

    from repro_torch.configs import gooaq
    from repro_torch.index import ForestConfig, IndexConfig, SearchParams
    from repro_torch.kernels import _build

    cfg = IndexConfig(
        forest=ForestConfig(n_trees=16, bits=4, key_bits=448, leaf_size=32),
        store_points=False,
    )
    lsm_cfg = dataclasses.replace(cfg, store_points=True, seal_pow2=True)
    params = SearchParams(k1=48, k2=384, h=2, k=30)
    graph_params = gooaq.TABLE2[0]
    if args.task2_orders is not None:
        graph_params = dataclasses.replace(graph_params, n_orders=args.task2_orders)

    phase_device()
    phase_build(_build)
    kernels = phase_kernel_parity(torch, KERNEL_REPS)
    phase_device_parity(torch, cfg, lsm_cfg, PARITY_ROWS, args.seed)
    points, queries = phase_data(torch, args.n, args.queries, args.seed)
    launches = phase_main_path(torch, cfg, params, points, queries,
                               args.recall_floor)
    torch.cuda.empty_cache()
    launches.update(phase_lsm(torch, lsm_cfg, params, points, queries, args.seed,
                              args.recall_floor))
    del queries
    torch.cuda.empty_cache()
    launches.update(phase_task2(torch, points, graph_params, args.seed,
                                args.task2_recall_floor))
    for row in kernels:
        by_path = {path: counts[row["name"]] for path, counts in launches.items()}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
