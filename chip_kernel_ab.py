#!/usr/bin/env python3
"""Two versions of the dense 4-bit ADC kernels, in turns, on one NVIDIA GPU.

Builds another version of ``src/repro_torch/csrc/qdist_dense.cu``
(``OTHER``, for example the parent commit's:
``git show REV:src/repro_torch/csrc/qdist_dense.cu > build/kernel_ab/other.cu``)
with the port's nvcc flags into ``build/kernel_ab/``, beside the tree's own
build, and prints each build's ptxas register and spill lines.  On the
kernel bench's inputs (``kernel_bench.inputs``) each launcher
(``qdist_u8_launch``, ``qdist_packed_launch``) of the two versions is timed
with ``kernel_bench.median_ms`` in the order other, tree, tree, other, then
``torch.cdist`` squared without TF32, for two rounds; ``nvidia-smi`` reads
the SM clock after each timing.  Correctness is held elsewhere
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).  One JSON line per
timing; the last line is a JSON summary (card name and power limit,
medians per version and launcher, clocks seen).

    python3 chip_kernel_ab.py OTHER.cu
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
OUT_DIR = os.path.join(ROOT, "build", "kernel_ab")
LAUNCHERS = ("qdist_u8_launch", "qdist_packed_launch")
ORDER = ("other", "tree", "tree", "other")
ROUNDS = 2


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def ptxas_lines(name: str, log: str) -> None:
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas {name}: {line.strip()}", flush=True)


def load_other(path: str) -> ctypes.CDLL:
    """Compile ``path`` with the port's flags; return the loaded library."""
    from repro_torch.kernels import _build

    os.makedirs(OUT_DIR, exist_ok=True)
    so = os.path.join(OUT_DIR, "other.so")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {path}:\n{proc.stdout}{proc.stderr}")
    ptxas_lines("other", proc.stdout + proc.stderr)
    return ctypes.CDLL(so)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__.strip().splitlines()[-1].strip(), file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_kernel_ab: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch.benchmarks import kernel_bench
    from repro_torch.kernels import _build

    card = smi("name,power.limit")
    print(card, flush=True)
    libs = {"other": load_other(os.path.abspath(argv[0])),
            "tree": _build.library("qdist_dense")}
    ptxas_lines("tree", _build.build_log("qdist_dense"))
    x = kernel_bench.inputs("cuda")
    q, cent, recon = x["queries"], x["centroids"], x["recon"]
    codes_of = {"qdist_u8_launch": x["codes"], "qdist_packed_launch": x["packed"]}
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, launcher: str):
        codes = codes_of[launcher]
        out = torch.empty((q.shape[0], codes.shape[0]), device=q.device)
        err = getattr(lib, launcher)(
            ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(codes.data_ptr()),
            ctypes.c_void_p(cent.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            q.shape[0], codes.shape[0], q.shape[1], cent.shape[1], ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(f"{launcher}: cudaError_t {err}")
        return out

    times = {f"{n} {l}": [] for n in libs for l in LAUNCHERS}
    times["cdist"] = []
    clocks = []

    def timed(key, fn):
        ms = kernel_bench.median_ms(fn, kernel_bench.REPS)
        clock = smi("clocks.sm")
        times[key].append(ms)
        clocks.append(clock)
        print(json.dumps({"timing": key, "ms": ms, "clocks.sm": clock}), flush=True)

    for _ in range(ROUNDS):
        for launcher in LAUNCHERS:
            for name in ORDER:
                timed(f"{name} {launcher}", lambda: launch(libs[name], launcher))
            timed("cdist", lambda: torch.cdist(q, recon) ** 2)

    def median(v):
        return sorted(v)[len(v) // 2]

    print(json.dumps({"card": card, "shape": list(kernel_bench.QDIST_SHAPE),
                      "median_ms": {k: median(v) for k, v in times.items()},
                      "times_ms": times, "clocks.sm": sorted(set(clocks))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
