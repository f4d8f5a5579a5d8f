"""Build the CUDA sources of ``repro_torch/csrc`` with nvcc and load them with ctypes.

Each ``<name>.cu`` exposes a plain C launcher and becomes its own shared
library ``build/repro_torch_kernels/<name>-<hash>.so`` under the repository
root, keyed by a hash of the source and the flags, and built at first use.
Missing libraries are compiled together, one nvcc process per source.
There is no fallback: without nvcc, or when a compile fails, this raises
with the compiler's output.  Each compile and each first load is a
compile event of :mod:`repro_torch.obs.dispatch`, counted on the calling
thread.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

from repro_torch.obs.dispatch import record_compile

__all__ = ["SOURCES", "NVCC_FLAGS", "build", "build_log", "library", "nvcc_path"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("hamming_rows", "qdist_windows", "pack_bits")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The nvcc to build with: ``PATH`` first, then the toolkit's default home."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc: the CUDA "
        "kernels of repro_torch cannot be built (CPU tensors use the plain "
        "versions; CUDA tensors need the kernels)"
    )


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library of ``names`` in parallel.

    Returns seconds of wall time per source compiled (empty when all were
    built already).  The compiler's output, ptxas register and shared
    memory report included, is kept beside each library as ``.log``.
    """
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for n in todo:
        tmp = _target(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    seconds, failures = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        _target(n).with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {n}.cu (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _target(n))
            record_compile()
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """The compiler output kept from the build of ``name`` ('' if none)."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    build((name,))
    lib = ctypes.CDLL(str(_target(name)))
    record_compile()
    return lib
