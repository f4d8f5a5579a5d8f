#!/usr/bin/env python3
"""Another version of a CUDA kernel source against the tree's, in turns, on one NVIDIA GPU.

Each argument ``NAME=OTHER.cu`` names a source of ``src/repro_torch/csrc``
(``hamming_rows``, ``hamming_matrix``, ``pack_bits``, ``qdist_windows`` or
``qdist_dense``) and another version of it, for example the parent
commit's::

    git show REV:src/repro_torch/csrc/pack_bits.cu > build/kernel_ab/pack_bits.cu

``NAME=VARIANT`` takes instead a variant of the tree's own source, made by
text substitutions that must each find their anchor (see ``VARIANTS``).
``hamming_matrix``: ``no_evict_first`` (output stores without the
evict-first hint) and ``direct_stores`` (fragments stored straight from
registers, no staging in shared memory).  ``qdist_windows``: ``stages2`` / ``stages4``
(ring depth), ``acc8`` (8 accumulators), ``words4`` / ``words16`` (words a
stage), ``no_l2_hint`` (16-byte copies without ``.L2::128B``),
``pair_table`` (a table of 256 terms a pair of dims, half the lookups, one
block an SM), ``w48`` (W fixed at 48 and the stages unrolled; right only
for D = 377..384, which is all this script runs), and three probes whose
distances are wrong by design and are not compared: ``no_lookups`` (each
lookup replaced by adding its address as a float), ``no_copies`` (no copy
issued) and ``neither``.

Every OTHER is compiled with the port's nvcc flags into
``build/kernel_ab/``, all at once, and each build's ptxas register and
spill lines are printed.  Then, at the paths' shapes, the two versions are
timed with ``kernel_bench.median_ms`` (CUDA events, median of 20) in the
order other, tree, tree, other, for two rounds; ``nvidia-smi`` reads the
SM clock after each timing.  The launcher's arguments of OTHER are read
from its source, so a parent whose launcher took other arguments is
driven as it was.

* ``hamming_rows``: (a) a pre-gathered (Q, K, 12) block at (2048, 48),
  (2048, 1255), (2048, 2425) (the search's k1 and Table 1's mean k1 of its
  160- and 120-tree rows) and (65536, 96) (a Task-2 merge chunk), both
  versions on the same block; (b) the stage-1 step at the same shapes on
  3,000,000 resident rows, each query's indices near a random point of
  the table (so neighbouring queries' rows overlap): a parent that takes
  a pre-gathered block is timed with the gather ``rows[idx]`` before it,
  the tree's kernel reads the rows by index.  Outputs must be equal.
* ``hamming_matrix``: the kernel bench's (512, 65536, 12); outputs equal;
  then ``torch.cdist(p=0)`` on the unpacked {0, 1} float32 bits, without
  the unpacking, and ``fill_`` of a (512, 65536) int32 tensor, the write
  floor.
* ``pack_bits``: random {0,1} bytes at (262144, 448) (one key chunk of the
  curve), (3000000, 384) (the corpus sketches) and (2048, 448) (one query
  chunk's keys); the two outputs must be equal.
* ``qdist_windows``: (a) pre-gathered windows (Q, C, 48) at (2048, 1920,
  384) (the engine's pool), (2048, 1675, 384) and (2048, 4875, 384) (Table
  1's mean pools), both versions on the same windows; (b) the stage-2
  distance step at (2048, 384 x 5) and (2048, 975 x 5) on 3,000,000 rows of
  codes, windows of 5 rows starting near a random point of each query (so
  neighbouring windows overlap): a parent that takes pre-gathered windows
  is timed with the gather ``rows[starts + arange(5)]`` before it, the
  tree's kernel reads the rows itself.  Outputs must agree within rtol
  1e-5 / atol 1e-6.
* ``qdist_dense``: both launchers on the kernel bench's inputs, beside
  ``torch.cdist`` squared without TF32.

One JSON line per timing; the last line is a JSON summary (card name and
power limit, medians per version and shape, largest differences, clocks
seen).  Correctness is held elsewhere (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

    python3 chip_kernel_ab.py NAME=OTHER.cu|NAME=VARIANT [...]
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
OUT_DIR = os.path.join(ROOT, "build", "kernel_ab")
NAMES = ("hamming_rows", "hamming_matrix", "pack_bits", "qdist_windows", "qdist_dense")
ORDER = ("other", "tree", "tree", "other")
ROUNDS = 2
DIST_RTOL, DIST_ATOL = 1e-5, 1e-6

ROWS_SHAPES = ((2048, 48, 12), (2048, 1255, 12), (2048, 2425, 12), (65536, 96, 12))
ROWS_TABLE = 3_000_000
PACK_SHAPES = ((262_144, 448), (3_000_000, 384), (2048, 448))
WINDOW_SHAPES = ((2048, 1920, 384), (2048, 1675, 384), (2048, 4875, 384))
STEP_SHAPES = ((2048, 384, 5), (2048, 975, 5))  # (Q, S, L)
STEP_ROWS = 3_000_000


def smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def ptxas_lines(name: str, log: str) -> None:
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas {name}: {line.strip()}", flush=True)


# The variants of qdist_windows.cu: name -> (substitutions, distances
# comparable with the tree's).
LOOKUP = "acc[s % kAcc] += lds(a + ((4 * p + e) * 8 + s) * kLevels * 4);"
NO_LOOKUP = "acc[s % kAcc] += __uint_as_float(a + ((4 * p + e) * 8 + s) * kLevels * 4);"
COPY = ("copy16(slot + my_chunk * 32 + (cw ^ (my_chunk * kSwizzle)),\n"
        "                 ok ? src[j] + wd : rows, ok);")
NO_COPY = "(void)ok;"
# The pair table holds (q_a - c[a, lo])^2 + (q_b - c[b, hi])^2 for dims
# a = 2m, b = 2m + 1 and every byte (hi, lo); a word is 4 lookups.
PAIR = (
    ("sizeof(float) * static_cast<size_t>(slabs_of(w)) * kWords * 8 * kLevels",
     "sizeof(float) * static_cast<size_t>(slabs_of(w)) * kWords * 4 * 256"),
    ("reinterpret_cast<uint4*>(lut + slabs * kWords * 8 * kLevels)",
     "reinterpret_cast<uint4*>(lut + slabs * kWords * 4 * 256)"),
    ("""  for (int i = t; i < slabs * kWords * 8 * kLevels; i += kThreads) {
    const int j = i >> 4;  // dim; cent is (D, 16), so its index is i
    float v = 0.f;
    if (j < d) {
      const float diff = qrow[j] - cent[i];
      v = __fmul_rn(diff, diff);
    }
    lut[i] = v;
  }""", """  for (int i = t; i < slabs * kWords * 4 * 256; i += kThreads) {
    const int a = 2 * (i >> 8), b = a + 1, v = i & 255;
    float x = 0.f, y = 0.f;
    if (a < d) { const float f = qrow[a] - cent[a * 16 + (v & 15)]; x = __fmul_rn(f, f); }
    if (b < d) { const float f = qrow[b] - cent[b * 16 + (v >> 4)]; y = __fmul_rn(f, f); }
    lut[i] = x + y;
  }"""),
    ("""          const uint32_t even = (word << 2) & 0x3C3C3C3Cu;  // byte i: 4 x nibble 2i
          const uint32_t odd = (word >> 2) & 0x3C3C3C3Cu;   // byte i: 4 x nibble 2i + 1
#pragma unroll
          for (int s = 0; s < 8; ++s) {
            // tab | (4 x nibble s) in one byte permute, + the dim's row.
            const unsigned a = __byte_perm(s & 1 ? odd : even, tab, 0x7650 | (s >> 1));
            """ + LOOKUP + """
          }""", """#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const unsigned a = ((b == 0 ? word << 2 : word >> (8 * b - 2)) & 0x3FCu) | tab;
            acc[b % kAcc] += lds(a + ((4 * p + e) * 4 + b) * 1024);
          }"""),
    ("constexpr unsigned kSlabBytes = kWords * 8 * kLevels * 4;",
     "constexpr unsigned kSlabBytes = kWords * 4 * 256 * 4;"),
    ("constexpr int kLutAlign = 256;", "constexpr int kLutAlign = 1024;"),
)
QDIST_VARIANTS = {
    "stages2": ((("kStages = 3;", "kStages = 2;"),), True),
    "stages4": ((("kStages = 3;", "kStages = 4;"),), True),
    "acc8": ((("kAcc = 4;", "kAcc = 8;"),
              ("const float sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);",
               "const float sum = ((acc[0] + acc[1]) + (acc[2] + acc[3])) +"
               " ((acc[4] + acc[5]) + (acc[6] + acc[7]));")), True),
    "words4": ((("kWords = 8;", "kWords = 4;"),), True),
    "words16": ((("kWords = 8;", "kWords = 16;"),), True),
    "no_l2_hint": (((".L2::128B [", " ["),), True),
    "pair_table": (PAIR, True),
    "w48": ((("int d, int w) {\n  const int slabs = (w + kWords - 1) / kWords;",
              "int d, int) {\n  constexpr int w = 48, slabs = 6;"),
             ("#pragma unroll 1\n    for (int slab", "#pragma unroll\n    for (int slab")),
            True),
    "no_lookups": (((LOOKUP, NO_LOOKUP),), False),
    "no_copies": (((COPY, NO_COPY),), False),
    "neither": (((LOOKUP, NO_LOOKUP), (COPY, NO_COPY)), False),
}
# The variants of hamming_matrix.cu: name -> (regular expression, the text
# that replaces its one match).  ``no_evict_first`` stores the output
# without the evict-first hint; ``direct_stores`` writes each thread's
# fragments straight from registers, 8 bytes a lane, instead of staging
# whole rows in shared memory.
DIRECT_STORES = """  __syncthreads();  // the row popcounts are in
  // Fragments straight to the output, 8 bytes a lane.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + wn * 32 + 8 * j + 2 * tq;
      const int pb0 = pop[col - c0 + kTile], pb1 = pop[col - c0 + kTile + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 64 + 16 * i + g + 8 * h;
        if (q0 + row >= n_q) continue;
        const int v0 = pop[row] + pb0 - 2 * acc[i][j][2 * h];
        const int v1 = pop[row] + pb1 - 2 * acc[i][j][2 * h + 1];
        int32_t* dst = out + static_cast<long long>(q0 + row) * n_c + col;
        if (vec_out && col + 1 < n_c) {
          *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
        } else {
          if (col < n_c) dst[0] = v0;
          if (col + 1 < n_c) dst[1] = v1;
        }
      }
    }
  }
}

// Ask once per instantiation"""
HAMMING_MATRIX_VARIANTS = {
    "no_evict_first": ((r"__stcs\(reinterpret_cast<int4\*>\(dst\), v\);",
                        "*reinterpret_cast<int4*>(dst) = v;"),),
    "direct_stores": ((r"  __syncthreads\(\);\n#pragma unroll\n  for \(int i = 0; i < 4; \+\+i\) \{.*?"
                       r"\n}\n\n// Ask once per instantiation", DIRECT_STORES),),
}


def variant_source(name: str, variant: str, source: str) -> str:
    if name == "hamming_matrix":
        for pattern, new in HAMMING_MATRIX_VARIANTS[variant]:
            source, n = re.subn(pattern, lambda _: new, source, flags=re.DOTALL)
            if n != 1:
                raise RuntimeError(f"variant {variant}: anchor not found in "
                                   f"hamming_matrix.cu: {pattern[:60]!r}")
        return source
    for old, new in QDIST_VARIANTS[variant][0]:
        if old not in source:
            raise RuntimeError(f"variant {variant}: anchor not found in qdist_windows.cu: "
                               f"{old[:60]!r}")
        source = source.replace(old, new)
    return source


def is_variant(name: str, other: str) -> bool:
    return other in {"qdist_windows": QDIST_VARIANTS,
                     "hamming_matrix": HAMMING_MATRIX_VARIANTS}.get(name, {})


def build_others(paths) -> list:
    """Compile every ``path`` with the port's flags, all at once; load them."""
    from repro_torch.kernels import _build

    sos = [os.path.join(OUT_DIR, f"other{i}.so") for i in range(len(paths))]
    procs = [subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", so, path],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for so, path in zip(sos, paths)]
    logs = [p.communicate()[0] for p in procs]
    for i, (proc, path, log) in enumerate(zip(procs, paths, logs)):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {path}:\n{log}")
        ptxas_lines(f"other{i} ({os.path.basename(path)})", log)
    return [ctypes.CDLL(so) for so in sos]


def launcher_args(source: str, name: str) -> str:
    """The parameter list of ``name`` in ``source``."""
    m = re.search(name + r"\s*\(([^)]*)\)", source)
    if m is None:
        raise RuntimeError(f"{name} not found in the other source")
    return m.group(1)


def check_err(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: cudaError_t {err}")


def hamming_rows_cases(torch, libs, sources, compare):
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    indexed = {v: "idx" in launcher_args(src, "hamming_rows_launch")
               for v, src in sources.items()}

    def launch(version, q, rows, idx):
        """``idx`` None: ``rows`` is the pre-gathered (Q, K, W) block."""
        qn, w = q.shape
        k = rows.shape[1] if idx is None else idx.shape[1]
        out = torch.empty((qn, k), dtype=torch.int32, device="cuda")
        lib = libs[version]
        if indexed[version]:
            err = lib.hamming_rows_launch(
                p(q), p(rows), None if idx is None else p(idx),
                0 if idx is None else idx.element_size(), p(out), qn, k, w,
                ctypes.c_longlong(rows.shape[0]), stream)
        else:
            if idx is not None:
                rows = rows[idx]
            err = lib.hamming_rows_launch(p(q), p(rows), p(out), qn, k, w, stream)
        check_err("hamming_rows_launch", err)
        return out

    def words(*shape):
        return torch.randint(-(2**31), 2**31, shape, generator=g, device="cuda",
                             dtype=torch.int32)

    for qn, k, w in ROWS_SHAPES:
        q, block = words(qn, w), words(qn, k, w)
        a, b = launch("other", q, block, None), launch("tree", q, block, None)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"hamming_rows: the versions differ at {(qn, k, w)}")
        yield (f"hamming_rows pre-gathered {[qn, k, w]}",
               {v: (lambda v=v: launch(v, q, block, None)) for v in libs}, 0.0)
        del block, a, b
        torch.cuda.empty_cache()
    table = words(ROWS_TABLE, 12)
    for qn, k, w in ROWS_SHAPES:
        q = words(qn, w)
        centre = torch.randint(0, ROWS_TABLE, (qn, 1), generator=g, device="cuda")
        spread = torch.randint(-4 * k, 4 * k + 1, (qn, k), generator=g, device="cuda")
        idx = (centre + spread).clamp(0, ROWS_TABLE - 1).to(torch.int32)
        a, b = launch("other", q, table, idx), launch("tree", q, table, idx)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"hamming_rows: the versions differ at {(qn, k, w)}")
        yield (f"hamming_rows stage-1 step {[qn, k, w]}",
               {v: (lambda v=v: launch(v, q, table, idx)) for v in libs}, 0.0)
        del a, b
        torch.cuda.empty_cache()


def hamming_matrix_cases(torch, libs, sources, compare):
    from repro_torch.benchmarks import kernel_bench

    x = kernel_bench.inputs("cuda")
    a, b = x["a"], x["b"]
    del x
    (qn, w), c = a.shape, b.shape[0]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731

    def launch(version):
        out = torch.empty((qn, c), dtype=torch.int32, device="cuda")
        check_err("hamming_matrix_launch", libs[version].hamming_matrix_launch(
            p(a), p(b), p(out), qn, c, w, stream))
        return out

    x, y = launch("other"), launch("tree")
    torch.cuda.synchronize()
    if not torch.equal(x, y):
        raise AssertionError("hamming_matrix: the versions differ")
    del x, y
    yield (f"hamming_matrix {[qn, c, w]}", {v: (lambda v=v: launch(v)) for v in libs}, 0.0)
    a_bits, b_bits = kernel_bench.sketch_bits(a), kernel_bench.sketch_bits(b)
    yield ("hamming_matrix torch.cdist(p=0) on the unpacked bits",
           {"library": lambda: torch.cdist(a_bits, b_bits, p=0)}, None)
    del a_bits, b_bits
    out = torch.empty((qn, c), dtype=torch.int32, device="cuda")
    yield ("hamming_matrix write floor: fill_ of the (Q, C) int32 output",
           {"library": lambda: out.fill_(7)}, None)


def pack_bits_cases(torch, libs, sources, compare):
    from repro_torch.kernels.bitpack import vec_ok

    g = torch.Generator(device="cuda").manual_seed(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    takes_vec = {v: "vec" in launcher_args(src, "pack_bits_launch")
                 for v, src in sources.items()}

    def launch(version, bits):
        n, k = bits.shape
        out = torch.empty((n, -(-k // 32)), dtype=torch.int32, device="cuda")
        args = [ctypes.c_void_p(bits.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                ctypes.c_longlong(n), ctypes.c_int(k)]
        if takes_vec[version]:
            args.append(ctypes.c_int(int(vec_ok(bits))))
        check_err("pack_bits_launch", libs[version].pack_bits_launch(*args, stream))
        return out

    for n, k in PACK_SHAPES:
        bits = torch.randint(0, 2, (n, k), generator=g, device="cuda", dtype=torch.uint8)
        a, b = launch("other", bits), launch("tree", bits)
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"pack_bits: the versions differ at {(n, k)}")
        yield f"pack_bits {[n, k]}", {v: (lambda v=v: launch(v, bits)) for v in libs}, 0.0
        del bits, a, b
        torch.cuda.empty_cache()


def qdist_windows_cases(torch, libs, sources, compare):
    from repro_torch.kernels.qdist import window_rows

    g = torch.Generator(device="cuda").manual_seed(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rows_abi = {v: "starts" in launcher_args(src, "qdist_windows_launch")
                for v, src in sources.items()}

    def launch(version, q, rows, starts, n_s, window, cent):
        """``starts`` None: ``rows`` is the pre-gathered (Q, C, W) block."""
        qn, d = q.shape
        out = torch.empty((qn, n_s * window), device="cuda")
        lib = libs[version]
        p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        if rows_abi[version]:
            err = lib.qdist_windows_launch(
                p(q), p(rows), None if starts is None else p(starts), p(cent), p(out),
                qn, n_s, window, d, ctypes.c_longlong(rows.numel() // rows.shape[-1]),
                stream)
        else:
            if starts is not None:
                rows = window_rows(rows, starts, window).reshape(qn, n_s * window, -1)
            err = lib.qdist_windows_launch(p(q), p(rows), p(cent), p(out), qn,
                                           n_s * window, rows.shape[-1], d, stream)
        check_err("qdist_windows_launch", err)
        return out

    def words(*shape):
        return torch.randint(-(2**31), 2**31, shape, generator=g, device="cuda",
                             dtype=torch.int32)

    d = 384
    cent = torch.sort(torch.randn(d, 16, generator=g, device="cuda"), dim=1).values
    for qn, c, _ in WINDOW_SHAPES:
        q = torch.randn(qn, d, generator=g, device="cuda")
        win = words(qn, c, d // 8)
        a = launch("other", q, win, None, c, 1, cent)
        b = launch("tree", q, win, None, c, 1, cent)
        torch.cuda.synchronize()
        if compare:
            torch.testing.assert_close(b, a, rtol=DIST_RTOL, atol=DIST_ATOL)
        yield (f"qdist_windows pre-gathered {[qn, c, d]}",
               {v: (lambda v=v: launch(v, q, win, None, c, 1, cent)) for v in libs},
               float((a - b).abs().max()) if compare else None)
        del win, a, b
        torch.cuda.empty_cache()
    rows = words(STEP_ROWS, d // 8)
    for qn, s, window in STEP_SHAPES:
        q = torch.randn(qn, d, generator=g, device="cuda")
        centre = torch.randint(0, STEP_ROWS, (qn, 1), generator=g, device="cuda")
        spread = torch.randint(-4 * s, 4 * s + 1, (qn, s), generator=g, device="cuda")
        starts = (centre + spread).clamp(0, STEP_ROWS - window).to(torch.int32)
        a = launch("other", q, rows, starts, s, window, cent)
        b = launch("tree", q, rows, starts, s, window, cent)
        torch.cuda.synchronize()
        if compare:
            torch.testing.assert_close(b, a, rtol=DIST_RTOL, atol=DIST_ATOL)
        yield (f"qdist_windows stage-2 step {[qn, s * window, d]}",
               {v: (lambda v=v: launch(v, q, rows, starts, s, window, cent)) for v in libs},
               float((a - b).abs().max()) if compare else None)
        del a, b
        torch.cuda.empty_cache()


def qdist_dense_cases(torch, libs, sources, compare):
    from repro_torch.benchmarks import kernel_bench

    x = kernel_bench.inputs("cuda")
    q, cent, recon = x["queries"], x["centroids"], x["recon"]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731

    def launch(version, launcher, codes):
        out = torch.empty((q.shape[0], codes.shape[0]), device=q.device)
        check_err(launcher, getattr(libs[version], launcher)(
            p(q), p(codes), p(cent), p(out), q.shape[0], codes.shape[0], q.shape[1],
            cent.shape[1], stream))
        return out

    for launcher, codes in (("qdist_u8_launch", x["codes"]),
                            ("qdist_packed_launch", x["packed"])):
        yield (f"qdist_dense {launcher} {list(kernel_bench.QDIST_SHAPE)}",
               {v: (lambda v=v: launch(v, launcher, codes)) for v in libs}, None)
    yield ("qdist_dense torch.cdist squared", {"library": lambda: torch.cdist(q, recon) ** 2},
           None)


CASES = {"hamming_rows": hamming_rows_cases, "hamming_matrix": hamming_matrix_cases,
         "pack_bits": pack_bits_cases, "qdist_windows": qdist_windows_cases,
         "qdist_dense": qdist_dense_cases}


def parse(arg: str):
    """``NAME=OTHER.cu`` or ``NAME=VARIANT`` -> (name, other, label)."""
    name, sep, other = arg.partition("=")
    if not sep or name not in NAMES or not (other.endswith(".cu") or is_variant(name, other)):
        raise SystemExit(f"chip_kernel_ab: expected NAME=OTHER.cu with NAME in {NAMES}, "
                         f"hamming_matrix=VARIANT with VARIANT in "
                         f"{tuple(HAMMING_MATRIX_VARIANTS)} or qdist_windows=VARIANT with "
                         f"VARIANT in {tuple(QDIST_VARIANTS)}, got {arg!r}")
    return name, other, os.path.basename(other)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__.strip().splitlines()[-1].strip(), file=sys.stderr)
        return 2
    entries = [parse(a) for a in argv]
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
    _build.build(tuple(sorted({name for name, _, _ in entries})))
    os.makedirs(OUT_DIR, exist_ok=True)
    sources, paths = [], []
    for name, other, _ in entries:
        tree = (_build.CSRC / f"{name}.cu").read_text()
        if is_variant(name, other):
            source = variant_source(name, other, tree)
            path = os.path.join(OUT_DIR, f"{name}-{other}.cu")
            with open(path, "w") as f:
                f.write(source)
        else:
            path = os.path.abspath(other)
            with open(path) as f:
                source = f.read()
        sources.append({"other": source, "tree": tree})
        paths.append(path)
    others = build_others(paths)
    times, diffs, clocks = {}, {}, []

    def timed(key, fn):
        ms = kernel_bench.median_ms(fn, kernel_bench.REPS)
        clock = smi("clocks.sm")
        times.setdefault(key, []).append(ms)
        clocks.append(clock)
        print(json.dumps({"timing": key, "ms": ms, "clocks.sm": clock}), flush=True)

    for (name, other, label), source, lib in zip(entries, sources, others):
        ptxas_lines(f"tree {name}", _build.build_log(name))
        libs = {"other": lib, "tree": _build.library(name)}
        compare = QDIST_VARIANTS[other][1] if name == "qdist_windows" and is_variant(
            name, other) else True
        for case, fns, diff in CASES[name](torch, libs, source, compare):
            if diff is not None:
                diffs[f"{case} ({label})"] = diff
            for _ in range(ROUNDS):
                if "library" in fns:
                    timed(case, fns["library"])
                    continue
                for version in ORDER:
                    timed(f"{case} {version} ({label})" if version == "other"
                          else f"{case} tree (against {label})", fns[version])

    def median(v):
        return sorted(v)[len(v) // 2]

    print(json.dumps({"card": card, "median_ms": {k: median(v) for k, v in times.items()},
                      "times_ms": times, "max_abs_diff": diffs,
                      "clocks.sm": sorted(set(clocks))}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
