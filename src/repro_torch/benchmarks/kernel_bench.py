"""Kernel microbenchmarks: dense Hamming matrix and dense 4-bit ADC distance.

Counterpart of ``benchmarks/kernel_bench.py`` at its shapes and inputs
(numpy, seed 0): Hamming of 512 queries against 65,536 candidates of 384
bits, and 512 fp32 queries against 16,384 rows of 4-bit codes at d = 384,
the codes from :func:`repro_torch.core.quantize.fit` and ``encode``.  The
JAX module scores the codes unpacked only; here the same codes also go
through ``pack_codes`` and the packed kernel (``qdist_from_packed``).

On the card each row is the CUDA kernel's device time (CUDA events), its
bound on an H100 (bytes over 3.35 TB/s or operations over the 67 TFLOP/s
of non-tensor fp32, whichever is longer; the bytes each input read once
and the output written once), the plain version's time, and the kernel
held to its plain version at the same shape (the counterpart of the JAX
module's interpret-mode spot check): Hamming exactly, distances within
rtol 1e-5 / atol 1e-6.  Each row also times one PyTorch call that
computes the same function, a yardstick used nowhere in the port: for
Hamming ``torch.cdist(p=0)`` on the sketches unpacked to {0, 1} float32
bits (held equal to the kernel), leaving out the unpacking; for the two
distance rows ``torch.cdist`` on the dequantized fp32 rows, squared,
with TF32 off, leaving out the dequantization.  On the CPU
(``device="cpu"``) the wrappers take their plain versions and no time is
measured.

    python -m repro_torch.benchmarks.kernel_bench [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core import quantize
from repro_torch.kernels.hamming import hamming_matrix, hamming_matrix_ref
from repro_torch.kernels.qdist import (qdist, qdist_from_packed, qdist_packed_ref,
                                       qdist_u8_ref)

__all__ = ["main", "inputs", "bound", "median_ms", "sketch_bits", "HBM_BYTES_PER_S",
           "FP32_OPS_PER_S"]

# Published peaks of one H100 SXM (dense, at its 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# The distance contract of tests/test_kernels_integration.py.
DIST_RTOL = 1e-5
DIST_ATOL = 1e-6

HAMMING_SHAPE = (512, 65536, 12)  # (Q, C, W): 384-bit sketches
QDIST_SHAPE = (512, 16384, 384)  # (Q, C, D)
REPS = 20  # timed runs per kernel, after two warm-up runs
COLUMNS = ("name", "device_ms", "bound_ms", "bound_by", "bytes_per_call",
           "ops_per_call", "plain_ms", "library_ms", "max_abs_err")


def bound(n_bytes: float, n_ops: float) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time an H100 could take."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def median_ms(fn: Callable[[], object], reps: int) -> float:
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


def sketch_bits(words: torch.Tensor) -> torch.Tensor:
    """(..., W) int32 words -> (..., 32 W) float32 {0, 1}: the bits that
    ``torch.cdist(p=0)`` counts the differences of."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[..., None] >> shifts) & 1).flatten(-2).float()


def inputs(dev, hamming_shape=HAMMING_SHAPE, qdist_shape=QDIST_SHAPE
           ) -> Dict[str, torch.Tensor]:
    """The bench's inputs on ``dev``, drawn from numpy seed 0 in this order:
    Hamming words ``a`` (Q, W) and ``b`` (C, W); normal data whose 4-bit
    ``codes``, nibble-``packed`` codes, ``centroids`` and dequantized rows
    ``recon`` come from ``quantize.fit`` and ``encode``; normal ``queries``."""
    rng = np.random.default_rng(0)
    q, c, w = hamming_shape
    a = torch.from_numpy(rng.integers(0, 2**32, (q, w), dtype=np.uint32).view(np.int32))
    b = torch.from_numpy(rng.integers(0, 2**32, (c, w), dtype=np.uint32).view(np.int32))
    cq, cc, d = qdist_shape
    data = torch.from_numpy(rng.normal(size=(cc, d)).astype(np.float32)).to(dev)
    quant = quantize.fit(data, bits=4)
    codes = quantize.encode(quant, data)
    queries = torch.from_numpy(rng.normal(size=(cq, d)).astype(np.float32)).to(dev)
    return {"a": a.to(dev), "b": b.to(dev), "queries": queries, "codes": codes,
            "packed": quantize.pack_codes(codes), "centroids": quant.centroids,
            "recon": quantize.decode(quant, codes)}


def _row(name: str, kernel: Callable, plain: Callable, n_bytes: int, n_ops: int,
         exact: bool, on_card: bool, library: Callable = None) -> Dict:
    got = kernel()
    want = plain()
    if exact:
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel differs from its plain version")
        err = 0.0
    else:
        torch.testing.assert_close(got, want, rtol=DIST_RTOL, atol=DIST_ATOL)
        err = float((got - want).abs().max())
    del got, want
    bound_ms, bound_by = bound(n_bytes, n_ops)
    row = {"name": name, "device_ms": None, "bound_ms": bound_ms,
           "bound_by": bound_by, "bytes_per_call": n_bytes, "ops_per_call": n_ops,
           "plain_ms": None, "library_ms": None, "max_abs_err": err}
    if on_card:
        row["device_ms"] = median_ms(kernel, REPS)
        row["plain_ms"] = median_ms(plain, REPS // 4)
        if library is not None:
            if exact and not torch.equal(library().to(torch.int32), kernel()):
                raise AssertionError(f"{name}: the library call computes another function")
            row["library_ms"] = median_ms(library, REPS)
    return row


def main(device: str = "cuda", *, hamming_shape=HAMMING_SHAPE,
         qdist_shape=QDIST_SHAPE) -> List[Dict]:
    """Run the three rows on ``device``; print them as CSV and return them.

    ``device="cuda"`` (the default) raises without a GPU; pass
    ``device="cpu"`` to check the path on the plain versions.
    """
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("kernel_bench runs on CUDA by default and no GPU is "
                           "available; pass device='cpu' to run on the CPU")
    x = inputs(dev, hamming_shape, qdist_shape)
    rows = []

    q, c, w = hamming_shape
    a, b = x.pop("a"), x.pop("b")
    a_bits, b_bits = sketch_bits(a), sketch_bits(b)
    rows.append(_row(
        f"hamming_{q}x{c}x{32 * w}b", lambda: hamming_matrix(a, b),
        lambda: hamming_matrix_ref(a, b), (q * w + c * w + q * c) * 4, 3 * q * c * w,
        exact=True, on_card=on_card,
        library=lambda: torch.cdist(a_bits, b_bits, p=0)))
    del a, b, a_bits, b_bits

    cq, cc, d = qdist_shape
    queries, codes, packed = x["queries"], x["codes"], x["packed"]
    cent, recon = x["centroids"], x["recon"]
    levels = cent.shape[1]

    def cdist_sq():
        return torch.cdist(queries, recon) ** 2

    common = cq * d * 4 + d * levels * 4 + cq * cc * 4  # queries, table, output
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rows.append(_row(
            f"qdist_u8_{cq}x{cc}x{d}", lambda: qdist(queries, codes, cent),
            lambda: qdist_u8_ref(queries, codes, cent), common + cc * d,
            3 * cq * cc * d, exact=False, on_card=on_card,
            library=cdist_sq))
        rows.append(_row(
            f"qdist_packed_{cq}x{cc}x{d}", lambda: qdist_from_packed(queries, packed, cent),
            lambda: qdist_packed_ref(queries, packed, cent),
            common + cc * packed.shape[1] * 4, 3 * cq * cc * d, exact=False,
            on_card=on_card, library=cdist_sq))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32

    print(",".join(COLUMNS))
    for row in rows:
        print(",".join(str(row[k]) if row[k] is not None
                       else "none" if on_card and k == "library_ms"
                       else "not measured" for k in COLUMNS))
    print("library_ms: hamming: torch.cdist(p=0) on the unpacked {0,1} float32 bits, "
          "leaving out the unpacking; qdist: torch.cdist(queries, dequantized rows) "
          "** 2, fp32 without TF32, leaving out the dequantization")
    print("kernel_vs_plain_check,ok")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
