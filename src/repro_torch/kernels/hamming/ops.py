"""Stage-1 Hamming filter: the CUDA kernel's wrapper beside its plain version.

``hamming_rows`` is the counterpart of ``repro.kernels.hamming.hamming_rows``
(Pallas ``hamming_rows_kernel``): (Q, W) query sketches against each
query's own (Q, K, W) candidate sketches, 32-bit words held in int32,
giving (Q, K) int32 distances.  The kernel lives in
``repro_torch/csrc/hamming_rows.cu``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import sketch
from repro_torch.kernels import _build
from repro_torch.kernels._check import check, raise_on_error, same

__all__ = ["hamming_rows", "hamming_rows_ref"]


def hamming_rows_ref(queries: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: popcount(q ^ c) summed over words -> (Q, K) int32."""
    return sketch.hamming_distance(queries[:, None, :], candidates)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("hamming_rows").hamming_rows_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def hamming_rows(queries: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    """(Q, W) vs per-query (Q, K, W) int32 words -> (Q, K) int32 Hamming.

    CPU tensors take :func:`hamming_rows_ref`; CUDA tensors launch the
    kernel on the current stream (and count it in ``hamming_rows.launches``)
    or raise.
    """
    check("queries", queries, torch.int32, 2)
    check("candidates", candidates, torch.int32, 3, queries.device)
    qn, w = queries.shape
    same("candidates (Q, W)", (candidates.shape[0], candidates.shape[2]), (qn, w))
    if queries.device.type == "cpu":
        return hamming_rows_ref(queries, candidates)
    if queries.device.type != "cuda":
        raise ValueError(f"hamming_rows: no kernel for device {queries.device}")
    k = candidates.shape[1]
    out = torch.empty((qn, k), dtype=torch.int32, device=queries.device)
    if out.numel() == 0:
        return out
    err = _launcher()(
        queries.data_ptr(), candidates.data_ptr(), out.data_ptr(), qn, k, w,
        torch.cuda.current_stream(queries.device).cuda_stream,
    )
    raise_on_error("hamming_rows", err)
    hamming_rows.launches += 1
    return out


hamming_rows.launches = 0
