"""Sketch Hamming distances: the CUDA kernels' wrappers beside their plain versions.

``hamming_rows`` is the counterpart of ``repro.kernels.hamming.hamming_rows``
(Pallas ``hamming_rows_kernel``), the stage-1 filter: (Q, W) query
sketches against each query's own (Q, K, W) candidate sketches, 32-bit
words held in int32, giving (Q, K) int32 distances.
``hamming_rows_indexed`` computes the same function of the candidates
that stage 1 reads by index: rows ``idx[q, k]`` of the resident (n, W)
sketch table, with no (Q, K, W) block built.  One kernel serves both
(``repro_torch/csrc/hamming_rows.cu``); both wrappers count its launches
in ``hamming_rows.launches``.

``hamming_matrix`` is the counterpart of
``repro.kernels.hamming.hamming_matrix`` (Pallas ``hamming_matrix_kernel``):
(Q, W) against (C, W) shared candidates, giving the dense (Q, C) int32
matrix.  The kernel lives in ``repro_torch/csrc/hamming_matrix.cu``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import sketch
from repro_torch.kernels import _build
from repro_torch.kernels._check import check, count_launch, raise_on_error, same

__all__ = ["hamming_rows", "hamming_rows_ref", "hamming_rows_indexed",
           "hamming_rows_indexed_ref", "hamming_matrix", "hamming_matrix_ref"]

# Elements of the (rows, C, W) XOR block one step of hamming_matrix_ref
# builds: the bench shape (512 x 65536 x 12) would need 1.6 GB at once.
_REF_ELEMS = 1 << 25


def hamming_rows_ref(queries: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: popcount(q ^ c) summed over words -> (Q, K) int32."""
    return sketch.hamming_distance(queries[:, None, :], candidates)


def hamming_rows_indexed_ref(queries: torch.Tensor, table: torch.Tensor,
                             idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather ``table[idx]`` (indices clamped to
    ``[0, n - 1]``, as the JAX gather clamps), then :func:`hamming_rows_ref`."""
    return hamming_rows_ref(queries, table[idx.clamp(0, table.shape[0] - 1)])


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("hamming_rows").hamming_rows_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch_rows(queries, rows, idx, k: int):
    """Allocate (Q, k), launch the rows kernel, count it.

    ``idx`` None is the pre-gathered layout: row ``q * k + j`` of ``rows``.
    """
    qn, w = queries.shape
    out = torch.empty((qn, k), dtype=torch.int32, device=queries.device)
    if out.numel() == 0:
        return out
    err = _launcher()(
        queries.data_ptr(), rows.data_ptr(), None if idx is None else idx.data_ptr(),
        0 if idx is None else idx.element_size(), out.data_ptr(), qn, k, w,
        rows.shape[0], torch.cuda.current_stream(queries.device).cuda_stream,
    )
    raise_on_error("hamming_rows", err)
    count_launch(hamming_rows)
    return out


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
    return _launch_rows(queries, candidates.view(qn * k, w), None, k)


def hamming_rows_indexed(queries: torch.Tensor, table: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    """(Q, W) int32 words vs rows ``idx`` (Q, K) int32 or int64 of the
    (n, W) int32 ``table`` -> (Q, K) int32 Hamming.

    An index outside ``[0, n)`` reads row 0 or n - 1 (clamped, as the JAX
    gather clamps); the search paths never make one.  CPU tensors take
    :func:`hamming_rows_indexed_ref`; CUDA tensors launch the rows kernel
    on the current stream (and count it in ``hamming_rows.launches``) or
    raise.
    """
    check("queries", queries, torch.int32, 2)
    check("table", table, torch.int32, 2, queries.device)
    wide = isinstance(idx, torch.Tensor) and idx.dtype == torch.int64
    check("idx", idx, torch.int64 if wide else torch.int32, 2, queries.device)
    same("table W", table.shape[1:], queries.shape[1:])
    same("idx Q", idx.shape[:1], queries.shape[:1])
    if table.shape[0] < 1:
        raise ValueError("table: at least one row")
    if queries.device.type == "cpu":
        return hamming_rows_indexed_ref(queries, table, idx)
    if queries.device.type != "cuda":
        raise ValueError(f"hamming_rows_indexed: no kernel for device {queries.device}")
    return _launch_rows(queries, table, idx, idx.shape[1])


hamming_rows.launches = 0


def hamming_matrix_ref(queries: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: popcount(q ^ c) summed over words -> (Q, C)
    int32, a block of query rows at a time."""
    qn, c = queries.shape[0], candidates.shape[0]
    step = max(1, _REF_ELEMS // max(1, c * candidates.shape[1]))
    out = torch.empty((qn, c), dtype=torch.int32, device=queries.device)
    for s in range(0, qn, step):
        out[s : s + step] = sketch.hamming_distance(
            queries[s : s + step, None, :], candidates[None, :, :])
    return out


@functools.lru_cache(maxsize=None)
def _matrix_launcher():
    fn = _build.library("hamming_matrix").hamming_matrix_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def hamming_matrix(queries: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    """(Q, W) vs shared (C, W) int32 words -> (Q, C) int32 Hamming.

    CPU tensors take :func:`hamming_matrix_ref`; CUDA tensors launch the
    kernel on the current stream (and count it in
    ``hamming_matrix.launches``) or raise.
    """
    check("queries", queries, torch.int32, 2)
    check("candidates", candidates, torch.int32, 2, queries.device)
    same("candidates W", candidates.shape[1:], queries.shape[1:])
    if queries.device.type == "cpu":
        return hamming_matrix_ref(queries, candidates)
    if queries.device.type != "cuda":
        raise ValueError(f"hamming_matrix: no kernel for device {queries.device}")
    (qn, w), c = queries.shape, candidates.shape[0]
    out = torch.empty((qn, c), dtype=torch.int32, device=queries.device)
    if out.numel() == 0:
        return out
    err = _matrix_launcher()(
        queries.data_ptr(), candidates.data_ptr(), out.data_ptr(), qn, c, w,
        torch.cuda.current_stream(queries.device).cuda_stream,
    )
    raise_on_error("hamming_matrix", err)
    count_launch(hamming_matrix)
    return out


hamming_matrix.launches = 0
