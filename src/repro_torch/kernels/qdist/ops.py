"""Asymmetric 4-bit distances: the CUDA kernels' wrappers beside their plain versions.

``qdist_windows`` is the counterpart of
``repro.kernels.qdist.qdist_windows_from_packed`` (Pallas
``qdist_packed_windows_kernel``): fp32 queries (Q, D) against each query's
own nibble-packed candidate codes (Q, C, ceil(D/8)) and (D, 16) centroids,
giving (Q, C) fp32 squared L2.  ``qdist_windows_rows`` computes the same
function of the candidates that stage 2 reads by window: rows
``starts[q, s] + i`` (i < L) of the resident (n, ceil(D/8)) codes, with no
(Q, C, ceil(D/8)) block built.  One kernel serves both
(``repro_torch/csrc/qdist_windows.cu``); both wrappers count its launches
in ``qdist_windows.launches``.  Dim ``8w + s`` is nibble ``s`` of word
``w`` as :func:`repro_torch.core.quantize.pack_codes` writes it; the TPU
kernel's ``packed_dim_order`` permutation fed its matrix unit and has no
counterpart here.

``qdist`` and ``qdist_from_packed`` are the counterparts of
``repro.kernels.qdist.qdist`` and ``qdist_from_packed`` (Pallas
``qdist_u8_kernel`` and ``qdist_packed_kernel``): fp32 queries (Q, D)
against codes shared by every query, (C, D) uint8 or nibble-packed
(C, ceil(D/8)), and (D, L) centroids, giving the dense (Q, C) fp32
matrix.  Both kernels live in ``repro_torch/csrc/qdist_dense.cu``, one
launcher each.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._check import check, count_launch, raise_on_error, same

__all__ = ["qdist_windows", "qdist_windows_ref", "qdist_windows_rows",
           "qdist_windows_rows_ref", "window_rows", "qdist", "qdist_u8_ref",
           "qdist_from_packed", "qdist_packed_ref"]

LEVELS = 16  # nibble codes

# Elements of the (rows, C, D) difference block one step of the dense
# plain versions builds: the bench shape (512 x 16384 x 384) would need
# 12.9 GB at once.
_REF_ELEMS = 1 << 25


def qdist_windows_ref(queries: torch.Tensor, packed_windows: torch.Tensor,
                      centroids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: unpack, gather centroids, ``((q - r)**2).sum(-1)``."""
    d = queries.shape[1]
    shifts = torch.arange(0, 32, 4, dtype=torch.int32, device=queries.device)
    codes = (packed_windows[..., None] >> shifts) & 0xF  # (Q, C, W, 8)
    codes = codes.reshape(*packed_windows.shape[:2], -1)[..., :d]
    recon = centroids[torch.arange(d, device=queries.device), codes]  # (Q, C, D)
    return ((queries[:, None, :] - recon) ** 2).sum(-1)


def window_rows(rows: torch.Tensor, starts: torch.Tensor, window: int
                ) -> torch.Tensor:
    """Read (Q, S) contiguous row windows: (n, W) -> (Q, S, window, W)."""
    idx = starts[:, :, None] + torch.arange(
        window, dtype=starts.dtype, device=starts.device)
    return rows[idx]


def qdist_windows_rows_ref(queries: torch.Tensor, codes_packed: torch.Tensor,
                           starts: torch.Tensor, window: int,
                           centroids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: :func:`window_rows`, then :func:`qdist_windows_ref`."""
    qn, s = starts.shape
    win = window_rows(codes_packed, starts, window)
    return qdist_windows_ref(queries, win.reshape(qn, s * window, -1), centroids)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.library("qdist_windows")
    fn = lib.qdist_windows_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    scratch = lib.qdist_windows_scratch_floats
    scratch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
    scratch.restype = ctypes.c_longlong
    return fn, scratch


def _launch_windows(queries, rows, starts, n_s: int, window: int, centroids):
    """Allocate (Q, S * window), launch the windows kernel, count it.

    ``starts`` None is the pre-gathered layout: row ``q * S * window + c``.
    Above D = 3,200 the kernel walks the dims in tiles and carries its
    partial sums in a scratch buffer, which the launcher sizes and this
    allocates.
    """
    qn, d = queries.shape
    out = torch.empty((qn, n_s * window), dtype=torch.float32, device=queries.device)
    if out.numel() == 0:
        return out
    launch, scratch_floats = _launcher()
    n_scratch = scratch_floats(d, qn, n_s * window)
    scratch = (torch.empty((n_scratch,), dtype=torch.float32, device=queries.device)
               if n_scratch else None)
    err = launch(
        queries.data_ptr(), rows.data_ptr(),
        None if starts is None else starts.data_ptr(), centroids.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        qn, n_s, window, d, rows.shape[0],
        torch.cuda.current_stream(queries.device).cuda_stream,
    )
    raise_on_error("qdist_windows", err)
    count_launch(qdist_windows)
    return out


def qdist_windows(queries: torch.Tensor, packed_windows: torch.Tensor,
                  centroids: torch.Tensor) -> torch.Tensor:
    """(Q, D) f32 x (Q, C, ceil(D/8)) int32 words x (D, 16) f32 -> (Q, C) f32.

    CPU tensors take :func:`qdist_windows_ref`; CUDA tensors launch the
    kernel on the current stream (and count it in
    ``qdist_windows.launches``) or raise.
    """
    check("queries", queries, torch.float32, 2)
    check("packed_windows", packed_windows, torch.int32, 3, queries.device)
    check("centroids", centroids, torch.float32, 2, queries.device)
    qn, d = queries.shape
    _, c, w = packed_windows.shape
    same("packed_windows (Q, W)", (packed_windows.shape[0], w), (qn, -(-d // 8)))
    same("centroids", centroids.shape, (d, LEVELS))
    if queries.device.type == "cpu":
        return qdist_windows_ref(queries, packed_windows, centroids)
    if queries.device.type != "cuda":
        raise ValueError(f"qdist_windows: no kernel for device {queries.device}")
    return _launch_windows(queries, packed_windows.view(qn * c, w), None, c, 1,
                           centroids)


def qdist_windows_rows(queries: torch.Tensor, codes_packed: torch.Tensor,
                       starts: torch.Tensor, window: int,
                       centroids: torch.Tensor) -> torch.Tensor:
    """(Q, D) f32 x rows (n, ceil(D/8)) int32 x starts (Q, S) int32 x (D, 16)
    f32 -> (Q, S * window) f32.

    Candidate ``c`` of query ``q`` is row ``starts[q, c // window] + c %
    window`` of ``codes_packed``.  Callers must clamp ``starts`` to ``[0, n -
    window]``, as the search's ``_expand_windows`` does: the plain version
    raises on a row outside ``[0, n)``, but the kernel does not check
    ``starts`` on the host and gives such a row NaN, which a top-k ranks
    last, so on CUDA a bad start loses its candidates without an error.
    CPU tensors take :func:`qdist_windows_rows_ref`; CUDA tensors launch the
    windows kernel on the current stream (and count it in
    ``qdist_windows.launches``) or raise.
    """
    check("queries", queries, torch.float32, 2)
    check("codes_packed", codes_packed, torch.int32, 2, queries.device)
    check("starts", starts, torch.int32, 2, queries.device)
    check("centroids", centroids, torch.float32, 2, queries.device)
    qn, d = queries.shape
    same("codes_packed W", codes_packed.shape[1:], (-(-d // 8),))
    same("starts Q", starts.shape[:1], (qn,))
    same("centroids", centroids.shape, (d, LEVELS))
    if not isinstance(window, int) or window < 1:
        raise ValueError(f"window: {window!r}, expected an int >= 1")
    if queries.device.type == "cpu":
        return qdist_windows_rows_ref(queries, codes_packed, starts, window, centroids)
    if queries.device.type != "cuda":
        raise ValueError(f"qdist_windows_rows: no kernel for device {queries.device}")
    return _launch_windows(queries, codes_packed, starts, starts.shape[1], window,
                           centroids)


qdist_windows.launches = 0


def _dense_ref(queries: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
    """``((q - r)**2).sum(-1)`` of every query against every (C, D) row of
    ``recon``, a block of query rows at a time."""
    qn, c = queries.shape[0], recon.shape[0]
    step = max(1, _REF_ELEMS // max(1, c * recon.shape[1]))
    out = torch.empty((qn, c), dtype=torch.float32, device=queries.device)
    for s in range(0, qn, step):
        out[s : s + step] = ((queries[s : s + step, None, :] - recon[None]) ** 2).sum(-1)
    return out


def qdist_u8_ref(queries: torch.Tensor, codes: torch.Tensor,
                 centroids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather centroids, ``((q - r)**2).sum(-1)``."""
    dims = torch.arange(codes.shape[1], device=codes.device)
    return _dense_ref(queries, centroids[dims, codes.long()])


def qdist_packed_ref(queries: torch.Tensor, packed: torch.Tensor,
                     centroids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: unpack the nibbles, then :func:`qdist_u8_ref`."""
    d = queries.shape[1]
    shifts = torch.arange(0, 32, 4, dtype=torch.int32, device=packed.device)
    codes = ((packed[..., None] >> shifts) & 0xF).reshape(packed.shape[0], -1)[:, :d]
    return qdist_u8_ref(queries, codes, centroids)


@functools.lru_cache(maxsize=None)
def _dense_launcher(name: str):
    fn = getattr(_build.library("qdist_dense"), name)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_dense(wrapper, launcher: str, queries, codes, centroids):
    """Allocate (Q, C), launch ``launcher`` on the current stream, count it."""
    (qn, d), c = queries.shape, codes.shape[0]
    out = torch.empty((qn, c), dtype=torch.float32, device=queries.device)
    if out.numel() == 0:
        return out
    err = _dense_launcher(launcher)(
        queries.data_ptr(), codes.data_ptr(), centroids.data_ptr(), out.data_ptr(),
        qn, c, d, centroids.shape[1],
        torch.cuda.current_stream(queries.device).cuda_stream,
    )
    raise_on_error(wrapper.__name__, err)
    count_launch(wrapper)
    return out


def qdist(queries: torch.Tensor, codes: torch.Tensor,
          centroids: torch.Tensor) -> torch.Tensor:
    """(Q, D) f32 x (C, D) uint8 codes x (D, L) f32 -> (Q, C) f32 squared L2.

    L is ``centroids.shape[1]``.  CPU tensors take :func:`qdist_u8_ref`;
    CUDA tensors launch the kernel on the current stream (and count it in
    ``qdist.launches``) or raise.
    """
    check("queries", queries, torch.float32, 2)
    check("codes", codes, torch.uint8, 2, queries.device)
    check("centroids", centroids, torch.float32, 2, queries.device)
    d = queries.shape[1]
    same("codes D", codes.shape[1:], (d,))
    same("centroids D", centroids.shape[:1], (d,))
    if centroids.shape[1] < 1:
        raise ValueError("centroids: at least one level")
    if queries.device.type == "cpu":
        return qdist_u8_ref(queries, codes, centroids)
    if queries.device.type != "cuda":
        raise ValueError(f"qdist: no kernel for device {queries.device}")
    return _launch_dense(qdist, "qdist_u8_launch", queries, codes, centroids)


def qdist_from_packed(queries: torch.Tensor, packed: torch.Tensor,
                      centroids: torch.Tensor) -> torch.Tensor:
    """(Q, D) f32 x (C, ceil(D/8)) int32 words x (D, 16) f32 -> (Q, C) f32.

    CPU tensors take :func:`qdist_packed_ref`; CUDA tensors launch the
    kernel on the current stream (and count it in
    ``qdist_from_packed.launches``) or raise.
    """
    check("queries", queries, torch.float32, 2)
    check("packed", packed, torch.int32, 2, queries.device)
    check("centroids", centroids, torch.float32, 2, queries.device)
    d = queries.shape[1]
    same("packed W", packed.shape[1:], (-(-d // 8),))
    same("centroids", centroids.shape, (d, LEVELS))
    if queries.device.type == "cpu":
        return qdist_packed_ref(queries, packed, centroids)
    if queries.device.type != "cuda":
        raise ValueError(f"qdist_from_packed: no kernel for device {queries.device}")
    return _launch_dense(qdist_from_packed, "qdist_packed_launch", queries, packed,
                         centroids)


qdist.launches = 0
qdist_from_packed.launches = 0
