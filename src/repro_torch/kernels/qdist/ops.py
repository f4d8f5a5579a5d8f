"""Stage-2 packed ADC distance: the CUDA kernel's wrapper beside its plain version.

``qdist_windows`` is the counterpart of
``repro.kernels.qdist.qdist_windows_from_packed`` (Pallas
``qdist_packed_windows_kernel``): fp32 queries (Q, D) against each query's
own nibble-packed candidate codes (Q, C, ceil(D/8)) and (D, 16) centroids,
giving (Q, C) fp32 squared L2.  The kernel lives in
``repro_torch/csrc/qdist_windows.cu``.  Dim ``8w + s`` is nibble ``s`` of
word ``w`` as :func:`repro_torch.core.quantize.pack_codes` writes it; the
TPU kernel's ``packed_dim_order`` permutation fed its matrix unit and has
no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._check import check, raise_on_error, same

__all__ = ["qdist_windows", "qdist_windows_ref"]

LEVELS = 16  # nibble codes


def qdist_windows_ref(queries: torch.Tensor, packed_windows: torch.Tensor,
                      centroids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: unpack, gather centroids, ``((q - r)**2).sum(-1)``."""
    d = queries.shape[1]
    shifts = torch.arange(0, 32, 4, dtype=torch.int32, device=queries.device)
    codes = (packed_windows[..., None] >> shifts) & 0xF  # (Q, C, W, 8)
    codes = codes.reshape(*packed_windows.shape[:2], -1)[..., :d]
    recon = centroids[torch.arange(d, device=queries.device), codes]  # (Q, C, D)
    return ((queries[:, None, :] - recon) ** 2).sum(-1)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("qdist_windows").qdist_windows_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    out = torch.empty((qn, c), dtype=torch.float32, device=queries.device)
    if out.numel() == 0:
        return out
    err = _launcher()(
        queries.data_ptr(), packed_windows.data_ptr(), centroids.data_ptr(),
        out.data_ptr(), qn, c, w, d,
        torch.cuda.current_stream(queries.device).cuda_stream,
    )
    raise_on_error("qdist_windows", err)
    qdist_windows.launches += 1
    return out


qdist_windows.launches = 0
