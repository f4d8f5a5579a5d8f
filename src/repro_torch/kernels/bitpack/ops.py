"""Bit packing: the CUDA kernel's wrapper beside its plain version.

``pack_bits`` is the counterpart of ``repro.kernels.bitpack.pack_bits``
(Pallas ``pack_bits_kernel``): an (N, K) {0,1} uint8 or bool matrix to
(N, ceil(K/32)) 32-bit words held in int32, MSB first, padding bits zero.
It packs the sketches (``core/sketch.py``) and the Hilbert keys
(``core/hilbert.py``).  The kernel lives in ``repro_torch/csrc/pack_bits.cu``.

This module must not import ``repro_torch.core.sketch``: the sketch module
packs through it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._check import check, count_launch, raise_on_error

__all__ = ["pack_bits", "pack_bits_ref"]


def pack_bits_ref(bits: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: 32 shift-ORs on an int32 copy, bit 31 of word 0 first."""
    n, k = bits.shape
    w = -(-k // 32)
    b = bits.to(torch.int32)
    pad = w * 32 - k
    if pad:
        b = torch.nn.functional.pad(b, (0, pad))
    b = b.reshape(n, w, 32)
    out = b[:, :, 0] << 31
    for j in range(1, 32):
        out |= b[:, :, j] << (31 - j)
    return out


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("pack_bits").pack_bits_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, K) {0,1} uint8 or bool -> (N, ceil(K/32)) int32 words, MSB first.

    CPU tensors take :func:`pack_bits_ref`; CUDA tensors launch the kernel
    on the current stream (and count it in ``pack_bits.launches``) or raise.
    """
    if isinstance(bits, torch.Tensor) and bits.dtype == torch.bool:
        bits = bits.view(torch.uint8)
    check("bits", bits, torch.uint8, 2)
    if bits.device.type == "cpu":
        return pack_bits_ref(bits)
    if bits.device.type != "cuda":
        raise ValueError(f"pack_bits: no kernel for device {bits.device}")
    n, k = bits.shape
    out = torch.empty((n, -(-k // 32)), dtype=torch.int32, device=bits.device)
    if out.numel() == 0:
        return out
    err = _launcher()(bits.data_ptr(), out.data_ptr(), n, k,
                      torch.cuda.current_stream(bits.device).cuda_stream)
    raise_on_error("pack_bits", err)
    count_launch(pack_bits)
    return out


pack_bits.launches = 0
