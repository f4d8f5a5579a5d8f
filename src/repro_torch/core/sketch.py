"""Binary sketches = the shared MSBs of the 4-bit quantizer (paper §3.1).

Port of ``repro.core.sketch``.  Bit i of a sketch is ``x_i >= median_i``,
packed MSB-first into int32 words that hold the JAX package's uint32 bits.
Hamming distance = XOR + popcount over the words.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantize import Quantizer
from repro_torch.kernels import bitpack

__all__ = [
    "sketch_words",
    "pack_bits",
    "make_sketches",
    "sketches_from_codes",
    "popcount32",
    "hamming_distance",
]


def sketch_words(d: int) -> int:
    return -(-d // 32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack (n, d) {0,1} into (n, ceil(d/32)) int32, bit 31 of word 0 first.

    Routes through :func:`repro_torch.kernels.bitpack.pack_bits` (the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor).
    """
    return bitpack.pack_bits(bits.contiguous())


def make_sketches(quant: Quantizer, x: torch.Tensor) -> torch.Tensor:
    """Sketch fp vectors directly: bit i = x_i >= median_i (packed words)."""
    levels = quant.centroids.shape[1]
    median = quant.boundaries[:, levels // 2 - 1]  # quantile 1/2
    return pack_bits(x >= median[None, :])


def sketches_from_codes(codes: torch.Tensor, bits: int = 4) -> torch.Tensor:
    """Sketch = code MSB (the shared bit); exact alias of make_sketches."""
    return pack_bits(codes >= (1 << (bits - 1)))


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 bit patterns) -> int64 counts.

    SWAR popcount (Hacker's Delight 5-2) on the int64-widened unsigned
    value, so no step overflows.
    """
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distance between packed sketches.

    a: (..., W), b: (..., W) int32 words (broadcastable) -> (...) int32.
    The plain form; ``repro_torch.kernels.hamming`` holds the CUDA kernel of
    the batched per-query contract.
    """
    return popcount32(a ^ b).sum(-1).to(torch.int32)
