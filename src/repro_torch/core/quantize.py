"""4-bit quantile quantization with the paper's shared sketch bit.

Port of ``repro.core.quantize``.  A per-dimension 16-level quantile grid
(cell boundaries at quantiles k/16), so that ``code >= 8 <=> x >= median``
and the code's MSB *is* the sketch bit.  Queries are never quantized:
final distances are fp32 query against dequantized (centroid) rows.

Packed words are ``torch.int32`` tensors holding the bits of the JAX
package's ``uint32`` words (torch's CPU kernels refuse shifts and compares
on ``uint32``); they are viewed as ``np.uint32`` only at the bundle
boundary.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "Quantizer",
    "fit",
    "encode",
    "decode",
    "adc_distance",
    "adc_distance_packed",
    "pack_codes",
    "unpack_codes",
]

# Rows per pass of the row-chunked build stages: bounds the transients at
# full width (3M x 384) to a few hundred MB each.
ROW_CHUNK = 1 << 18


class Quantizer(NamedTuple):
    """Per-dim quantile grid.

    boundaries: (d, L-1) float32 — interior cell boundaries (quantiles k/L).
    centroids: (d, L) float32 — per-cell reconstruction values.
    """

    boundaries: torch.Tensor
    centroids: torch.Tensor

    @property
    def bits(self) -> int:
        return int(np.log2(self.centroids.shape[1]))


def _quantile_linear(a_sorted: torch.Tensor, qs: np.ndarray) -> torch.Tensor:
    """``jnp.quantile(a, qs, axis=0)`` (method "linear") on column-sorted ``a``.

    Follows jax's arithmetic step for step in float32 — ``q·(n-1)``, floor
    and ceil, weights ``hw = q - lo`` and ``1 - hw`` — so the fit is
    bit-equal to the JAX package's; ``torch.quantile`` differs by one ulp
    on about 12% of entries.  XLA:CPU contracts the final
    ``a[lo]·lw + a[hi]·hw`` into ``fma(a[lo], lw, round(a[hi]·hw))``.  The
    product of two float32 values is exact in float64, so the float64 sum
    rounded to float32 gives the fused result, the same on every device,
    except where rounding first to float64 lands on a float32 tie (never
    met in the parity tests).
    """
    m = a_sorted.shape[0]
    dev = a_sorted.device
    q = torch.as_tensor(qs, dtype=torch.float32, device=dev) * torch.tensor(
        float(m - 1), dtype=torch.float32, device=dev
    )
    lo = torch.floor(q)
    hi = torch.ceil(q)
    hw = q - lo
    lw = 1.0 - hw
    lo_v = a_sorted[lo.long().clamp(0, m - 1)]
    hi_v = a_sorted[hi.long().clamp(0, m - 1)]
    hi_term = (hi_v * hw[:, None]).double()
    return (lo_v.double() * lw[:, None].double() + hi_term).float()


def fit(data: torch.Tensor, bits: int = 4, sample_limit: int = 262144) -> Quantizer:
    """Fit per-dimension quantile boundaries/centroids on (a sample of) data.

    The subsample is ``np.random.default_rng(0).choice`` as in the JAX
    package, so both packages fit on the same rows.
    """
    n = data.shape[0]
    if n > sample_limit:
        idx = np.random.default_rng(0).choice(n, sample_limit, replace=False)
        data = data[torch.as_tensor(idx, device=data.device)]
    levels = 1 << bits
    # Exactly the float32 values jnp.arange(1, L) / L and (arange(L)+.5) / L.
    qs_b = np.arange(1, levels, dtype=np.float32) / np.float32(levels)
    qs_c = (np.arange(levels, dtype=np.float32) + np.float32(0.5)) / np.float32(levels)
    a_sorted = torch.sort(data.to(torch.float32), dim=0).values
    boundaries = _quantile_linear(a_sorted, qs_b).T.contiguous()  # (d, L-1)
    centroids = _quantile_linear(a_sorted, qs_c).T.contiguous()  # (d, L)
    return Quantizer(boundaries, centroids)


def encode(quant: Quantizer, x: torch.Tensor) -> torch.Tensor:
    """Quantize (n, d) floats to (n, d) uint8 codes: ``#{boundaries <= x}``.

    One compare per interior boundary, accumulated in uint8, over row
    chunks (the (n, d, L-1) broadcast of the JAX form is 17 GB at 3M x 384).
    """
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    for s in range(0, x.shape[0], ROW_CHUNK):
        xc = x[s : s + ROW_CHUNK]
        code = torch.zeros(xc.shape, dtype=torch.uint8, device=x.device)
        for level in range(quant.boundaries.shape[1]):
            code += xc >= quant.boundaries[:, level]
        out[s : s + ROW_CHUNK] = code
    return out


def _recon(quant: Quantizer, codes: torch.Tensor) -> torch.Tensor:
    """Centroid lookup: (..., d) codes -> (..., d) float32."""
    d = quant.centroids.shape[0]
    dims = torch.arange(d, device=codes.device)
    return quant.centroids[dims, codes.to(torch.int32)]


def decode(quant: Quantizer, codes: torch.Tensor) -> torch.Tensor:
    """Reconstruct (n, d) float32 from uint8 codes via centroid lookup."""
    return _recon(quant, codes)


def adc_distance(quant: Quantizer, queries: torch.Tensor, codes: torch.Tensor
                 ) -> torch.Tensor:
    """Asymmetric squared-L2: fp32 queries (q, d) vs codes (q, c, d) -> (q, c)."""
    diff = queries[:, None, :] - _recon(quant, codes)
    return (diff * diff).sum(-1)


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """Pack (n, d) 4-bit codes into (n, ceil(d/8)) int32 words.

    Dim ``8w + s`` goes to nibble ``s`` (bits 4s..4s+3) of word ``w``, as
    in the JAX package; the resident stage-2 layout.
    """
    n, d = codes.shape
    pad = (-d) % 8
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad))
    c = codes.reshape(n, -1, 8)
    out = c[:, :, 0].to(torch.int32)
    for s in range(1, 8):
        out |= c[:, :, s].to(torch.int32) << (4 * s)
    return out


def unpack_codes(packed: torch.Tensor, d: int) -> torch.Tensor:
    """Inverse of :func:`pack_codes` on any leading shape: (..., W) -> (..., d) uint8."""
    w = packed.shape[-1]
    shifts = torch.arange(0, 32, 4, dtype=torch.int32, device=packed.device)
    c = (packed[..., None] >> shifts) & 0xF
    return c.reshape(*packed.shape[:-1], w * 8)[..., :d].to(torch.uint8)


def adc_distance_packed(quant: Quantizer, queries: torch.Tensor,
                        packed: torch.Tensor, *, d: int) -> torch.Tensor:
    """:func:`adc_distance` on nibble-packed candidate codes (q, c, W)."""
    return adc_distance(quant, queries, unpack_codes(packed, d))
