"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def check(name: str, x: torch.Tensor, dtype: torch.dtype, ndim: int,
          device: Optional[torch.device] = None) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of rank ``ndim``
    (on ``device``, when given)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(x).__name__}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected rank {ndim}")
    if device is not None and x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device} like the first argument")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def same(what: str, got: Sequence[int], want: Sequence[int]) -> None:
    if tuple(got) != tuple(want):
        raise ValueError(f"{what}: {tuple(got)} != {tuple(want)}")


def raise_on_error(kernel: str, err: int) -> None:
    """Raise if a launcher returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {err}")
