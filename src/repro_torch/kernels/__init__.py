"""Hand-written Hopper kernels, each beside a plain PyTorch version.

A wrapper takes the plain version only for CPU tensors; for CUDA tensors it
launches its kernel (built from ``repro_torch/csrc`` by :mod:`._build`) or
raises.
"""
