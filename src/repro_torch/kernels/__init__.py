"""Hand-written Hopper kernels, each beside a plain PyTorch version.

A wrapper takes the plain version only for CPU tensors; for CUDA tensors it
launches its kernel (built from ``repro_torch/csrc`` by :mod:`._build`) or
raises.

* :mod:`.hamming`: ``hamming_rows`` and ``hamming_rows_indexed`` (stage-1
  filter on per-query candidates, pre-gathered or read by index from the
  resident sketches) and ``hamming_matrix`` (dense);
* :mod:`.qdist`: ``qdist_windows`` and ``qdist_windows_rows`` (stage-2 ADC
  on per-query windows, pre-gathered or read from the resident codes),
  ``qdist`` (dense, uint8 codes) and ``qdist_from_packed`` (dense,
  nibble-packed codes);
* :mod:`.bitpack`: ``pack_bits`` (sketches and Hilbert keys).
"""
