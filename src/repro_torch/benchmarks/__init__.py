"""Counterparts of the repository's ``benchmarks/`` modules, on the port.

* :mod:`.kernel_bench` — the dense Hamming and dense 4-bit ADC kernels
  (``benchmarks/kernel_bench.py``);
* :mod:`.task1_table1` — the paper's Table 1 (``benchmarks/task1_table1.py``).

Each runs on the card unless the caller asks for ``device="cpu"``.
"""
