"""The benchmark harness of the Hilbert forest's PyTorch and CUDA port.

``bench/run.py`` runs one cell of ``BENCHMARK.json``; everything one
configuration, one traffic mix, one kind of traffic, one cell's check or one
per-layer metric needs lives in a file of its own under ``bench/configs``,
``bench/traffic``, ``bench/kinds``, ``bench/cells`` and ``bench/metrics``,
found by its name.
"""
