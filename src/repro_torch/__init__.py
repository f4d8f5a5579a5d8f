"""Hilbert Forest in PyTorch + CUDA: the H100 port of the ``repro`` package.

The layout mirrors ``repro`` module for module (``core/hilbert.py``,
``index/facade.py``, ``kernels/qdist/...``) so each module's counterpart is
easy to find.  Nothing here imports jax or ``repro``: shared pure-numpy
pieces (configs, synthetic data, the bundle reader) are copied, not
imported.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise rather than carry on quietly on the CPU.
"""

__version__ = "0.1.0"
