"""Bundles in the ``host0.npz`` + ``manifest.json`` layout (index state and
nested train states) and the write-ahead log."""

from repro_torch.checkpoint.bundle import (  # noqa: F401
    AsyncCheckpointer,
    CorruptBundleError,
    latest_step,
    latest_verifiable_step,
    restore_tree,
)
