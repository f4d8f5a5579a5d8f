"""Index bundles in the ``host0.npz`` + ``manifest.json`` layout, numpy only."""
