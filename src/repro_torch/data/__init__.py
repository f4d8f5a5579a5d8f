"""Synthetic ANN datasets (numpy copies of ``repro.data`` plus a device generator)."""
