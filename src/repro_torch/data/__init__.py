"""Synthetic ANN datasets (numpy copies of ``repro.data`` plus a device
generator) and the synthetic LM token stream (``data.pipeline``)."""
