"""repro_torch.launch — entry-point drivers (``repro.launch``): the serving
driver and the training driver."""
