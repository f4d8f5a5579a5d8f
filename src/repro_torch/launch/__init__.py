"""repro_torch.launch — entry-point drivers and the distribution layer
(``repro.launch``): the serving and training drivers, the device meshes,
per-leaf placements, the multi-host bootstrap, the dry run and the
roofline."""
