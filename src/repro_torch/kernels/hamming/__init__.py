from repro_torch.kernels.hamming.ops import hamming_rows, hamming_rows_ref  # noqa: F401
