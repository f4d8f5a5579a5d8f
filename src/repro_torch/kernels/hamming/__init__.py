from repro_torch.kernels.hamming.ops import (  # noqa: F401
    hamming_matrix,
    hamming_matrix_ref,
    hamming_rows,
    hamming_rows_indexed,
    hamming_rows_indexed_ref,
    hamming_rows_ref,
)
