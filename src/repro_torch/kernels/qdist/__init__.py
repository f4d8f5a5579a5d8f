from repro_torch.kernels.qdist.ops import (  # noqa: F401
    qdist,
    qdist_from_packed,
    qdist_packed_ref,
    qdist_u8_ref,
    qdist_windows,
    qdist_windows_ref,
    qdist_windows_rows,
    qdist_windows_rows_ref,
    window_rows,
)
