from repro_torch.kernels.qdist.ops import qdist_windows, qdist_windows_ref  # noqa: F401
