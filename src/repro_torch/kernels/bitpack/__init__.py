from repro_torch.kernels.bitpack.ops import pack_bits, pack_bits_ref  # noqa: F401
