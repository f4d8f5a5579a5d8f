from repro_torch.kernels.bitpack.ops import pack_bits, pack_bits_ref, vec_ok  # noqa: F401
