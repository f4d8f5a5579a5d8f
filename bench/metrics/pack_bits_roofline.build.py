"""pack_bits_roofline.build: the least time of the traced build's bit
packing (every tree's and the master order's Hilbert keys, key_bits bytes a
row; the sketches, dim bytes a row) over the device time of the
``pack_bits`` kernels.  Moves rows_per_s."""

from hfbench import readers, work

KERNELS = ("pack_bits_kernel",)


def read(ctx):
    c = ctx.config
    n = c["rows"]
    least = ((c["n_trees"] + 1) * work.least_seconds(work.pack_bits(n, c["key_bits"]))
             + work.least_seconds(work.pack_bits(n, c["dim"])))
    return readers.roofline_pct(ctx, KERNELS, least)
