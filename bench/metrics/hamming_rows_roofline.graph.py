"""hamming_rows_roofline.graph: the least time of Algorithm 2's sketch
filter in the traced graph (every order: each row's k1 rank neighbours
read by id from the sketch table) over the device time of the
``hamming_rows`` kernels.  Moves rows_per_s."""

from hfbench import readers, work

KERNELS = ("hamming_rows_kernel",)


def read(ctx):
    c = ctx.config
    g = c["graph"]
    one = work.hamming_rows(c["rows"], g["k1"], c["rows"], work.sketch_words(c["dim"]),
                            queries_in_table=True)
    return readers.roofline_pct(ctx, KERNELS, g["n_orders"] * work.least_seconds(one))
