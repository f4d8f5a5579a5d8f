"""hamming_rows_roofline.search: the least time of stage 1's Hamming
filter in the traced call (every tree: each query's k1 candidate sketches
read by index from the resident table) over the device time of the
``hamming_rows`` kernels.  Moves search_qps."""

from hfbench import readers, work

KERNELS = ("hamming_rows_kernel",)


def read(ctx):
    c, t = ctx.config, ctx.traffic
    one = work.hamming_rows(ctx.trace_count, t["k1"], c["rows"], work.sketch_words(c["dim"]))
    return readers.roofline_pct(ctx, KERNELS, c["n_trees"] * work.least_seconds(one))
