"""qdist_windows_roofline.search: the least time of stage 2's distances
in the traced call (each query's k2 windows of 2h+1 packed code rows, float32
query against 4-bit reconstruction) over the device time of the
``qdist_windows`` kernels.  Moves search_qps."""

from hfbench import readers, work

KERNELS = ("qdist_windows_kernel",)


def read(ctx):
    c, t = ctx.config, ctx.traffic
    window = min(2 * t["h"] + 1, c["rows"])
    one = work.qdist_windows(ctx.trace_count, t["k2"], window, c["dim"], c["rows"])
    return readers.roofline_pct(ctx, KERNELS, work.least_seconds(one))
