"""merge_pct.graph: share (%) of the traced graph's wall time between the
two timing events of each order's ``graph.merge`` span (each row's window
of candidates filtered by sketch and merged into its running top-k2), the
card's idle time inside the span included.  Moves rows_per_s."""

from hfbench import stages


def read(ctx):
    return stages.device_pct(ctx, "graph.merge")
