"""keys_pct.graph: share (%) of the traced graph's wall time between the
two timing events of each ``hilbert.keys`` span (every row's Hilbert key,
once an order), the card's idle time inside the span included.  Moves
rows_per_s."""

from hfbench import stages


def read(ctx):
    return stages.device_pct(ctx, "hilbert.keys")
