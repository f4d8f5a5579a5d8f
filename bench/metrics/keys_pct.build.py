"""keys_pct.build: share (%) of the traced build's wall time between the
two timing events of each ``hilbert.keys`` span (every row's Hilbert key,
once a tree and once for the master order), the card's idle time inside
the span included: a host stall inside the key computation counts here.
Moves rows_per_s."""

from hfbench import stages


def read(ctx):
    return stages.device_pct(ctx, "hilbert.keys")
