"""keys_pct.search: share (%) of the traced search call's wall time spent
computing the queries' Hilbert keys for each tree, from the program's
``search.keys`` spans, one a tree and chunk (host clock: the search is
host-bound).  Moves search_qps."""

from hfbench import stages


def read(ctx):
    return stages.wall_pct(ctx, "search.keys")
