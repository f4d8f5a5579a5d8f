"""merge_pct.search: share (%) of the traced search call's wall time spent
merging each tree's candidates into the running deduplicated top-k2, from
the program's ``search.merge`` spans, one a tree and chunk (host clock).
Moves search_qps."""

from hfbench import stages


def read(ctx):
    return stages.wall_pct(ctx, "search.merge")
