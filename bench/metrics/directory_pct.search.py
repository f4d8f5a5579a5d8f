"""directory_pct.search: share (%) of the traced search call's wall time
spent in the directory search (each query's key looked up in each tree's
directory by a lexicographic binary search), from the program's
``search.directory`` spans, one a tree and chunk (host clock).  Moves
search_qps."""

from hfbench import stages


def read(ctx):
    return stages.wall_pct(ctx, "search.directory")
