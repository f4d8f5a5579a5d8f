"""path_roofline.search: the least time of every search call of the
window (``work.search_path``: each tree's table reads and Hamming
operations, stage 2's code reads and distance operations), over the
window's wall time (host clock).  It counts the same work whatever
implements the search.  Moves search_qps."""

from hfbench import work


def read(ctx):
    c, t = ctx.config, ctx.traffic
    if not ctx.on_card:
        return None
    per_call = work.search_path(t["batch"], c["rows"], c["dim"], c["n_trees"], t["k1"],
                                t["k2"], t["h"], t["k"])
    return 100.0 * per_call * sum(ctx.counts) / t["batch"] / ctx.window_s
