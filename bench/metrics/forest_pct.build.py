"""forest_pct.build: share (%) of the traced build's wall time spent in its
``build.forest`` phase, from the program's own span, which ends in a
device synchronize.  Moves rows_per_s."""


def read(ctx):
    forest = ctx.trace.span_seconds("build.forest").get("build.forest")
    if forest is None or ctx.trace.wall_s <= 0:
        return None
    return 100.0 * forest / ctx.trace.wall_s
