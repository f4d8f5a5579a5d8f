"""directory_launches_per_query.search: kernel launches (the profiler's host
launch calls) that start inside the program's ``search.directory`` ranges
in the traced search call, per query it answered.  Moves search_qps."""

from hfbench import stages


def read(ctx):
    return stages.launches_per(ctx, "search.directory")
