"""launches_per_query.search: device kernels launched in the traced search
call (profiler count), per query it answered.  Moves search_qps."""

from hfbench.readers import launches_per as read  # noqa: F401
