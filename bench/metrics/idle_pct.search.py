"""idle_pct.search: share (%) of the traced search unit in which no kernel, copy or
set ran on the card (profiler, CPU and CUDA activity).  Moves search_qps."""

from hfbench.readers import idle_pct as read  # noqa: F401
