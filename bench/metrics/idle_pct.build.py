"""idle_pct.build: share (%) of the traced build unit in which no kernel, copy or
set ran on the card (profiler, CPU and CUDA activity).  Moves rows_per_s."""

from hfbench.readers import idle_pct as read  # noqa: F401
