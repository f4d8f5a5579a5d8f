"""launches_per_row.graph: device kernels launched in the traced graph
(profiler count), per row graphed.  Moves rows_per_s."""

from hfbench.readers import launches_per as read  # noqa: F401
