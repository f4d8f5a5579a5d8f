"""Deterministic fault injection for durability testing.

See :mod:`repro_torch.testing.faults` for the injection-point API.
"""

from .faults import (  # noqa: F401
    FaultInjected,
    fault_point,
    install_plan,
    parse_plan,
    registered_points,
    reset,
)
