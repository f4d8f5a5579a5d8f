"""The control: the reference in bfloat16 fails each cell's limits, where the
reference as configured passes them (toy sizes, the CPU)."""

from __future__ import annotations

import pytest
import torch

from hfbench import check
from hfbench.spec import Spec


@pytest.mark.parametrize("kind", ["search", "graph", "build"])
def test_bfloat16_control_fails_the_cells_limits(toy_root, kind):
    import control

    got = control.readings(toy_root, f"toy.{kind}", 2**31 + 17, torch.device("cpu"))
    limits = Spec(toy_root).cell(f"toy.{kind}")["limits"]
    ok, _ = check.verdict(got, limits)
    assert not ok, got
