"""On the card: a toy cell through the CUDA kernels, held to the reference.

Run on a machine with a card: ``python -m pytest -q bench/tests -m cuda``."""

from __future__ import annotations

import time

import pytest
import torch

from hfbench import runner


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["search", "graph", "build"])
def test_toy_cell_on_the_card_is_correct(toy_root, card, kind):
    r = runner.run(toy_root, f"toy.{kind}", 2**31 + 77, 0.2, True, card,
                   time.perf_counter())
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
