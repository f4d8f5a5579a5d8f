"""Shared set-up of the harness's tests: ``bench/`` and ``src/`` on the path,
and a toy checkout whose cells run on the CPU in seconds."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (REPO / "src", REPO / "bench", REPO / "bench" / "tests"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from hfbench_toy import make_toy_root  # noqa: E402


@pytest.fixture(scope="session")
def toy_root(tmp_path_factory) -> Path:
    return make_toy_root(tmp_path_factory.mktemp("hfbench"))


@pytest.fixture(autouse=True)
def _only_what_the_run_loads(monkeypatch):
    """In a pytest process shared with the JAX package's own tests, JAX is
    already loaded; the run's check still refuses anything loaded after
    the test began."""
    from hfbench import runner

    found = runner.forbidden_modules
    before = set(found())
    monkeypatch.setattr(runner, "forbidden_modules",
                        lambda: [m for m in found() if m not in before])
