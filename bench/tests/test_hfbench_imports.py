"""Nothing under ``bench/`` imports JAX or the JAX package, and the reference
imports nothing of the program.  Top-level module names are compared whole:
``repro_torch`` begins with ``repro`` and is the program, not the JAX package."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_top_level_imports(path)) & FORBIDDEN


def test_whole_name_comparison_tells_the_port_from_the_jax_package():
    from hfbench.runner import FORBIDDEN as RUN_FORBIDDEN, forbidden_modules

    assert "repro_torch".split(".")[0] not in RUN_FORBIDDEN
    assert "repro" in RUN_FORBIDDEN and "jax" in RUN_FORBIDDEN
    assert not [m for m in forbidden_modules() if m.startswith("repro_torch")]


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        names = set(_top_level_imports(path))
        assert not names & (FORBIDDEN | {"repro_torch", "hfbench"}), path


def test_nothing_reads_the_repository_benchmarks_folder():
    for path in SOURCES:
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert '"benchmarks' not in text and "'benchmarks" not in text, path


def test_a_run_that_loads_jax_gives_no_result(toy_root, monkeypatch):
    import sys
    import time
    import types

    import torch

    from hfbench import runner

    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    with pytest.raises(runner.Refused) as e:
        runner.run(toy_root, "toy.build", 5, 0.05, False, torch.device("cpu"),
                   time.perf_counter())
    assert e.value.code == 4 and "flax" in str(e.value)
