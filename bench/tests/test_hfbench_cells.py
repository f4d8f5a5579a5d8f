"""Each kind of cell, run end to end on the CPU at a toy size through the
program's plain routes: the result line's shape, and the check held."""

from __future__ import annotations

import json
import time

import pytest
import torch

from hfbench import runner

KINDS = ("search", "graph", "build")
E2E = {"search": "search_qps", "graph": "rows_per_s", "build": "rows_per_s"}


def _run(root, kind, trace, seed=2**31 + 5):
    return runner.run(root, f"toy.{kind}", seed, 0.2, trace, torch.device("cpu"),
                      time.perf_counter())


@pytest.mark.parametrize("kind", KINDS)
def test_untraced_run_reports_end_to_end_and_passes_its_check(toy_root, kind):
    r = _run(toy_root, kind, False)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"setup_s", E2E[kind]}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert r["device"]["platform"] == "cpu"
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("kind", KINDS)
def test_traced_run_reports_no_device_metric_off_the_card(toy_root, kind):
    r = _run(toy_root, kind, True)
    assert r["correct"] is True
    assert "breakdown" not in r and "busy_s" not in r["device"]
    # Only the span-based share can be read without a card.
    assert set(r["metrics"]) <= {"forest_pct.build"}
    if kind == "build":
        assert 0 < r["metrics"]["forest_pct.build"]["value"] <= 100


def test_result_line_is_one_json_object_with_checks_last(toy_root):
    r = _run(toy_root, "search", False)
    text = runner.line(r)
    assert "\n" not in text
    back = json.loads(text)
    assert list(back)[-1] == "checks"
    assert set(back["checks"]) == {"id_miss", "dist_gap"}


def test_same_seed_gives_same_inputs_and_answers(toy_root):
    from hfbench import data
    from hfbench_toy import TOY_CONFIG

    a = data.draw(TOY_CONFIG, 10, 2**31 + 99, torch.device("cpu"))
    b = data.draw(TOY_CONFIG, 10, 2**31 + 99, torch.device("cpu"))
    c = data.draw(TOY_CONFIG, 10, 2**31 + 98, torch.device("cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
