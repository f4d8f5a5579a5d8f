"""Later cells, configurations and per-layer metrics come as files only; the
harness's arithmetic of work and traces; and the command's refusals."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch

from hfbench_toy import REPO
from hfbench import profile, runner, work

TOY_METRIC = '''"""toy_forest_s.build: seconds of the traced build's forest phase."""


def read(ctx):
    return ctx.trace.span_seconds("build.forest").get("build.forest")
'''


def test_a_new_metric_and_cell_added_as_files_only(toy_root, tmp_path):
    # The toy configuration, traffic and cells of the fixture are new files
    # beside the real ones; one more per-layer metric is another new file.
    root = tmp_path / "root"
    import shutil

    shutil.copytree(toy_root, root)
    (root / "bench" / "metrics" / "toy_forest_s.build.py").write_text(TOY_METRIC)
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "toy_forest_s.build", "unit": "s", "better": "lower",
                           "source": "program_span", "layer": "core",
                           "moves": "rows_per_s", "workloads": ["toy.build"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    for p in (REPO / "bench").rglob("*"):
        if p.is_file() and "tests" not in p.parts and "__pycache__" not in p.parts:
            assert (root / p.relative_to(REPO)).read_bytes() == p.read_bytes()
    r = runner.run(root, "toy.build", 41, 0.1, True, torch.device("cpu"),
                   time.perf_counter())
    assert r["correct"] and r["metrics"]["toy_forest_s.build"]["value"] > 0


TOY_KIND = '''"""toy_tail: the search kind, also reporting its calls' 95th percentile."""

from pathlib import Path

from hfbench import kind

Search = kind.load(Path(__file__).parent, "search")


class TailKind(Search):
    def end_to_end(self, window_s):
        s = sorted(self.units)
        return {**super().end_to_end(window_s),
                "call_p95_ms": 1e3 * s[min(len(s) - 1, int(0.95 * len(s)))]}


KIND = TailKind
'''


def test_a_new_kind_and_end_to_end_metric_added_as_files_only(toy_root, tmp_path):
    # A new kind of traffic is a file under bench/kinds; its traffic mix and
    # its cell are files too; only BENCHMARK.json gains entries.
    root = tmp_path / "root"
    import shutil

    shutil.copytree(toy_root, root)
    bench = root / "bench"
    (bench / "kinds" / "toy_tail.py").write_text(TOY_KIND)
    tr = json.loads((bench / "traffic" / "toy_search.json").read_text())
    (bench / "traffic" / "toy_tail.json").write_text(json.dumps({**tr, "kind": "toy_tail"}))
    (bench / "cells" / "toy.tail.json").write_text(
        (bench / "cells" / "toy.search.json").read_text())
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "toy.tail", "config": "toy", "traffic": "toy_tail",
                           "chips": 1, "why": "toy"})
    for m in b["end_to_end"]:
        if m["name"] == "search_qps":
            m["workloads"].append("toy.tail")
    b["end_to_end"].append({"name": "call_p95_ms", "unit": "ms", "better": "lower",
                            "bound": 0.1, "source": "host_clock", "workloads": ["toy.tail"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    for p in (REPO / "bench").rglob("*"):
        if p.is_file() and "tests" not in p.parts and "__pycache__" not in p.parts:
            assert (root / p.relative_to(REPO)).read_bytes() == p.read_bytes()
    r = runner.run(root, "toy.tail", 43, 0.1, False, torch.device("cpu"),
                   time.perf_counter())
    assert r["correct"] and set(r["metrics"]) == {"setup_s", "search_qps", "call_p95_ms"}
    assert r["metrics"]["call_p95_ms"]["value"] > 0


def test_work_counts():
    n_bytes, ops = work.hamming_rows(2, 3, 10**9, 12)
    assert ops == 3 * 2 * 3 * 12
    assert n_bytes == pytest.approx(4 * 12 * 2 + 4 * 12 * 6 + 4 * 2 * 3 * 2, rel=1e-6)
    assert work.pack_bits(10, 448) == (10 * 448 + 10 * 14 * 4, 0.0)
    assert work.least_seconds((3.35e12, 0.0)) == pytest.approx(1.0)
    assert work.least_seconds((0.0, 67e12)) == pytest.approx(1.0)
    assert work.distinct_rows(100, 1e9) == pytest.approx(100)


def test_trace_busy_idle_and_breakdown():
    dev = [("k_a", 100, 200), ("k_a", 150, 300), ("Memcpy DtoD", 500, 600), ("k_b", 900, 950)]
    host = [("aten::sort", 290, 560), ("cudaLaunchKernel", 700, 890)]
    t = profile.Trace(dev, host, (0, 1000), [("build.forest", 0.5)], 1.0)
    assert t.busy_s == pytest.approx(350e-9)
    assert t.launches() == 3 and t.kernel_seconds(["k_a"]) == pytest.approx(250e-9)
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["k_a", pytest.approx(250e-9)]
    gaps = dict(bd["idle_gaps"])
    assert gaps["aten::sort"] == pytest.approx(200e-9)
    assert gaps["cudaLaunchKernel"] == pytest.approx(300e-9)
    assert gaps["python"] == pytest.approx(150e-9)


def test_command_refuses_without_a_card_and_prints_no_result():
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", "pubmed23_120t.search",
                        "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode == 3 and p.stdout == ""


def test_command_refuses_an_unknown_cell():
    p = subprocess.run([sys.executable, "bench/run.py", "--workload", "no.such",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 2 and p.stdout == ""
