"""``BENCHMARK.json`` against the benchmark's contract, and every name in it
found as a file of its own under ``bench/``."""

from __future__ import annotations

import json
import re

import pytest

from hfbench_toy import REPO

B = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_paths():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert B["command"] == ["python3", "bench/run.py"] and B["paths"] == ["bench"]
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = B["run_seconds"]
    assert 1 <= rs <= 51 and isinstance(rs, int)
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_sources():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in B[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in B["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert [m for m in B["end_to_end"] if m["name"] == "setup_s"]


def test_every_name_is_a_file_of_its_own():
    for c in B["configs"]:
        path = REPO / c["file"]
        assert path.is_file() and c["file"].startswith("bench/configs/")
        cfg = json.loads(path.read_text())
        assert set(cfg["reduced"]) == set(c["reduced"])
    for w in B["workloads"]:
        assert (REPO / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (REPO / "bench" / "cells" / f"{w['name']}.json").is_file()
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in B["per_layer"]:
        assert (REPO / "bench" / "metrics" / f"{m['name']}.py").is_file()


@pytest.mark.parametrize("w", B["workloads"], ids=[w["name"] for w in B["workloads"]])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric(w):
    from hfbench.spec import Spec

    spec = Spec(REPO)
    e2e = {m["name"] for m in spec.end_to_end(w["name"])}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = spec.per_layer(w["name"])
    assert layers and all(m["moves"] in e2e for m in layers)



def test_every_per_layer_metric_lists_its_cells(tmp_path):
    from hfbench.spec import Spec

    assert all(m.get("workloads") for m in B["per_layer"])
    b = json.loads(json.dumps(B))
    del b["per_layer"][0]["workloads"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    with pytest.raises(ValueError, match=b["per_layer"][0]["name"]):
        Spec(tmp_path).per_layer(B["workloads"][0]["name"])


def test_every_traffic_kind_is_a_file_of_its_own():
    from hfbench.kind import Kind
    from hfbench.spec import Spec

    spec = Spec(REPO)
    for w in B["workloads"]:
        kind = spec.traffic(w["traffic"])["kind"]
        assert (REPO / "bench" / "kinds" / f"{kind}.py").is_file()
        assert issubclass(spec.kind(kind), Kind)
