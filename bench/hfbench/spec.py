"""Find a cell's files by the names in ``BENCHMARK.json``.

* ``bench/configs/<config>.json``: the deployment (sizes, forest and graph
  settings, the source, what was cut and what was assumed);
* ``bench/traffic/<traffic>.json``: the traffic mix, read by its ``kind``;
* ``bench/kinds/<kind>.py``: a kind of traffic, ``KIND`` (see ``hfbench.kind``);
* ``bench/cells/<workload>.json``: how many answers the check samples and
  the limit of each number it compares;
* ``bench/metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

from hfbench import kind


class Spec:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "bench"

    def workload(self, name: str) -> Dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def _json(self, sub: str, name: str) -> Dict:
        return json.loads((self.dir / sub / f"{name}.json").read_text())

    def config(self, name: str) -> Dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> Dict:
        return self._json("traffic", name)

    def cell(self, name: str) -> Dict:
        return self._json("cells", name)

    def end_to_end(self, workload: str) -> List[Dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[Dict]:
        """The per-layer metrics that list this cell under ``workloads``; every
        per-layer entry has to list its cells."""
        missing = [m["name"] for m in self.bench["per_layer"] if "workloads" not in m]
        if missing:
            raise ValueError(f"per-layer metrics without a workloads list: {missing}")
        return [m for m in self.bench["per_layer"] if workload in m["workloads"]]

    def kind(self, name: str) -> type:
        return kind.load(self.dir / "kinds", name)

    def reader(self, metric: str) -> ModuleType:
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"hfbench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
