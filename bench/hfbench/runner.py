"""One run of one cell: set up, measure the window, trace, check, and the result line."""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List

import torch

from hfbench import check, profile
from hfbench.spec import Spec

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(Exception):
    """The run cannot give a result; ``code`` is its exit code."""

    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`, compared whole."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def card_facts(dev: torch.device) -> str:
    if dev.type != "cuda":
        return "device cpu (no device metric is measured)"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", str(dev.index or 0)],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable ({e})"
    return f"card {out}; peaks 3.35e12 B/s HBM, 67e12 float32 op/s (H100 SXM, 700 W)"


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, log=sys.stderr) -> Dict:
    """The result object of one run (``correct`` false when a check fails)."""
    spec = Spec(root)
    w = spec.workload(workload)
    cfg, traffic, cell = spec.config(w["config"]), spec.traffic(w["traffic"]), spec.cell(workload)
    on_card = device.type == "cuda"
    print(card_facts(device), file=log, flush=True)
    kind = spec.kind(traffic["kind"])(cfg, traffic, cell, seed, device)
    kind.setup()
    setup_s = time.perf_counter() - t_start
    setup_peak = 0
    if on_card:
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)

    t0 = time.perf_counter()
    while True:
        kind.run_unit()
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else None
    print(f"setup_s {setup_s} window_s {window_s} units {kind.units} "
          f"counts {kind.counts}", file=log, flush=True)

    measured = {"setup_s": setup_s, **kind.end_to_end(window_s)}
    metrics: Dict[str, Dict] = {}
    extra: Dict = {}
    dev_facts: Dict = {}
    if not trace:
        for m in spec.end_to_end(workload):
            if m["name"] not in measured:
                raise Refused(2, f"cell {workload} lists {m['name']}, which "
                                 f"{traffic['kind']} traffic does not measure")
            metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
    else:
        tr = profile.traced(kind.trace_call(), device, tracer=kind.p.tracer)
        ctx = SimpleNamespace(on_card=on_card, config=cfg, traffic=traffic, trace=tr,
                              trace_count=kind.trace_count, units=list(kind.units),
                              counts=list(kind.counts), window_s=window_s,
                              peak_bytes=window_peak)
        for m in spec.per_layer(workload):
            v = spec.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if on_card:
            dev_facts = {"busy_s": tr.busy_s, "window_s": tr.window_s}
            extra["breakdown"] = tr.breakdown()
        print(f"traced unit wall_s {tr.wall_s} launches {tr.launches()} "
              f"profiler {tr.cost_s} spans {tr.span_seconds('')}", file=log, flush=True)
    peak = max(setup_peak, torch.cuda.max_memory_allocated(device)) if on_card else 0

    kind.release()
    t_check = time.perf_counter()
    nums, notes = kind.check()
    correct, checks = check.verdict(nums, cell["limits"])
    notes["check_s"] = time.perf_counter() - t_check
    print("notes " + " ".join(f"{k} {v}" for k, v in notes.items()), file=log)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=log)
    log.flush()

    found = forbidden_modules()
    if found:
        raise Refused(4, "modules of JAX or of the JAX package were loaded: "
                         + ", ".join(found))
    device_out = {"platform": "gpu" if on_card else device.type,
                  "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                  "count": 1, "memory_peak_bytes": int(peak), **dev_facts}
    return {"correct": correct, "attempted": len(kind.units), "failed": 0,
            "metrics": metrics, "device": device_out, **extra,
            "checks": {k: {"value": _num(c["value"]), "limit": _num(c["limit"])}
                       for k, c in checks.items()}}


def _num(v: float):
    return v if math.isfinite(v) else str(v)


def line(result: Dict) -> str:
    return json.dumps(result, separators=(",", ":"))
