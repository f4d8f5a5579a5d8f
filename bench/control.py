"""The control of a cell's check: the plain reference against itself in a lower precision.

    python bench/control.py --workload <name> --seeds 11,12,13 [--device cuda]

For each seed the cell's kind (``bench/kinds/<kind>.py``, its ``control``)
draws the cell's inputs as a run does, computes the reference as configured
and the reference with its distance inputs (the build: its points) rounded
to bfloat16, and this prints the check's numbers of the second against the
first, one JSON line per seed.  A limit has to lie
below the smallest of these readings; the program's own runs give the
lower readings.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench")]

import torch  # noqa: E402

from hfbench.spec import Spec  # noqa: E402


def readings(root: Path, workload: str, seed: int, device: torch.device) -> dict:
    """The check's numbers of the bfloat16 control against the reference."""
    spec = Spec(root)
    w = spec.workload(workload)
    cfg, tr, cell = spec.config(w["config"]), spec.traffic(w["traffic"]), spec.cell(workload)
    return spec.kind(tr["kind"]).control(cfg, tr, cell, seed, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Readings of a cell's bfloat16 control.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    for s in args.seeds.split(","):
        t = time.perf_counter()
        r = readings(ROOT, args.workload, int(s), dev)
        print(json.dumps({"workload": args.workload, "seed": int(s), "control": r,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
