"""Roofline table from the dry run's records: port of ``repro.launch.roofline``.

Per (arch x shape) of one mesh: the three terms in seconds (compute =
FLOPs / 989 TFLOP/s, memory = HBM bytes / 3.35 TB/s, collective = each
mesh axis's bytes over its link: 450 GB/s NVLink for the model axis, 50
GB/s InfiniBand for data and pod; every numerator is per device, so the
GPU count divides out), the dominant term, MODEL_FLOPS / (FLOPs x GPUs),
the peak bytes a GPU and a one-line lever for the dominant term.  These
are estimates on fake ranks against the H100 SXM5 data sheet
(``repro_torch.launch.dryrun``), not measurements on a cluster.

    python -m repro_torch.launch.roofline --dir results/dryrun_torch [--mesh multi]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict

MOVE_HINTS = {
    "compute_term_s": "cut replicated/padded compute (heads that do not divide, remat)",
    "memory_term_s": "fuse the eager ops (every intermediate goes through HBM)",
    "collective_term_s": "re-shard to drop resharding collectives / overlap them",
}


def load(dir_: str) -> Dict:
    recs = {}
    for f in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    return recs


def fmt_row(r) -> str:
    if r["status"] == "skipped":
        return (f"| {r['arch']} | {r['shape']} | — | — | — | — | skipped | — | "
                f"{r['reason'][:58]} |")
    if r["status"] != "ok":
        return (f"| {r['arch']} | {r['shape']} | — | — | — | — | ERROR | — | "
                f"{r.get('reason', 'see json').split(':')[0][:58]} |")
    c, m, k = r["compute_term_s"], r["memory_term_s"], r["collective_term_s"]
    dom = r["dominant_term"]
    peak = r["memory"]["peak_bytes"] / 2**30
    return (f"| {r['arch']} | {r['shape']} | {c:.3g} | {m:.3g} | {k:.3g} "
            f"| {peak:.3g} | {dom.split('_')[0]} | {r['useful_flops_ratio']:.2f} "
            f"| {MOVE_HINTS[dom][:58]} |")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    args = ap.parse_args(argv)
    recs = load(args.dir)
    print("| arch | shape | compute s | memory s | collective s | peak GiB/GPU | dominant "
          "| useful-FLOP ratio | lever |")
    print("|---|---|---|---|---|---|---|---|---|")
    for (a, s, m), r in sorted(recs.items()):
        if m == args.mesh:
            print(fmt_row(r))
    counts = {"ok": 0, "skipped": 0, "error": 0}
    for (a, s, m), r in recs.items():
        if m == args.mesh:
            counts[r["status"] if r["status"] in counts else "error"] += 1
    print(f"\n{args.mesh} mesh: {counts['ok']} ok, {counts['skipped']} skipped "
          f"(inapplicable), {counts['error']} errors")


if __name__ == "__main__":
    main()
