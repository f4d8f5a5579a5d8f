"""Run one cell of the benchmark once and print its result line.

    python bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout (the directory that holds ``BENCHMARK.json``
and ``src/repro_torch``), on a machine with the cards the cell asks for.
The last line of standard output is the result object; the numbers the
check compared, each beside its limit, are the last lines of standard error.
Exit codes: 0 a result was printed; 2 a bad argument or cell; 3 no CUDA
card, or fewer than the cell needs; 4 JAX or the JAX package was loaded;
5 the program is not in this checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Every build and kernel cache of the program stays at a fixed path in the checkout.
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", required=True, type=int)
    ap.add_argument("--seconds", required=True, type=float)
    ap.add_argument("--trace", required=True, type=int, choices=(0, 1))
    args = ap.parse_args(argv)

    from hfbench.runner import Refused, line, run
    from hfbench.spec import Spec

    try:
        chips = Spec(ROOT).workload(args.workload)["chips"]
    except (KeyError, OSError, ValueError) as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "available", file=sys.stderr)
        return 3
    try:
        import repro_torch
    except ImportError as e:
        print(f"bench: the program is not in this checkout: {e}", file=sys.stderr)
        return 5
    if not Path(repro_torch.__file__).resolve().is_relative_to(ROOT / "src"):
        print(f"bench: repro_torch was found outside the checkout "
              f"({repro_torch.__file__})", file=sys.stderr)
        return 5
    try:
        result = run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), T_START)
    except Refused as e:
        print(f"bench: {e}", file=sys.stderr)
        return e.code
    sys.stderr.flush()
    print(line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
