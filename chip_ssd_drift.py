#!/usr/bin/env python3
"""How far three fp32 evaluation orders of a Mamba-2 stack drift apart on one NVIDIA GPU.

mamba2_780m at its published widths (random weights from ``--seed``), cut
to each depth of ``--layers``, TF32 off, on one sequence of 1,024 tokens:

* ``forward``: the chunked SSD over all 1,024 tokens;
* ``prefill_decode``: a prefill of 1,016 tokens, then 8 decode steps;
* ``recurrence``: decode steps from position 0 (the per-token recurrence
  alone), at depths up to ``--recurrence-max-layers``.

For each of the last 8 positions it prints the largest difference of the
logits between each pair, as one JSON line a depth, then the card's name
and power limit.  The three compute the same map; where all pairs differ
by similar amounts, none of them is the faulty one and what is left is
rounding.  ``chip_smoke.py``'s full-width phases set their prefill +
decode tolerance from it.

    python3 chip_ssd_drift.py [--layers 4 48] [--seed 0]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SEQ, PREFILL = 1024, 1016


def drift(torch, layers: int, seed: int, recurrence: bool) -> dict:
    from repro_torch import configs
    from repro_torch.models.model import init_params

    cfg = dataclasses.replace(configs.get_config("mamba2_780m"), n_layers=layers,
                              compute_dtype="float32")
    model = init_params(cfg, seed, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (1, SEQ), generator=g, device="cuda")
    out = {"forward": model(toks)[0, PREFILL:]}
    _, caches = model.prefill(toks[:, :PREFILL])
    steps = []
    for t in range(PREFILL, SEQ):
        logits, caches = model.decode_step(toks[:, t : t + 1], t, caches)
        steps.append(logits[0])
    out["prefill_decode"] = torch.stack(steps)
    if recurrence:
        caches = model.make_decode_caches(1, SEQ, dtype=torch.float32)
        steps = []
        for t in range(SEQ):
            logits, caches = model.decode_step(toks[:, t : t + 1], t, caches)
            if t >= PREFILL:
                steps.append(logits[0])
        out["recurrence"] = torch.stack(steps)
    names = list(out)
    pairs = {f"{a}_vs_{b}": (out[a] - out[b]).abs().amax(dim=1).tolist()
             for i, a in enumerate(names) for b in names[i + 1 :]}
    return {"arch": cfg.name, "layers": layers, "positions": [PREFILL, SEQ - 1],
            "logits_max_abs": float(out["forward"].abs().max()), "max_abs_diff": pairs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[4, 48])
    ap.add_argument("--recurrence-max-layers", type=int, default=4,
                    help="run the recurrence from position 0 up to this depth "
                         "(1,024 decode steps a depth)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_ssd_drift: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for layers in args.layers:
        res = drift(torch, layers, args.seed, layers <= args.recurrence_max_layers)
        print(json.dumps(res), flush=True)
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
