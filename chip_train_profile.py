#!/usr/bin/env python3
"""Profile one train step of ``chip_smoke.py``'s two training cells on one NVIDIA GPU.

gemma3_1b (bf16, remat "minimal") and granite_moe_1b (bf16, capacity
1.25) at their published widths, random weights from ``--seed``: ``--steps``
train steps of 8 x 1,024 tokens in 2 microbatches as phases
``train_full_width`` and ``moe_full_width`` take them, then one more under
``torch.profiler`` with CPU ops recorded.  Prints the card's name and
power limit, then one JSON line a cell (phases ``train_full_width_profile``
and ``moe_train_profile``): the step's wall and device ms, the device's
busy share, the kernels and the launching ops with the most device time.
The profiler's host overhead lengthens the wall time, so the busy share
is a lower bound.  Without a GPU it prints no result and exits 2.

    python3 chip_train_profile.py [--steps 3] [--seed 0]
"""

from __future__ import annotations

import argparse
import gc
import sys

import chip_smoke


def profile_cell(torch, cfg, steps: int, seed: int, phase: str) -> None:
    from repro_torch.optim import OptimizerConfig
    from repro_torch.train import TrainConfig

    tcfg = TrainConfig(n_microbatches=chip_smoke.TRAIN_MICRO, optimizer=OptimizerConfig(
        lr=chip_smoke.TRAIN_LR, warmup_steps=1, total_steps=steps + 1))
    run = chip_smoke.train_steps(torch, cfg, tcfg, seed, steps)
    batch = run["pipe"].torch_batch(steps, "cuda")
    chip_smoke.phase_profile(torch, lambda: run["step"](run["state"], batch), phase,
                             cpu_ops=True, tokens=int(batch["tokens"].numel()),
                             ms_per_step_before=run["ms"])
    del run
    gc.collect()
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3, help="train steps before the profiled one")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_train_profile: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, chip_smoke.SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import configs

    chip_smoke.phase_device()
    profile_cell(torch, configs.get_config(chip_smoke.LM_ARCH), args.steps, args.seed,
                 "train_full_width_profile")
    profile_cell(torch, configs.get_config(chip_smoke.MOE_ARCH), args.steps, args.seed,
                 "moe_train_profile")
    return 0


if __name__ == "__main__":
    sys.exit(main())
