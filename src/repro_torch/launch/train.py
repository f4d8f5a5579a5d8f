"""End-to-end training driver: port of ``repro.launch.train``.

CPU smoke::

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch granite_3_8b --smoke --steps 60 --batch 8 --seq 64

On the card drop ``--device cpu``.  With ``--ckpt DIR`` the state is saved
every ``--ckpt-every`` steps by :class:`repro_torch.checkpoint.AsyncCheckpointer`
in ``repro``'s train-checkpoint layout, and a start resumes from the
newest step that verifies (corrupt steps are quarantined), bit-exact in
its inputs since the data stream is step-indexed.  Step times are
watched, and a step over 2.5x the median is logged as a straggler.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import configs
from repro_torch.checkpoint import AsyncCheckpointer, latest_verifiable_step, restore_tree
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models.convert import train_state_from_jax, train_state_to_jax
from repro_torch.optim import OptimizerConfig
from repro_torch.train.train_loop import TrainConfig, init_train_state, make_train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_3_8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "topk"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must be present)")
    args = ap.parse_args(argv)

    cfg = configs.get_config(args.arch, smoke=args.smoke)
    tcfg = TrainConfig(
        n_microbatches=args.microbatches,
        optimizer=OptimizerConfig(
            lr=args.lr, warmup_steps=max(args.steps // 10, 1),
            total_steps=args.steps, compression=args.compression,
        ),
    )
    pipe = TokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, global_batch=args.batch,
        seq_len=args.seq, seed=args.seed,
    ))
    step_fn = make_train_step(cfg, tcfg)

    start = 0
    if args.ckpt and (ls := latest_verifiable_step(args.ckpt)) is not None:
        tree, _ = restore_tree(args.ckpt, ls)
        state = train_state_from_jax(cfg, tcfg, tree, device=args.device)
        start = ls
        print(f"[resume] restored step {ls} from {args.ckpt}")
    else:
        state = init_train_state(cfg, tcfg, args.seed, device=args.device)
        print(f"[init] {cfg.name}: {cfg.param_count():,} params "
              f"({'smoke' if args.smoke else 'full'})")
    device = state["params"].device

    ckpt = AsyncCheckpointer(args.ckpt) if args.ckpt else None
    times = []
    for s in range(start, args.steps):
        t0 = time.time()
        state, m = step_fn(state, pipe.torch_batch(s, device))
        loss = float(m["loss"])
        dt = time.time() - t0
        times.append(dt)
        if len(times) > 5:
            p50 = float(np.median(times[3:]))
            if dt > 2.5 * p50:
                print(f"[straggler] step {s} took {dt:.2f}s ({dt/p50:.1f}x p50)")
        if s % 10 == 0 or s == args.steps - 1:
            print(f"step {s:5d}  loss {loss:.4f}  gnorm {float(m['grad_norm']):.3f} "
                  f" lr {float(m['lr']):.2e}  {dt:.2f}s")
        if ckpt and (s + 1) % args.ckpt_every == 0:
            ckpt.save(s + 1, train_state_to_jax(cfg, state))
    if ckpt:
        ckpt.save(args.steps, train_state_to_jax(cfg, state))
        ckpt.wait()
        print(f"[ckpt] final state at {ckpt.last_path}")
    if times:
        print(f"[done] median step {np.median(times):.2f}s")


if __name__ == "__main__":
    main()
