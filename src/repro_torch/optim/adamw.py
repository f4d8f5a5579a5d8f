"""AdamW with dtype-configurable moments and error-feedback compression.

Port of ``repro.optim.adamw``.  Parameters, gradients and moments are
dicts of tensors keyed by parameter name (``Transformer.named_parameters``);
:func:`apply_updates` updates the parameters and the state in place, with
``repro``'s expressions term by term in float32:

* the global gradient norm, then a clip scale ``min(1, clip / (norm + 1e-9))``;
* ``compression="bf16"`` sends ``acc = g + err`` rounded to bf16,
  ``"topk"`` the entries of ``acc`` at or above the k-th largest ``|acc|``
  of the leaf (a threshold that no tie order changes); the residual
  ``acc - sent`` is carried in ``err`` to the next step;
* ``m, v`` updated in float32 and stored in ``moment_dtype``; the step
  ``mhat / (sqrt(vhat) + eps) + wd * p`` with bias-corrected moments, times
  the learning rate of :func:`lr_at` (linear warmup, cosine decay).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple

import torch

Tensors = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"     # "bfloat16" halves the moments' memory
    compression: str = "none"          # none | bf16 | topk
    topk_frac: float = 0.05


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_frac * lr``, in float32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_opt_state(params: Tensors, cfg: OptimizerConfig) -> Dict:
    """``{"m", "v", "step"}`` (+ ``"err"`` under compression), zeros."""
    mdt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32
    dev = next(iter(params.values())).device

    def zeros(dtype):
        return {k: torch.zeros(p.shape, dtype=dtype, device=p.device)
                for k, p in params.items()}

    state = {"m": zeros(mdt), "v": zeros(mdt),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.compression in ("bf16", "topk"):
        state["err"] = zeros(torch.float32)
    return state


def _global_norm(grads: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))


def _compress(cfg: OptimizerConfig, g: torch.Tensor, err: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback compression of one gradient leaf: (sent, new err)."""
    acc = g.float() + err
    if cfg.compression == "bf16":
        sent = acc.to(torch.bfloat16).float()
    else:  # top-k by magnitude, per leaf
        k = max(1, int(cfg.topk_frac * acc.numel()))
        thresh = torch.topk(acc.abs().reshape(-1), k).values[-1]
        sent = torch.where(acc.abs() >= thresh, acc, 0.0)
    return sent, acc - sent


@torch.no_grad()
def apply_updates(params: Tensors, grads: Tensors, state: Dict,
                  cfg: OptimizerConfig) -> Tuple[Tensors, Dict, Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns (params, state, metrics) as
    ``repro`` does; ``metrics`` holds ``grad_norm`` and ``lr``."""
    step = state["step"] + 1
    gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    for name, p in params.items():
        g = grads[name].float() * scale
        if cfg.compression in ("bf16", "topk"):
            g, err = _compress(cfg, g, state["err"][name])
            state["err"][name].copy_(err)
        m, v = state["m"][name], state["v"][name]
        mf = m.float() * cfg.b1 + (1 - cfg.b1) * g
        vf = v.float() * cfg.b2 + (1 - cfg.b2) * g * g
        mhat = mf / b1c
        vhat = vf / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(mf)
        v.copy_(vf)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
