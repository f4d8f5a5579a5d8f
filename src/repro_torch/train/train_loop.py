"""Train step: microbatch gradient accumulation + AdamW.

Port of ``repro.train.train_loop``.  A train state is a dict
``{"params": Transformer, "opt": optimizer state, "step": int32 tensor}``;
the optimizer state's moments are keyed by the model's parameter names.
``make_train_step(cfg, tcfg)`` returns ``(state, batch) -> (state,
metrics)``: the batch's rows split into ``n_microbatches`` consecutive
microbatches (``repro``'s ``_split_micro``), each one's gradients taken
with ``torch.autograd.grad`` and summed in ``accum_dtype`` (bf16
included, as ``repro`` sums them), then divided by n and cast to fp32;
the loss is the mean over microbatches.  The update is in place.

With ``rules`` that carry a mesh the parameters, moments and batch are
DTensors (:mod:`repro_torch.launch.shardings`): each rank splits its own
rows into the microbatches (microbatch i holds rows [i b/n, (i+1) b/n) of
every rank's b rows), and the loss runs under those rules.
:func:`abstract_train_state` is the state on the ``meta`` device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.index.facade import DeviceLike
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptimizerConfig, apply_updates, init_opt_state
from repro_torch.sharding import ShardingRules

TrainState = Dict[str, Any]  # {"params": Transformer, "opt", "step"}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_microbatches: int = 1
    accum_dtype: str = "float32"   # "bfloat16" sums microbatch gradients in bf16
    optimizer: OptimizerConfig = OptimizerConfig()


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, seed: int = 0, *,
                     device: DeviceLike = None) -> TrainState:
    """The model of :func:`~repro_torch.models.model.init_params` with its
    weights trainable, zero optimizer state and step 0, on ``device``
    (``cuda`` unless the caller passes ``device="cpu"``)."""
    m = model.init_params(cfg, seed, device=device)
    m.requires_grad_(True)
    return {
        "params": m,
        "opt": init_opt_state(dict(m.named_parameters()), tcfg.optimizer),
        "step": torch.zeros((), dtype=torch.int32, device=m.device),
    }


def abstract_train_state(cfg: ModelConfig, tcfg: TrainConfig) -> TrainState:
    """The train state's shapes and dtypes on the ``meta`` device (no memory)."""
    m = model.abstract_params(cfg)
    m.requires_grad_(True)
    return {"params": m, "opt": init_opt_state(dict(m.named_parameters()), tcfg.optimizer),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def _micro(v: torch.Tensor, n: int, i: int) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    if isinstance(v, DTensor):  # split this rank's rows
        local = _micro(v.to_local(), n, i)
        return DTensor.from_local(local, v.device_mesh, v.placements, run_check=False)
    return v.reshape(n, v.shape[0] // n, *v.shape[1:])[i]


def _split_micro(batch: Dict[str, torch.Tensor], n: int):
    """Microbatch i of n: rows [i B/n, (i+1) B/n) of every entry."""
    return [{k: _micro(v, n, i) for k, v in batch.items()} for i in range(n)]


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, rules: ShardingRules = ShardingRules()):
    adt = torch.bfloat16 if tcfg.accum_dtype == "bfloat16" else torch.float32

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        m = state["params"]
        names, params = zip(*m.named_parameters())
        n = tcfg.n_microbatches
        try:
            if n == 1:
                loss = model.train_loss(m, batch, rules)
                grads = torch.autograd.grad(loss, params)
                loss = loss.detach()
            else:
                gsum = [torch.zeros_like(p, dtype=adt) for p in params]
                lsum = torch.zeros((), dtype=torch.float32, device=m.device)
                for mb in _split_micro(batch, n):
                    loss = model.train_loss(m, mb, rules)
                    for acc, g in zip(gsum, torch.autograd.grad(loss, params)):
                        acc.add_(g.to(adt))
                    lsum = lsum + loss.detach()
                grads = [(g / n).float() for g in gsum]
                loss = lsum / n
        finally:
            m.release_step()
        _, opt, metrics = apply_updates(dict(zip(names, params)), dict(zip(names, grads)),
                                        state["opt"], tcfg.optimizer)
        metrics["loss"] = loss
        return {"params": m, "opt": opt, "step": state["step"] + 1}, metrics

    return train_step
