"""Weights of ``repro``'s model tree as the port's state dict.

``params_from_jax(cfg, params)`` takes the tree of
``repro.models.model.init_params`` with its leaves as numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``), unstacks each ``blocks[s]`` leaf's
leading ``n_blocks`` axis into layers ``b * pattern_len + s``, maps the
tail after them, and returns the state dict of
:class:`repro_torch.models.model.Transformer`.  The tests use it to run
both packages on the same weights.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.models.config import NONE, ModelConfig
from repro_torch.models.model import _check_supported


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _norm(state: Dict, prefix: str, p: Dict, take: Callable) -> None:
    state[prefix + "scale"] = _tensor(take(p["scale"]))
    if "bias" in p:
        state[prefix + "bias"] = _tensor(take(p["bias"]))


def _layer(state: Dict, prefix: str, ffn: str, lp: Dict, take: Callable) -> None:
    _norm(state, prefix + "norm1.", lp["norm1"], take)
    for name, leaf in lp["mixer"].items():
        state[f"{prefix}mixer.{name}"] = _tensor(take(leaf))
    if ffn != NONE:
        _norm(state, prefix + "norm2.", lp["norm2"], take)
        for name, leaf in lp["ffn"].items():
            state[f"{prefix}ffn.{name}"] = _tensor(take(leaf))


def params_from_jax(cfg: ModelConfig, params: Dict) -> Dict[str, torch.Tensor]:
    """``repro``'s parameter tree (numpy leaves) -> the port's state dict."""
    _check_supported(cfg)
    state: Dict[str, torch.Tensor] = {"embed.embed": _tensor(params["embed"]["embed"])}
    if not cfg.tie_embeddings:
        state["embed.unembed"] = _tensor(params["embed"]["unembed"])
    _norm(state, "final_norm.", params["final_norm"], lambda a: a)
    p = cfg.pattern_len
    for s, spec in enumerate(cfg.pattern):
        for b in range(cfg.n_blocks):
            _layer(state, f"layers.{b * p + s}.", spec.ffn, params["blocks"][s],
                   lambda a, b=b: np.asarray(a)[b])
    for j, spec in enumerate(cfg.tail_specs):
        _layer(state, f"layers.{cfg.n_blocks * p + j}.", spec.ffn, params["tail"][j],
               lambda a: a)
    return state
