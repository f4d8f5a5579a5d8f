"""``repro``'s model and train-state trees as the port's tensors, and back.

``repro`` keeps a model as a tree: ``embed``, ``final_norm``, ``blocks``
(one subtree a pattern position, each leaf stacked over the ``n_blocks``
blocks) and ``tail`` (one subtree a remainder layer).  The port keeps one
module a layer: block b, pattern position s is layer ``b * pattern_len +
s``, then the tail.  Leaves are numpy arrays (e.g. ``jax.tree.map(
np.asarray, params)``, or what :func:`repro_torch.checkpoint.restore_tree`
reads); a bf16 leaf may be an ``ml_dtypes`` array or the 2-byte void
array ``np.load`` gives without ``ml_dtypes``, and is read by its bits.

* :func:`params_from_jax`: the model tree -> the state dict of
  :class:`repro_torch.models.model.Transformer` (dense and MoE leaves
  alike).
* :func:`train_state_from_jax` / :func:`train_state_to_jax`: ``repro``'s
  train state ``{"params", "opt": {"m", "v", "step"[, "err"]}, "step"}``
  <-> the port's (:mod:`repro_torch.train.train_loop`).  The trees this
  side writes hold fresh host copies, bf16 moments as exact float32.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.bundle import host_copy
from repro_torch.index.facade import DeviceLike
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Transformer, _check_supported


def _tensor(a, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:  # bfloat16 by its bits
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        return t.view(torch.bfloat16).to(dtype)
    return torch.from_numpy(np.array(a)).to(dtype)


def _leaves(tree, path=()) -> Iterator[Tuple[tuple, object]]:
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _layer_of(cfg: ModelConfig, name: str) -> Tuple[tuple, Optional[int]]:
    """A port parameter name -> (its path in ``repro``'s tree, its block
    index in the stacked leaf, or None)."""
    parts = tuple(name.split("."))
    if parts[0] != "layers":
        return parts, None
    i, rest = int(parts[1]), parts[2:]
    p = cfg.pattern_len
    if i < cfg.n_blocks * p:
        return ("blocks", i % p) + rest, i // p
    return ("tail", i - cfg.n_blocks * p) + rest, None


def _from_tree(cfg: ModelConfig, tree: Dict, dtype: torch.dtype = torch.float32
               ) -> Dict[str, torch.Tensor]:
    p = cfg.pattern_len
    state: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(tree):
        rest = ".".join(map(str, path[2:]))
        if path[0] == "blocks":
            leaf = np.asarray(leaf)
            for b in range(cfg.n_blocks):
                state[f"layers.{b * p + path[1]}.{rest}"] = _tensor(leaf[b], dtype)
        elif path[0] == "tail":
            state[f"layers.{cfg.n_blocks * p + path[1]}.{rest}"] = _tensor(leaf, dtype)
        else:
            state[".".join(path)] = _tensor(leaf, dtype)
    return state


def _to_tree(cfg: ModelConfig, tensors: Dict[str, torch.Tensor]) -> Dict:
    stacked: Dict[tuple, list] = {}
    flat: Dict[tuple, np.ndarray] = {}
    for name, t in tensors.items():
        path, b = _layer_of(cfg, name)
        if b is None:
            flat[path] = host_copy(t)
        else:
            stacked.setdefault(path, [None] * cfg.n_blocks)[b] = host_copy(t)
    flat.update({path: np.stack(per_block) for path, per_block in stacked.items()})
    tree: Dict = {}
    for path, leaf in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    for key, n in (("blocks", cfg.pattern_len if cfg.n_blocks else 0),
                   ("tail", len(cfg.tail_specs))):
        tree[key] = [tree.get(key, {})[i] for i in range(n)]
    return tree


def params_from_jax(cfg: ModelConfig, params: Dict) -> Dict[str, torch.Tensor]:
    """``repro``'s parameter tree (numpy leaves) -> the port's state dict."""
    _check_supported(cfg)
    return _from_tree(cfg, params)


def train_state_to_jax(cfg: ModelConfig, state: Dict) -> Dict:
    """The port's train state -> ``repro``'s train-state tree of fresh numpy
    copies (what :class:`repro_torch.checkpoint.AsyncCheckpointer` writes)."""
    opt = state["opt"]
    out = {k: _to_tree(cfg, opt[k]) for k in ("m", "v", "err") if k in opt}
    out["step"] = host_copy(opt["step"])
    return {"params": _to_tree(cfg, dict(state["params"].named_parameters())),
            "opt": out, "step": host_copy(state["step"])}


def train_state_from_jax(cfg: ModelConfig, tcfg, state: Dict, *,
                         device: DeviceLike = None) -> Dict:
    """``repro``'s train-state tree -> the port's train state on ``device``,
    moments in ``tcfg.optimizer.moment_dtype`` (the dtype ``repro``'s
    ``abstract_train_state`` gives them)."""
    model = Transformer(cfg, device=device)
    model.load_state_dict(params_from_jax(cfg, state["params"]))
    model.requires_grad_(True)
    dev = model.device
    mdt = torch.bfloat16 if tcfg.optimizer.moment_dtype == "bfloat16" else torch.float32
    opt = {"step": _tensor(state["opt"]["step"], torch.int32).to(dev)}
    for key, dtype in (("m", mdt), ("v", mdt), ("err", torch.float32)):
        if key in state["opt"]:
            opt[key] = {k: v.to(dev) for k, v in _from_tree(cfg, state["opt"][key],
                                                             dtype).items()}
    return {"params": model, "opt": opt,
            "step": _tensor(state["step"], torch.int32).to(dev)}
