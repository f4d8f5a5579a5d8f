"""``repro``'s model and train-state trees as the port's tensors, and back.

``repro`` keeps a model as a tree: ``embed``, ``final_norm``, ``blocks``
(one subtree a pattern position, each leaf stacked over the ``n_blocks``
blocks), ``tail`` (one subtree a remainder layer) and, where the config
has them, ``enc`` (``blocks``, one subtree whose leaves are stacked over
the ``n_enc_layers`` encoder layers, and ``final_norm``) and
``patch_proj``.  The port keeps one module a layer: block b, pattern
position s is layer ``b * pattern_len + s``, then the tail; encoder
layer j is ``enc.blocks.j``.  A layer's leaves keep ``repro``'s names
(``mixer.in_proj`` of an SSM, ``norm_cross`` and ``cross`` of a
cross-attention).  Leaves are numpy arrays (e.g. ``jax.tree.map(
np.asarray, params)``, or what :func:`repro_torch.checkpoint.restore_tree`
reads); a bf16 leaf may be an ``ml_dtypes`` array or the 2-byte void
array ``np.load`` gives without ``ml_dtypes``, and is read by its bits.

* :func:`params_from_jax`: the model tree -> the state dict of
  :class:`repro_torch.models.model.Transformer` (every config).
* :func:`caches_from_jax`: ``repro``'s decode caches (``{"blocks",
  "tail"}`` of ``{"mixer", "cross"}`` a layer) -> the port's list of one
  cache a layer, so decode can be held to ``repro``'s from one state.
* :func:`train_state_from_jax` / :func:`train_state_to_jax`: ``repro``'s
  train state ``{"params", "opt": {"m", "v", "step"[, "err"]}, "step"}``
  <-> the port's (:mod:`repro_torch.train.train_loop`).  The trees this
  side writes hold fresh host copies, bf16 moments as exact float32.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.bundle import host_copy
from repro_torch.index.facade import DeviceLike, resolve_device
from repro_torch.models.config import ATTN, ModelConfig
from repro_torch.models.layers import AttnCache, compute_dtype
from repro_torch.models.model import Caches, Transformer, layer_specs
from repro_torch.models.ssm import SSMCache


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


def _layer_of(cfg: ModelConfig, name: str) -> Tuple[tuple, Optional[int], int]:
    """A port parameter name -> (its path in ``repro``'s tree, its index in
    the stacked leaf or None, the length of that stack)."""
    parts = tuple(name.split("."))
    if parts[:2] == ("enc", "blocks"):
        return ("enc", "blocks") + parts[3:], int(parts[2]), cfg.n_enc_layers
    if parts[0] != "layers":
        return parts, None, 0
    i, rest = int(parts[1]), parts[2:]
    p = cfg.pattern_len
    if i < cfg.n_blocks * p:
        return ("blocks", i % p) + rest, i // p, cfg.n_blocks
    return ("tail", i - cfg.n_blocks * p) + rest, None, 0


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
        elif path[:2] == ("enc", "blocks"):
            leaf = np.asarray(leaf)
            for j in range(cfg.n_enc_layers):
                state[f"enc.blocks.{j}.{rest}"] = _tensor(leaf[j], dtype)
        else:
            state[".".join(path)] = _tensor(leaf, dtype)
    return state


def _to_tree(cfg: ModelConfig, tensors: Dict[str, torch.Tensor]) -> Dict:
    stacked: Dict[tuple, list] = {}
    flat: Dict[tuple, np.ndarray] = {}
    for name, t in tensors.items():
        path, b, n = _layer_of(cfg, name)
        if b is None:
            flat[path] = host_copy(t)
        else:
            stacked.setdefault(path, [None] * n)[b] = host_copy(t)
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
    return _from_tree(cfg, params)


def _attn_cache(c, dtype, dev, cross=None) -> AttnCache:
    k, v = (_tensor(a, dtype).to(dev) for a in (c.k, c.v))
    pos = torch.from_numpy(np.array(c.pos, np.int32)).to(dev)
    return AttnCache(k=k, v=v, pos=pos[None].expand(k.shape[0], -1).contiguous(),
                     cross=cross)


def caches_from_jax(cfg: ModelConfig, caches: Dict, *, device: DeviceLike = None
                    ) -> Caches:
    """``repro``'s decode caches (numpy leaves, e.g. ``jax.tree.map(np.asarray,
    caches)``) -> the port's, one a layer, on ``device``.

    Attention caches (k, v in the compute dtype; ``repro``'s one ``pos`` row
    repeated for each batch row), their cross caches, and SSM caches
    (``h`` fp32; ``conv`` in its dtype in ``repro``, bf16 after
    ``repro``'s prefill, so the port's decode rounds each new window as
    ``repro``'s does)."""
    dev, dtype, p = resolve_device(device), compute_dtype(cfg), cfg.pattern_len
    out: List = []
    for i, spec in enumerate(layer_specs(cfg)):
        if i < cfg.n_blocks * p:
            c = caches["blocks"][i % p]
            pick = lambda a, b=i // p: np.asarray(a)[b]  # noqa: E731
        else:
            c = caches["tail"][i - cfg.n_blocks * p]
            pick = np.asarray

        def take(x):
            if isinstance(x, dict):
                return {k: pick(v) for k, v in x.items()}
            return AttnCache(k=pick(x.k), v=pick(x.v), pos=pick(x.pos))

        mixer = take(c["mixer"])
        if spec.mixer == ATTN:
            cross = (_attn_cache(take(c["cross"]), dtype, dev) if spec.cross_attn
                     else None)
            out.append(_attn_cache(mixer, dtype, dev, cross))
        else:
            conv = np.asarray(mixer["conv"])
            bf16 = conv.dtype.itemsize == 2
            out.append(SSMCache(h=_tensor(mixer["h"]).to(dev),
                                conv=_tensor(conv, torch.bfloat16 if bf16 else dtype)
                                .to(dev)))
    return out


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
