"""Per-leaf specs and placements for params, optimizer state, caches and
batches: port of ``repro.launch.shardings``.

Leaves are named as the port names them, and a leaf's spec is chosen by
its last name, with ``repro``'s rules in ``repro``'s order:

* parameters: ``Transformer.named_parameters()`` (``embed.embed``,
  ``layers.3.mixer.wq``, ``layers.3.ffn.w1``, ``enc.blocks.0.cross.wo``,
  ``patch_proj``, ...);
* a train state ``{"params", "opt": {"m", "v"[, "err"], "step"}, "step"}``:
  ``params.<name>``, ``opt.m.<name>``, ...;
* decode caches (a list of one cache a layer): ``3.k``, ``3.v``, ``3.pos``,
  ``3.cross.k``, ``5.h``, ``5.conv``.

Weight matrices shard their contraction-output dim over the model axis
(tensor parallelism) and, when ``rules.fsdp`` is set, the other dim over
the data axis (ZeRO-3).  The port keeps one module a layer, so no spec
has ``repro``'s leading ``None`` for its stacked ``blocks``.  A cache's
``pos`` is ``(B, L)`` in the port (one row a batch row) and replicated,
as ``repro``'s ``(L,)`` is.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Iterator, Tuple

import torch
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.sharding import Entry, ShardingRules, placements, validate_spec

Spec = Tuple[Entry, ...]

# last name -> the spec of a leaf of that rank
_MATRIX_RULES = [
    (re.compile(r"w[qkv]$"), lambda r: (r.fsdp, r.heads)),
    (re.compile(r"wo$"), lambda r: (r.heads, r.fsdp)),
    (re.compile(r"in_proj$"), lambda r: (r.fsdp, r.mlp)),
    (re.compile(r"out_proj$"), lambda r: (r.mlp, r.fsdp)),
    (re.compile(r"router$"), lambda r: (r.fsdp, None)),
    (re.compile(r"conv_w$"), lambda r: (None, r.mlp)),
    (re.compile(r"patch_proj$"), lambda r: (None, None)),
    # "unembed" also ends in "embed": repro's table gives it this rule too.
    (re.compile(r"embed$"), lambda r: (r.vocab, r.fsdp)),
    (re.compile(r"unembed$"), lambda r: (r.fsdp, r.vocab)),
]


def _leaf_spec(key: str, ndim: int, rules: ShardingRules) -> Spec:
    last = key.rsplit(".", 1)[-1]

    # --- caches ---
    if last in ("k", "v"):
        return (rules.batch, rules.cache_seq, rules.kv_heads, rules.kv_head_dim)[:ndim]
    if last == "pos":
        return (None,) * ndim
    if last == "h" and ndim == 4:  # SSM state (B, H, N, P)
        return (rules.batch, rules.heads, None, None)
    if last == "conv" and ndim == 3:  # SSM conv tail (B, cw - 1, C)
        return (rules.batch, None, rules.mlp)

    # --- weights ---
    for pat, fn in _MATRIX_RULES:
        if pat.search(last):
            spec = fn(rules)
            if ndim == len(spec):
                return spec
    if last in ("w1", "w3"):
        if ndim == 3:  # MoE (E, D, F): experts over the model axis when E
            # divides it, else intra-expert TP (F sharded, experts replicated)
            ftp = rules.mlp if rules.experts is None else None
            return (rules.experts, rules.fsdp, ftp)
        return (rules.fsdp, rules.mlp)
    if last == "w2":
        if ndim == 3:  # MoE (E, F, D)
            ftp = rules.mlp if rules.experts is None else None
            return (rules.experts, ftp, rules.fsdp)
        return (rules.mlp, rules.fsdp)
    # vectors and scalars (norm scales, biases, a_log, step, ...): replicated
    return (None,) * ndim


def named_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every tensor in ``tree``: a module's parameters, a
    dict's values by key, a list's items by index, a dataclass's fields."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield prefix + name, p
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}{i}.")
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from named_leaves(getattr(tree, f.name), f"{prefix}{f.name}.")


def _name(key: str) -> str:
    return key[:-1] if key.endswith(".") else key


def tree_specs(tree: Any, rules: ShardingRules) -> Dict[str, Spec]:
    """The spec of every leaf of ``tree`` (params, train state or caches)."""
    return {_name(k): _leaf_spec(_name(k), t.ndim, rules) for k, t in named_leaves(tree)}


# repro's _validate_spec: a DTensor argument must divide evenly, as a jit
# input sharding must.  shard() applies the same rule to activations.
_validate_spec = validate_spec


def _placements(name: str, t: torch.Tensor, mesh, rules: ShardingRules) -> tuple:
    return placements(mesh, _validate_spec(_leaf_spec(name, t.ndim, rules), t.shape, mesh))


def tree_shardings(tree: Any, mesh, rules: ShardingRules) -> Dict[str, tuple]:
    """The DTensor placements of every leaf of ``tree`` on ``mesh``."""
    return {_name(k): _placements(_name(k), t, mesh, rules) for k, t in named_leaves(tree)}


def batch_specs(batch: Dict[str, torch.Tensor], rules: ShardingRules) -> Dict[str, Spec]:
    """Input batches: dim 0 over the batch axes, the rest replicated."""
    return {k: (rules.batch,) + (None,) * (t.ndim - 1) for k, t in batch.items()}


def distribute_batch(batch: Dict[str, torch.Tensor], rules: ShardingRules
                     ) -> Dict[str, torch.Tensor]:
    """Input batches as DTensors placed by :func:`batch_specs` (every rank
    holding the same full batch keeps its rows)."""
    specs = batch_specs(batch, rules)
    mesh = rules.mesh
    return {k: _distribute_one(t, placements(mesh, _validate_spec(specs[k], t.shape, mesh)), mesh)
            for k, t in batch.items()}


def wants_fsdp(cfg: ModelConfig) -> bool:
    """ZeRO-3 weight sharding pays off above ~5B params."""
    return cfg.param_count() > 5e9


def _distribute_one(t: torch.Tensor, place: tuple, mesh) -> torch.Tensor:
    from torch.distributed.tensor import distribute_tensor

    # Every rank holds the same full tensor: each keeps its own shard.
    return distribute_tensor(t.detach(), mesh, place, src_data_rank=None)


def distribute(tree: Any, rules: ShardingRules, prefix: str = "") -> Any:
    """``tree`` with every tensor a DTensor on ``rules.mesh`` placed by its
    spec: a module's parameters are replaced in place (``requires_grad``
    kept), dicts, lists and cache dataclasses are rebuilt.  Every rank must
    hold the same full tensors."""
    mesh = rules.mesh
    if mesh is None:
        raise ValueError("distribute needs rules with a mesh")
    if isinstance(tree, torch.Tensor):
        return _distribute_one(tree, _placements(_name(prefix), tree, mesh, rules), mesh)
    if isinstance(tree, nn.Module):
        for mname, mod in tree.named_modules():
            for pname, p in list(mod.named_parameters(recurse=False)):
                full = prefix + (f"{mname}.{pname}" if mname else pname)
                d = _distribute_one(p, _placements(full, p, mesh, rules), mesh)
                mod.register_parameter(pname, nn.Parameter(d, requires_grad=p.requires_grad))
        return tree
    if isinstance(tree, dict):
        return {k: distribute(v, rules, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute(v, rules, f"{prefix}{i}.") for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: distribute(getattr(tree, f.name), rules, f"{prefix}{f.name}.")
            for f in dataclasses.fields(tree) if getattr(tree, f.name) is not None})
    return tree
