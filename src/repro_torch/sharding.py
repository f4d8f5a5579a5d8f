"""Logical-axis sharding rules: port of ``repro.sharding``.

Tensors are annotated with *logical* axis names; a rules table maps each
logical name to a mesh axis (or a tuple of them, or None = replicated)
per deployment.  :class:`ShardingRules` has ``repro``'s fields and
defaults; ``mesh`` holds a ``torch.distributed.device_mesh.DeviceMesh``
(None: no mesh, every path runs on plain tensors).

* :meth:`ShardingRules.spec` gives a plain tuple of mesh-axis entries, the
  counterpart of a ``PartitionSpec``;
* :func:`placements` turns such a spec into DTensor placements
  (``Shard(d)`` / ``Replicate()``, one a mesh dimension), the counterpart
  of ``named_sharding``;
* :func:`shard` is the counterpart of ``with_sharding_constraint``: a
  DTensor is redistributed to the rules' placements, with an axis that
  does not divide its dim dropped (GSPMD pads such a dim; a DTensor
  cannot view an unevenly sharded one); a plain tensor, or any tensor
  under rules without a mesh, comes back unchanged.

Logical vocabulary (as ``repro``'s): batch, seq, d_model, heads,
kv_heads, head_dim, kv_head_dim, mlp, vocab, experts, capacity, fsdp,
cache_seq, frames, state.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple, Union

import torch

Entry = Union[None, str, Tuple[str, ...]]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mapping logical axis -> mesh axis (or None = replicated)."""

    batch: Optional[Tuple[str, ...]] = ("data",)
    seq: Optional[str] = None
    d_model: Optional[str] = None
    heads: Optional[str] = "model"
    kv_heads: Optional[str] = "model"
    head_dim: Optional[str] = None
    kv_head_dim: Optional[str] = None  # 'model' when kv_heads < model size
    mlp: Optional[str] = "model"
    vocab: Optional[str] = "model"
    experts: Optional[str] = "model"
    capacity: Optional[str] = None
    fsdp: Optional[str] = None          # "data" for ZeRO-3 weights
    cache_seq: Optional[str] = None     # "data" for long-context decode
    frames: Optional[str] = None
    state: Optional[str] = None
    # No explicit constraints on q/k/v and attention internals (archs whose
    # head counts do not divide the model axis).
    attn_unconstrained: bool = False
    # The DeviceMesh the distributed paths run on (the expert-parallel MoE
    # among them).  None: every path runs on plain tensors.
    mesh: Optional[object] = None

    def spec(self, *logical: Optional[str]) -> Tuple[Entry, ...]:
        return tuple(None if name is None else getattr(self, name) for name in logical)


MULTIPOD_RULES = ShardingRules(batch=("pod", "data"))
SINGLEPOD_RULES = ShardingRules(batch=("data",))


def make_rules(mesh, **overrides) -> ShardingRules:
    base = MULTIPOD_RULES if "pod" in mesh_axis_names(mesh) else SINGLEPOD_RULES
    overrides.setdefault("mesh", mesh)
    return dataclasses.replace(base, **overrides)


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh, name: str) -> int:
    """Ranks along mesh axis ``name``."""
    return int(mesh.shape[mesh_axis_names(mesh).index(name)])


def _axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def validate_spec(spec: Sequence[Entry], shape, mesh) -> Tuple[Entry, ...]:
    """Drop the entries whose mesh size does not divide their dim (and any
    entry past the tensor's rank): ``repro``'s ``_validate_spec``."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(entry)
            continue
        size = 1
        for a in _axes(entry):
            size *= axis_size(mesh, a)
        out.append(entry if shape[i] % size == 0 else None)
    return tuple(out)


def batch_shard_axes(mesh, rules: ShardingRules, rows: int) -> Tuple[str, ...]:
    """The mesh axes ``rows`` batch rows shard over under ``rules``: all
    of ``rules.batch`` when their product divides ``rows``, else none (as
    :func:`validate_spec` drops the entry)."""
    axes = tuple(a for a in _axes(rules.batch) if axis_size(mesh, a) > 1)
    size = 1
    for a in axes:
        size *= axis_size(mesh, a)
    return axes if rows % size == 0 else ()


def placements(mesh, spec: Sequence[Entry]) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    axis that dim d names, ``Replicate()`` on the others.  A dim named by
    several axes is split by them in the spec's order, so those axes must
    follow the mesh's order (as ``("pod", "data")`` does)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            out[names.index(a)] = Shard(d)
    return tuple(out)


def shard(x: torch.Tensor, rules: ShardingRules, *logical: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor to the placements of ``logical`` under
    ``rules`` (axes that do not divide their dim dropped); anything else,
    and everything under rules without a mesh, is returned unchanged."""
    if rules.mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = validate_spec(rules.spec(*logical), x.shape, rules.mesh)
    want = placements(rules.mesh, spec)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(rules.mesh, want)
