"""The collectives of the sharded layouts, over S logical shards of one device.

The JAX package runs its sharded code inside ``shard_map`` over a mesh's
``data`` axis, one shard a device, and moves data between shards with
``lax`` collectives.  The port keeps the S shards of one process stacked
on a leading shard axis: every per-shard tensor is ``(S, ...)``, row ``r``
being rank ``r``'s value, and every collective is a tensor operation on
that axis.  Every exchange between shards goes through this module, but
it is not the only code that sees the stacked axis: the per-rank bodies
of :mod:`repro_torch.core.distributed` (the sample sort's local sorts and
bucketing, the halo windows' launches, the routing home) and
:class:`repro_torch.index.sharded.ShardedHilbertIndex` (its per-shard
stack and search loop) loop over the rows of ``(S, ...)`` tensors of one
device.  Placing shards on several cards replaces this module and
rewrites those loops, so that each rank holds and works on its own slice.

Each function takes and returns per-rank stacks, as the JAX collective
would give each rank its own result:

* :meth:`ShardGroup.all_gather`: ``lax.all_gather`` — every rank sees the
  whole ``(S, ...)`` stack;
* :meth:`ShardGroup.all_to_all`: ``lax.all_to_all(split_axis=0,
  concat_axis=0)`` — ``(S_src, S_dst, cap, ...)`` to ``(S_dst, S_src,
  cap, ...)``;
* :meth:`ShardGroup.ppermute`: ``lax.ppermute`` — rank ``dst`` receives
  rank ``src``'s value for each ``(src, dst)`` pair, zeros where no pair
  names it;
* :meth:`ShardGroup.pmin`: ``lax.pmin`` — the minimum over ranks, on every
  rank;
* :meth:`ShardGroup.axis_index`: ``lax.axis_index`` — each rank's index.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

__all__ = ["ShardGroup"]


@dataclasses.dataclass(frozen=True)
class ShardGroup:
    """``size`` logical shards whose stacked tensors live on ``device``."""

    size: int
    device: torch.device

    def __post_init__(self):
        if self.size < 1:
            raise ValueError(f"a shard group needs at least one shard, got {self.size}")

    def _check(self, x: torch.Tensor) -> None:
        if x.dim() < 1 or x.shape[0] != self.size:
            raise ValueError(f"expected a ({self.size}, ...) per-rank stack, "
                             f"got shape {tuple(x.shape)}")

    def axis_index(self) -> torch.Tensor:
        """(S,) int32: rank r's own index."""
        return torch.arange(self.size, dtype=torch.int32, device=self.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Rank r's view of every rank's ``x[r]``: the (S, ...) stack itself,
        the same for every rank."""
        self._check(x)
        return x

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """(S_src, S_dst, cap, ...) send buffers -> (S_dst, S_src, cap, ...)
        received: block ``[d, s]`` is what rank ``s`` sent rank ``d``."""
        self._check(x)
        if x.dim() < 2 or x.shape[1] != self.size:
            raise ValueError(f"all_to_all: expected (S, S, ...), got {tuple(x.shape)}")
        return x.transpose(0, 1).contiguous()

    def ppermute(self, x: torch.Tensor, perm: Sequence[Tuple[int, int]]
                 ) -> torch.Tensor:
        """Rank ``dst`` receives ``x[src]`` for each ``(src, dst)`` pair of
        ``perm``; a rank no pair sends to receives zeros."""
        self._check(x)
        src_of = [-1] * self.size
        for src, dst in perm:
            if src_of[dst] >= 0:
                raise ValueError(f"ppermute: rank {dst} receives twice")
            src_of[dst] = src
        out = x[torch.as_tensor([max(s, 0) for s in src_of], device=x.device)]
        missing = [d for d, s in enumerate(src_of) if s < 0]
        if missing:
            out[missing] = 0
        return out

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise minimum over ranks, on every rank: (S, ...)."""
        self._check(x)
        return x.amin(0, keepdim=True).expand_as(x)
