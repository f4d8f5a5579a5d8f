"""The numbers that decide ``correct``, each held to the limit in the cell's file.

Answers (search results, graph rows) are judged against the plain reference
on the same inputs:

* ``id_miss``: the share of the reference's ids that the program's answer
  for the same query or row lacks;
* ``dist_gap``: the widest relative gap between the program's i-th distance
  and the reference's i-th, over every answer and rank compared.

An index is judged leaf by leaf (``quant``, ``codes``, ``forest``,
``master``): the share of its entries that differ from the reference's.
Every unit of a graph or build window is compared (the window repeats one
input); a search window's answers are sampled from the seed.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch

Checks = Dict[str, float]


def answers(prog_ids: torch.Tensor, prog_d: torch.Tensor, ref_ids: torch.Tensor,
            ref_d: torch.Tensor) -> Checks:
    """``id_miss`` and ``dist_gap`` of (S, k) answers against the reference's."""
    if prog_ids.shape != ref_ids.shape or prog_d.shape != ref_d.shape:
        return {"id_miss": 1.0, "dist_gap": math.inf}
    prog_ids = prog_ids.long().to(ref_ids.device)
    prog_d = prog_d.float().to(ref_d.device)
    ref_ids = ref_ids.long()
    want = ref_ids >= 0
    found = (ref_ids[:, :, None] == prog_ids[:, None, :]).any(-1)
    miss = float((want & ~found).sum()) / max(1, int(want.sum()))
    fin = torch.isfinite(ref_d)
    rel = (prog_d - ref_d).abs() / ref_d.clamp_min(1e-30)
    rel = torch.where(fin, rel, torch.where(torch.isfinite(prog_d), torch.inf, 0.0))
    gap = float(rel.max()) if rel.numel() else 0.0
    if math.isnan(gap):
        gap = math.inf
    return {"id_miss": miss, "dist_gap": gap}


def mismatch(pairs: Iterable[Tuple[torch.Tensor, torch.Tensor]]) -> float:
    """Share of differing entries over (program, reference) tensor pairs; 1.0
    on any shape that differs."""
    diff = total = 0
    for got, want in pairs:
        got = got.to(want.device)
        if tuple(got.shape) != tuple(want.shape):
            return 1.0
        if got.dtype.is_floating_point or want.dtype.is_floating_point:
            ne = got.double() != want.double()
        else:
            ne = got.long() != want.long()
        diff += int(ne.sum())
        total += want.numel()
    return diff / max(1, total)


def index_state(prog, ref) -> Checks:
    """Leaf-by-leaf mismatch of an index (program's fields against the reference's)."""
    return {
        "quant": mismatch([(prog.boundaries, ref.boundaries),
                           (prog.centroids, ref.centroids)]),
        "codes": mismatch([(prog.codes_master, ref.codes_master),
                           (prog.sketches_master, ref.sketches_master)]),
        "forest": mismatch([(prog.orders, ref.orders), (prog.directories, ref.directories),
                            (prog.lo, ref.lo), (prog.hi, ref.hi),
                            (prog.perms, ref.perms), (prog.flips, ref.flips)]),
        "master": mismatch([(prog.master_order, ref.master_order),
                            (prog.master_rank, ref.master_rank)]),
    }


def verdict(values: Checks, limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit, or a limit without a number, fails."""
    out = {}
    ok = set(values) == set(limits)
    for name in sorted(set(values) | set(limits)):
        v, lim = values.get(name, math.inf), limits.get(name, -math.inf)
        out[name] = {"value": v, "limit": lim}
        ok = ok and not math.isnan(v) and v <= lim
    return ok, out

