"""Traffic kind ``build``: whole ``HilbertIndex.build`` calls on the corpus,
back to back.  End to end: ``rows_per_s``."""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, List

import torch

from hfbench import check, data
from hfbench.kind import Kind, index_config, index_fields, sync
from reference import plain


class BuildKind(Kind):
    def setup(self) -> None:
        self.points = data.draw(self.cfg, 0, self.seed, self.dev)
        self.config = index_config(self.p, self.cfg)
        self.p.HilbertIndex.build(self.points, index_config(self.p, self.cfg, n_trees=1),
                                  device=self.dev)
        sync(self.dev)
        self.kept: List[SimpleNamespace] = []

    def end_to_end(self, window_s: float) -> Dict[str, float]:
        """Rows of the window's whole builds over the seconds those builds took."""
        return {"rows_per_s": sum(self.counts) / sum(self.units)}

    def run_unit(self) -> None:
        out = []
        self.units.append(self.timed(lambda: out.append(
            self.p.HilbertIndex.build(self.points, self.config, device=self.dev))))
        self.counts.append(self.cfg["rows"])
        fields = index_fields(out[0])
        self.kept.append(SimpleNamespace(**{k: v.cpu() for k, v in vars(fields).items()}))

    def trace_call(self):
        self.trace_count = self.cfg["rows"]
        return lambda: self.p.HilbertIndex.build(self.points, self.config, device=self.dev)

    def release(self) -> None:
        self.free()

    def check(self):
        ref = plain.build_index(self.points, self.cfg)
        per_unit = [check.index_state(k, ref) for k in self.kept]  # every unit of the window
        nums = {name: max(u[name] for u in per_unit) for name in per_unit[0]}
        return nums, {"units": len(per_unit)}

    @staticmethod
    def control(cfg, traffic, cell, seed, device):
        points = data.draw(cfg, 0, seed, device)
        ref = plain.build_index(points, cfg)
        low = plain.build_index(points.to(torch.bfloat16).float(), cfg)
        return check.index_state(low, ref)


KIND = BuildKind
