"""Traffic kind ``graph``: whole ``HilbertIndex.knn_graph`` calls, back to back.

The index (raw points stored) is built in set-up; the configuration's
``graph`` group gives the graph's parameters.  End to end: ``rows_per_s``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from hfbench import check, data
from hfbench.kind import Kind, drop_self, exact_knn, index_config, recall, sample_indices, sync
from reference import plain


class GraphKind(Kind):
    def setup(self) -> None:
        cfg = self.cfg
        g = cfg["graph"]
        self.params = self.p.GraphParams(n_orders=g["n_orders"], k1=g["k1"], k2=g["k2"],
                                         k=g["k"], seed=g["seed"])
        self.points = data.draw(cfg, 0, self.seed, self.dev)
        self.index = self.p.HilbertIndex.build(self.points, index_config(self.p, cfg),
                                               device=self.dev)
        warm = self.p.GraphParams(n_orders=1, k1=g["k1"], k2=g["k2"], k=g["k"],
                                  seed=g["seed"])
        self.index.knn_graph(warm)
        sync(self.dev)
        self.kept: List[Tuple[torch.Tensor, torch.Tensor]] = []

    def end_to_end(self, window_s: float) -> Dict[str, float]:
        """Rows of the window's whole graphs over the seconds those graphs took."""
        return {"rows_per_s": sum(self.counts) / sum(self.units)}

    def run_unit(self) -> None:
        out = []
        self.units.append(self.timed(lambda: out.extend(self.index.knn_graph(self.params))))
        self.counts.append(self.cfg["rows"])
        self.kept.append((out[0].cpu(), out[1].cpu()))

    def trace_call(self):
        self.trace_count = self.cfg["rows"]
        return lambda: self.index.knn_graph(self.params)

    def release(self) -> None:
        del self.index
        self.free()

    def check(self):
        rows = torch.as_tensor(sample_indices(self.seed, self.cfg["rows"], self.cell["sample"]),
                               device=self.dev)
        ref_ids, ref_d = plain.graph_rows(self.points, rows, self.cfg, self.cfg["graph"])
        # Every unit of the window, at the sampled rows.
        got_ids = torch.cat([ids[rows.cpu()] for ids, _ in self.kept])
        got_d = torch.cat([d[rows.cpu()] for _, d in self.kept])
        u = len(self.kept)
        nums = check.answers(got_ids, got_d, ref_ids.repeat(u, 1), ref_d.repeat(u, 1))
        truth = exact_knn(self.points, self.points[rows], self.cfg["graph"]["k"] + 1)
        truth = drop_self(truth, rows, self.cfg["graph"]["k"])
        notes = {"recall_program": recall(self.kept[-1][0][rows.cpu()].to(self.dev), truth),
                 "recall_reference": recall(ref_ids, truth), "sampled": int(rows.numel()),
                 "units": u}
        return nums, notes

    @staticmethod
    def control(cfg, traffic, cell, seed, device):
        points = data.draw(cfg, 0, seed, device)
        rows = torch.as_tensor(sample_indices(seed, cfg["rows"], cell["sample"]), device=device)
        ref = plain.graph_rows(points, rows, cfg, cfg["graph"])
        low = plain.graph_rows(points, rows, cfg, cfg["graph"], low=True)
        return check.answers(*low, *ref)


KIND = GraphKind
