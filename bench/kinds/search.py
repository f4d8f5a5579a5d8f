"""Traffic kind ``search``: a closed loop of ``HilbertIndex.search`` calls.

One caller sends calls of ``batch`` held-out queries back to back on an
index built in set-up.  The traffic file gives ``batch``, ``pool_batches``
(the distinct batches the loop cycles through), ``warm_queries`` and the
search parameters ``k1``, ``k2``, ``h``, ``k``.  End to end: ``search_qps``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from hfbench import check, data
from hfbench.kind import (Kind, exact_knn, index_config, recall, reference_search,
                          sample_indices, sync)
from reference import plain


class SearchKind(Kind):
    def setup(self) -> None:
        cfg, tr = self.cfg, self.traffic
        self.params = self.p.SearchParams(k1=tr["k1"], k2=tr["k2"], h=tr["h"], k=tr["k"])
        self.batch = tr["batch"]
        rows = data.draw(cfg, tr["batch"] * tr["pool_batches"], self.seed, self.dev)
        self.points, self.queries = rows[: cfg["rows"]], rows[cfg["rows"]:]
        self.index = self.p.HilbertIndex.build(self.points, index_config(self.p, cfg),
                                               device=self.dev)
        self.index.search(self.queries[: tr["warm_queries"]], self.params)
        sync(self.dev)
        self.answers: List[Tuple[int, torch.Tensor, torch.Tensor]] = []

    def end_to_end(self, window_s: float) -> Dict[str, float]:
        """Queries answered in the window over the window's wall time."""
        return {"search_qps": sum(self.counts) / window_s}

    def _batch(self, i: int) -> Tuple[int, torch.Tensor]:
        slot = i % self.traffic["pool_batches"]
        return slot, self.queries[slot * self.batch : (slot + 1) * self.batch]

    def run_unit(self) -> None:
        slot, q = self._batch(len(self.units))
        out = []
        self.units.append(self.timed(lambda: out.extend(self.index.search(q, self.params))))
        self.counts.append(q.shape[0])
        self.answers.append((slot, out[0], out[1]))

    def trace_call(self):
        """One call of the window's own batch: the next batch of the loop."""
        _, q = self._batch(len(self.units))
        self.trace_count = q.shape[0]
        return lambda: self.index.search(q, self.params)

    def release(self) -> None:
        del self.index
        self.free()

    def check(self):
        """(numbers, notes): the sampled answers against the reference; the
        recall of both against exact neighbours."""
        b = self.batch
        pick = sample_indices(self.seed, len(self.answers) * b, self.cell["sample"])
        slots = [self.answers[i // b][0] for i in pick]
        rows = torch.as_tensor([s * b + i % b for s, i in zip(slots, pick)],
                               device=self.dev)
        prog_ids = torch.stack([self.answers[i // b][1][i % b] for i in pick])
        prog_d = torch.stack([self.answers[i // b][2][i % b] for i in pick])
        queries = self.queries[rows]
        ref_ids, ref_d = reference_search(self.points, queries, self.cfg, self.traffic)
        nums = check.answers(prog_ids, prog_d, ref_ids, ref_d)
        truth = exact_knn(self.points, queries, self.traffic["k"])
        notes = {"recall_program": recall(prog_ids, truth),
                 "recall_reference": recall(ref_ids, truth), "sampled": len(pick)}
        return nums, notes

    @staticmethod
    def control(cfg, traffic, cell, seed, device):
        b = traffic["batch"]
        rows = data.draw(cfg, b * traffic["pool_batches"], seed, device)
        points, pool = rows[: cfg["rows"]], rows[cfg["rows"]:]
        queries = pool[torch.as_tensor(sample_indices(seed, 3 * b, cell["sample"]),
                                       device=device)]
        params = {k: traffic[k] for k in ("k1", "k2", "h", "k")}
        base, surv = plain.search_survivors(points, queries, cfg, params)
        ref = plain.search_answers(queries, base, surv, params)
        low = plain.search_answers(queries, base, surv, params, low=True)
        return check.answers(*low, *ref)


KIND = SearchKind
