"""What every kind of traffic shares, and how a kind is found by its name.

A traffic file names its ``kind``; ``bench/kinds/<kind>.py`` defines it as
``KIND``, a subclass of :class:`Kind`.  The kind reads the rest of the
traffic file, sets up from the configuration and the seed, runs one unit of
work at a time for the window, says which end-to-end metrics the window gave,
hands one unit to the profiler when the run is traced, has its outputs judged
by the reference afterwards, and gives the control's readings.  A new kind,
or a kind with a new end-to-end metric, is a new file there.  Only the kinds
call the program (``repro_torch``).
"""

from __future__ import annotations

import gc
import importlib.util
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from reference import plain


def load(kinds_dir: Path, name: str) -> type:
    """The class ``KIND`` of ``<kinds_dir>/<name>.py``; a module loaded once is
    kept, so that one kind may subclass another."""
    path = (Path(kinds_dir) / f"{name}.py").resolve()
    key = f"hfbench_kind_{name}"
    mod: Optional[ModuleType] = sys.modules.get(key)
    if mod is None or Path(mod.__file__).resolve() != path:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod.KIND


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def program() -> SimpleNamespace:
    """The program's entry points (imported on first use)."""
    from repro_torch.core.types import ForestConfig, GraphParams, QuantizerConfig, SearchParams
    from repro_torch.index import HilbertIndex, IndexConfig
    from repro_torch.obs import trace

    return SimpleNamespace(ForestConfig=ForestConfig, GraphParams=GraphParams,
                           QuantizerConfig=QuantizerConfig, SearchParams=SearchParams,
                           HilbertIndex=HilbertIndex, IndexConfig=IndexConfig,
                           tracer=trace.default_tracer())


def index_config(p, cfg: Dict, n_trees: Optional[int] = None):
    return p.IndexConfig(
        forest=p.ForestConfig(n_trees=cfg["n_trees"] if n_trees is None else n_trees,
                              bits=cfg["bits"], key_bits=cfg["key_bits"],
                              leaf_size=cfg["leaf_size"], seed=cfg["forest_seed"]),
        quantizer=p.QuantizerConfig(bits=cfg["quant_bits"],
                                    sample_limit=cfg["sample_limit"]),
        store_points=cfg["store_points"])


def sample_indices(seed: int, total: int, size: int) -> np.ndarray:
    """``size`` distinct indices below ``total``, drawn from the seed."""
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 1])
    return np.sort(rng.choice(total, min(size, total), replace=False))


def index_fields(index) -> SimpleNamespace:
    """The index fields the build comparison reads."""
    f = index.forest
    return SimpleNamespace(
        boundaries=index.quant.boundaries, centroids=index.quant.centroids,
        codes_master=index.codes_master, sketches_master=index.sketches_master,
        master_order=index.master_order, master_rank=index.master_rank,
        lo=f.lo, hi=f.hi, perms=f.perms, flips=f.flips,
        orders=f.orders, directories=f.directories)


class Kind:
    """One traffic kind; subclasses fill in set-up, the unit, the check and the control."""

    def __init__(self, cfg: Dict, traffic: Dict, cell: Dict, seed: int,
                 device: torch.device):
        self.cfg, self.traffic, self.cell, self.seed, self.dev = (
            cfg, traffic, cell, seed, device)
        self.p = program()
        self.units: List[float] = []  # seconds per unit
        self.counts: List[int] = []  # queries or rows per unit

    def timed(self, fn) -> float:
        sync(self.dev)
        t = time.perf_counter()
        fn()
        sync(self.dev)
        return time.perf_counter() - t

    def setup(self) -> None:
        """Data from the seed, the program's state, and a warm-up of every shape."""
        raise NotImplementedError

    def run_unit(self) -> None:
        """One timed unit; appends its seconds and its count."""
        raise NotImplementedError

    def end_to_end(self, window_s: float) -> Dict[str, float]:
        """The end-to-end metrics of the window (``setup_s`` is the runner's)."""
        raise NotImplementedError

    def trace_call(self):
        """The call to run once under the profiler, of the window's own shape;
        sets ``trace_count``."""
        raise NotImplementedError

    def release(self) -> None:
        """Drop the program's state, keeping the outputs to be judged."""
        raise NotImplementedError

    def check(self) -> Tuple[Dict[str, float], Dict]:
        """(the numbers compared, notes for the log)."""
        raise NotImplementedError

    @staticmethod
    def control(cfg: Dict, traffic: Dict, cell: Dict, seed: int,
                device: torch.device) -> Dict[str, float]:
        """The check's numbers of the reference in bfloat16 against the
        reference as configured, on the inputs a run of this seed draws."""
        raise NotImplementedError

    def free(self) -> None:
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Reference helpers shared by kinds that answer k-NN queries
# ---------------------------------------------------------------------------


def reference_search(points, queries, cfg: Dict, traffic: Dict, low: bool = False):
    params = {k: traffic[k] for k in ("k1", "k2", "h", "k")}
    base, surv = plain.search_survivors(points, queries, cfg, params)
    return plain.search_answers(queries, base, surv, params, low=low)


def exact_knn(points: torch.Tensor, queries: torch.Tensor, k: int, block: int = 256
              ) -> torch.Tensor:
    """Ids of the k nearest points by float32 squared distance (TF32 off)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        pp = (points * points).sum(1)
        out = []
        for s in range(0, queries.shape[0], block):
            q = queries[s : s + block]
            d2 = pp[None, :] - 2.0 * (q @ points.T) + (q * q).sum(1)[:, None]
            out.append(torch.topk(d2, k, dim=1, largest=False).indices)
        return torch.cat(out)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def drop_self(truth: torch.Tensor, rows: torch.Tensor, k: int) -> torch.Tensor:
    keep = truth != rows[:, None]
    return torch.stack([t[m][:k] for t, m in zip(truth, keep)])


def recall(ids: torch.Tensor, truth: torch.Tensor) -> float:
    ids = ids.to(truth.device).long()
    hit = (truth[:, :, None] == ids[:, None, :]).any(-1)
    return float(hit.float().mean())
