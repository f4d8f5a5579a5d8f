"""HilbertIndex: the self-describing Hilbert-forest index, on a torch device.

Port of ``repro.index.facade``:

* ``HilbertIndex.build(points, cfg)`` — Task-1 preprocessing (quantizer,
  sketches, forest, master order) behind one call.
* ``.search(queries, params)`` — Algorithm-1 ANN search; the index carries
  its build-time :class:`IndexConfig`.
* ``.knn_graph(params)`` — Algorithm-2 k-NN graph over the indexed points
  (Task 2), reusing the index's sketches and bounds.
* ``.save(path)`` / ``HilbertIndex.load(path)`` — the JAX package's bundle
  layout, so an index saved by either package loads in the other.

``build`` and ``load`` run on ``cuda`` unless the caller passes
``device="cpu"``, and raise when no GPU is present and the CPU was not
asked for.  ``search`` and ``knn_graph`` run where the index lives.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint import bundle
from repro_torch.core import forest as forest_lib
from repro_torch.core import knn_graph as knn_graph_lib
from repro_torch.core import quantize, sketch
from repro_torch.core import search as search_lib
from repro_torch.core.types import GraphParams, SearchParams
from repro_torch.index.config import IndexConfig

__all__ = ["HilbertIndex", "build_with_timings", "resolve_device",
           "save_index_bundle", "BACKENDS", "LEAF_NAMES"]

# "kernel": the wrappers of repro_torch.kernels (CUDA kernels on the card,
# their plain versions for CPU tensors) — the counterpart of the JAX
# package's "pallas"; "ref": the plain versions everywhere ("xla").
BACKENDS = ("kernel", "ref")

_FORMAT_VERSION = 2
KIND = "hilbert_index"

# Leaf name -> dtype of the port's tensor (32-bit words are carried as int32).
LEAF_NAMES = {
    "forest.perms": np.int32,
    "forest.flips": np.bool_,
    "forest.orders": np.int32,
    "forest.directories": np.int32,
    "forest.lo": np.float32,
    "forest.hi": np.float32,
    "quant.boundaries": np.float32,
    "quant.centroids": np.float32,
    "codes_master": np.int32,
    "sketches_master": np.int32,
    "master_order": np.int32,
    "master_rank": np.int32,
    "points": np.float32,
}

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike) -> torch.device:
    """``None`` means the GPU; raise when there is none rather than fall back."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no GPU is available; "
                "pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pow2_bucket(m: int, cap: int) -> int:
    """Smallest power of two >= m, capped at ``cap`` (the chunk size)."""
    b = 1
    while b < m and b < cap:
        b <<= 1
    return min(b, cap)


@dataclasses.dataclass(frozen=True)
class HilbertIndex:
    """Self-describing Hilbert-forest index (config travels with the tensors).

    Packed arrays (``codes_master``, ``sketches_master``, the forest's
    ``directories``) are int32 tensors holding the JAX package's uint32
    words.
    """

    config: IndexConfig
    forest: forest_lib.HilbertForest
    quant: quantize.Quantizer
    codes_master: torch.Tensor  # (n, ceil(d/8)) int32, nibble-packed, master order
    sketches_master: torch.Tensor  # (n, Ws) int32, master-order layout
    master_order: torch.Tensor  # (n,) int32: position -> point id
    master_rank: torch.Tensor  # (n,) int32: point id -> position
    points: Optional[torch.Tensor] = None  # (n, d) fp32 iff config.store_points

    # -- introspection -------------------------------------------------------

    @property
    def n_points(self) -> int:
        return self.master_order.shape[0]

    @property
    def dim(self) -> int:
        return self.quant.boundaries.shape[0]

    @property
    def device(self) -> torch.device:
        return self.master_order.device

    def memory_report(self) -> Dict[str, int]:
        """Bytes by component: the paper's RAM-budget model plus actuals."""
        d = self.dim
        resident = sum(t.numel() * t.element_size() for t in self._tensors().values())
        rep = search_lib.paper_memory_model(
            self.n_points, d, self.sketches_master.numel() * 4,
            self.forest.memory_bytes(),
        )
        rep.update(
            {
                "points_bytes": 0 if self.points is None else self.n_points * d * 4,
                "codes_bytes": self.codes_master.numel() * 4,
                "order_bytes": (self.master_order.numel()
                                + self.master_rank.numel()) * 4,
                "quant_bytes": (self.quant.boundaries.numel()
                                + self.quant.centroids.numel()) * 4,
                "resident_bytes": resident,
                "total_bytes": resident,
            }
        )
        return rep

    def __repr__(self) -> str:
        mb = self.memory_report()["resident_bytes"] / 1e6
        return (
            f"HilbertIndex(n_points={self.n_points}, dim={self.dim}, "
            f"n_trees={self.forest.n_trees}, "
            f"store_points={self.points is not None}, "
            f"device={self.device}, {mb:.2f} MB)"
        )

    # -- build ---------------------------------------------------------------

    @classmethod
    def build(cls, points, config: Optional[IndexConfig] = None, *,
              device: DeviceLike = None) -> "HilbertIndex":
        """Full Task-1 preprocessing: quantize, sketch, forest, master order.

        Args:
          points: (n, d) fp32 corpus (numpy array or tensor), moved to
            ``device``.
          config: build configuration; ``None`` means ``IndexConfig()``.
          device: ``None`` (the GPU; raises without one) or any torch device.
        """
        index, _ = build_with_timings(points, config, device=device)
        return index

    # -- Task 1: Algorithm-1 search -----------------------------------------

    def search(
        self,
        queries,
        params: SearchParams = SearchParams(),
        *,
        backend: str = "kernel",
        query_chunk: Optional[int] = None,
        fused: bool = True,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Batched search — the paper's Algorithm 1.

        Args:
          queries: (Q, d) fp32 queries (numpy array or tensor), moved to the
            index's device.
          params: ``k1``/``k2``/``h``/``k`` (paper Table 1 names).
          backend: ``"kernel"`` routes stage 1 and stage 2 through the
            kernel wrappers (the CUDA kernels for a CUDA index); ``"ref"``
            through their plain versions.
          query_chunk: chunk cap (default ``config.query_chunk``); every
            chunk is padded to a power-of-two bucket and trimmed after.
          fused: the hot path (default), or the per-tree reference loop with
            stage 2 on codes unpacked once per search — bit-identical to the
            fused path on ``"ref"``.

        Returns:
          ``(ids (Q, k) int32, sq_distances (Q, k) float32)`` on the index's
          device, distances ascending; with fewer than ``k`` candidates the
          tail is id ``-1`` / ``+inf``.
        """
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        use_kernels = backend == "kernel"
        if query_chunk is None:
            query_chunk = self.config.query_chunk
        dev = self.device
        queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
        qn = queries.shape[0]
        if qn == 0:  # idle decode step: no chunks, well-typed empty result
            return (
                torch.zeros((0, params.k), dtype=torch.int32, device=dev),
                torch.zeros((0, params.k), dtype=torch.float32, device=dev),
            )
        codes_u8 = (None if fused
                    else quantize.unpack_codes(self.codes_master, self.dim))
        outs_i, outs_d = [], []
        for s in range(0, qn, query_chunk):
            q = queries[s : s + query_chunk]
            m = q.shape[0]
            bucket = _pow2_bucket(m, query_chunk)
            if bucket > m:
                q = torch.nn.functional.pad(q, (0, 0, 0, bucket - m))
            ids, dists = self._search_chunk(q.contiguous(), params, use_kernels,
                                            codes_u8)
            outs_i.append(ids[:m])
            outs_d.append(dists[:m])
        return torch.cat(outs_i), torch.cat(outs_d)

    def _search_chunk(self, queries, params: SearchParams, use_kernels: bool,
                      codes_u8: Optional[torch.Tensor] = None):
        fcfg = self.config.forest
        f = self.forest
        if codes_u8 is None:
            return search_lib.fused_search_chunk(
                queries, f.orders, f.directories, f.lo, f.hi, f.perms, f.flips,
                self.master_rank, self.sketches_master, self.codes_master,
                self.master_order, self.quant,
                bits=fcfg.bits, key_bits=fcfg.key_bits,
                leaf_size=fcfg.leaf_size, k1=params.k1, k2=params.k2,
                h=params.h, k=params.k, use_kernels=use_kernels,
            )
        # Reference path: the same stage 1, then stage 2 on unpacked codes.
        best_pos = search_lib.stage1_forest(
            queries, sketch.make_sketches(self.quant, queries),
            f.orders, f.directories, f.lo, f.hi, f.perms, f.flips,
            self.master_rank, self.sketches_master,
            bits=fcfg.bits, key_bits=fcfg.key_bits, leaf_size=fcfg.leaf_size,
            k1=params.k1, k2=params.k2, use_kernels=use_kernels,
        )
        return search_lib.stage2_expand_rank(
            queries, best_pos, codes_u8, self.master_order, self.quant,
            h=params.h, k=params.k,
        )

    # -- Task 2: Algorithm-2 graph construction ------------------------------

    def knn_graph(self, params: GraphParams = GraphParams(), *,
                  chunk: int = 1 << 16) -> Tuple[torch.Tensor, torch.Tensor]:
        """Approximate k-NN graph over the indexed points — the paper's
        Algorithm 2 (Task 2): randomized Hilbert orders, ±k1/2 rank windows,
        a sketch-filtered running top-k2, exact fp32 re-rank.

        Args:
          params: ``n_orders``/``k1``/``k2``/``k`` (paper Table 2 names).
          chunk: rows per merge and re-rank pass (memory only; no bit moves).

        Returns:
          ``(ids (n, k) int32, sq_distances (n, k) float32)`` on the index's
          device: each point's approximate k nearest neighbours, self
          excluded.  Needs ``IndexConfig(store_points=True)``.
        """
        if self.points is None:
            raise ValueError(
                "knn_graph() needs the raw points for exact re-ranking; this "
                "index was built with IndexConfig(store_points=False)"
            )
        # sketches_master[master_rank[i]] is point i's sketch.
        sketches_ids = self.sketches_master[self.master_rank.long()]
        fcfg = self.config.forest
        return knn_graph_lib.knn_graph_from_sketches(
            self.points, sketches_ids, params,
            bits=fcfg.bits, key_bits=fcfg.key_bits,
            lo=self.forest.lo, hi=self.forest.hi, chunk=chunk,
        )

    # -- persistence ---------------------------------------------------------

    def _tensors(self) -> Dict[str, torch.Tensor]:
        d = {
            "forest.perms": self.forest.perms,
            "forest.flips": self.forest.flips,
            "forest.orders": self.forest.orders,
            "forest.directories": self.forest.directories,
            "forest.lo": self.forest.lo,
            "forest.hi": self.forest.hi,
            "quant.boundaries": self.quant.boundaries,
            "quant.centroids": self.quant.centroids,
            "codes_master": self.codes_master,
            "sketches_master": self.sketches_master,
            "master_order": self.master_order,
            "master_rank": self.master_rank,
        }
        if self.points is not None:
            d["points"] = self.points
        return d

    def array_bundle(self) -> Dict[str, np.ndarray]:
        """Host numpy arrays under the JAX package's leaf names and dtypes
        (packed words as ``np.uint32``)."""
        out = {k: v.cpu().numpy() for k, v in self._tensors().items()}
        for k in ("forest.directories", "codes_master", "sketches_master"):
            out[k] = out[k].view(np.uint32)
        return out

    def save(self, path: str) -> str:
        """Atomically persist arrays + config under ``path`` as a new step.

        Keeps the previous step as one generation of grace.  Returns the
        final step directory.
        """
        return save_index_bundle(self, path)

    @classmethod
    def load(cls, path: str, *, device: DeviceLike = None) -> "HilbertIndex":
        """Load the newest verifiable step saved by either package; a step
        that fails verification is quarantined and the next older one is
        tried."""
        from repro_torch.index.convert import load_index_bundle

        return load_index_bundle(path, device=device)[0]


def save_index_bundle(index: HilbertIndex, path: str, *, kind: str = KIND,
                      extra_arrays: Optional[Dict[str, np.ndarray]] = None,
                      extra_meta: Optional[Dict] = None) -> str:
    """Persist an index plus optional sidecar arrays as ONE atomic bundle.

    The layout of ``repro.index.facade.save_index_bundle``: a fresh step per
    save, the previous one kept as a generation of grace.  Returns the
    final step directory.
    """
    arrays = dict(index.array_bundle())
    for k, v in (extra_arrays or {}).items():
        if k in LEAF_NAMES:
            raise ValueError(f"extra array name {k!r} collides with an index leaf")
        arrays[k] = np.asarray(v)
    extra = {
        "kind": kind,
        "format_version": _FORMAT_VERSION,
        "config": index.config.to_dict(),
        "has_points": index.points is not None,
        "n_points": int(index.n_points),
        "dim": int(index.dim),
        "extra_arrays": sorted((extra_arrays or {}).keys()),
    }
    for k in extra_meta or {}:
        if k in extra:
            raise ValueError(f"extra_meta key {k!r} collides with a reserved key")
    extra.update(extra_meta or {})
    prev = bundle.latest_step(path)
    step = 0 if prev is None else prev + 1
    final = bundle.save(path, step, arrays, extra)
    bundle.prune_steps(path, {step, prev})
    return final


def build_with_timings(
    points, config: Optional[IndexConfig] = None, *,
    quant: Optional[quantize.Quantizer] = None, device: DeviceLike = None,
) -> Tuple[HilbertIndex, Dict[str, float]]:
    """Build an index and return per-phase wall seconds (paper §3.2 split).

    Phases: ``quantization`` (fit+encode), ``sketches``, ``forest`` (the
    ``n_trees`` Hilbert sorts), ``master_sort``; each ends in a device
    synchronize.  ``quant`` may supply a pre-fit quantizer.
    """
    dev = resolve_device(device)
    if config is None:
        config = IndexConfig()
    points = torch.as_tensor(points, dtype=torch.float32, device=dev)
    n = points.shape[0]
    qcfg, fcfg = config.quantizer, config.forest
    timings: Dict[str, float] = {}

    _sync(dev)
    t0 = time.perf_counter()
    if quant is None:
        quant = quantize.fit(points, bits=qcfg.bits, sample_limit=qcfg.sample_limit)
    codes = quantize.encode(quant, points)
    _sync(dev)
    timings["quantization"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    sketches = sketch.sketches_from_codes(codes, bits=qcfg.bits)
    _sync(dev)
    timings["sketches"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    f = forest_lib.build_forest(points, fcfg)
    _sync(dev)
    timings["forest"] = time.perf_counter() - t0

    # Master order: an un-permuted Hilbert sort; codes/sketches rearranged.
    t0 = time.perf_counter()
    master_order, _ = search_lib.hilbert_master_sort(points, fcfg, f.lo, f.hi)
    master_rank = torch.empty((n,), dtype=torch.int32, device=dev)
    master_rank.scatter_(0, master_order.long(),
                         torch.arange(n, dtype=torch.int32, device=dev))
    _sync(dev)
    timings["master_sort"] = time.perf_counter() - t0

    index = HilbertIndex(
        config=config,
        forest=f,
        quant=quant,
        # Pack AFTER the master reorder so window reads stay contiguous.
        codes_master=quantize.pack_codes(codes[master_order]),
        sketches_master=sketches[master_order],
        master_order=master_order,
        master_rank=master_rank,
        points=points if config.store_points else None,
    )
    return index, timings
