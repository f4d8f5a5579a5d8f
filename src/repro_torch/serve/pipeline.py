"""Pipelined multi-chunk retrieval: overlap host staging with device search.

Port of ``repro.serve.pipeline``.  A large query batch is searched in
``query_chunk``-row chunks.  Called naively, each chunk pays its
host-to-device copy on the critical path.  This module double-buffers the
staging instead: chunk *i+1* is copied from pinned host memory with
``non_blocking=True`` on the current stream while the host is still
driving chunk *i*'s search:

    stage(0); search(0); stage(1); search(1); stage(2); ...

Two pinned buffers alternate.  Each copy out of a buffer records a CUDA
event, and a buffer is refilled only after the event of its previous
copy has completed: otherwise chunk *i+2* would overwrite chunk *i*'s
queries before the device had read them, a silent wrong answer.

Results are BIT-IDENTICAL to a direct ``index.search`` over the same
batch: the same per-chunk search runs on the same rows in the same order;
only the time at which the host hands each chunk to the device changes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.types import SearchParams
from repro_torch.index.mutable import _host

__all__ = ["pipelined_search"]


def pipelined_search(
    index,
    queries,
    params: SearchParams,
    *,
    backend: str = "kernel",
    query_chunk: Optional[int] = None,
    **search_kwargs,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked search with host staging overlapped against device execution.

    Args:
      index: any facade with ``search(queries, params, backend=,
        query_chunk=)`` and a ``device`` — :class:`HilbertIndex` and
        :class:`MutableHilbertIndex` of :mod:`repro_torch.index`.
      queries: (Q, d) fp32 batch (numpy array or tensor).
      params: Algorithm-1 hyper-parameters, passed through per chunk.
      backend: kernel routing, passed through per chunk.
      query_chunk: rows per staged chunk (default: the index config's
        ``query_chunk``), i.e. the double-buffer granularity; chunks are
        staged to the index's device.
      **search_kwargs: forwarded verbatim to every per-chunk
        ``index.search`` call (e.g. the serving engine's
        ``allow_rewrite=False`` on mutable layouts).

    Returns:
      ``(ids (Q, k), sq_distances (Q, k))`` on the index's device —
      bit-identical to ``index.search(queries, params)``.
    """
    if query_chunk is None:
        query_chunk = index.config.query_chunk
    qn = int(queries.shape[0]) if hasattr(queries, "shape") else len(queries)
    if qn == 0 or qn <= query_chunk:
        # One chunk: nothing to overlap, take the direct path.
        return index.search(queries, params, backend=backend,
                            query_chunk=query_chunk, **search_kwargs)
    dev = index.device
    q_host = np.ascontiguousarray(_host(queries), np.float32)
    if dev.type == "cuda":
        stream = torch.cuda.current_stream(dev)
        bufs = [torch.empty((query_chunk, q_host.shape[1]), dtype=torch.float32,
                            pin_memory=True) for _ in range(2)]
        copied = [torch.cuda.Event(), torch.cuda.Event()]

    def stage(i: int, s: int) -> torch.Tensor:
        rows = q_host[s : s + query_chunk]
        if dev.type != "cuda":
            return torch.from_numpy(rows).to(dev)
        buf, ev = bufs[i % 2], copied[i % 2]
        ev.synchronize()  # this buffer's previous copy has left it
        m = rows.shape[0]
        buf[:m].copy_(torch.from_numpy(rows))
        out = torch.empty((m, rows.shape[1]), dtype=torch.float32, device=dev)
        out.copy_(buf[:m], non_blocking=True)
        ev.record(stream)
        return out

    outs_i, outs_d = [], []
    staged = stage(0, 0)
    for i, s in enumerate(range(0, qn, query_chunk)):
        # Enqueue the current chunk's search ...
        ids, dists = index.search(staged, params, backend=backend,
                                  query_chunk=query_chunk, **search_kwargs)
        # ... then stage the NEXT chunk while the device works on this one.
        if s + query_chunk < qn:
            staged = stage(i + 1, s + query_chunk)
        outs_i.append(ids)
        outs_d.append(dists)
    return torch.cat(outs_i), torch.cat(outs_d)
