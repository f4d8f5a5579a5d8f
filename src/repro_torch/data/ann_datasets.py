"""Synthetic ANN datasets with exact ground truth.

The numpy functions are copies of ``repro.data.ann_datasets`` (same seeds,
same arrays), so tests can feed one array to both packages.
:func:`lowrank_embeddings_torch` draws the same distribution on a device
with a ``torch.Generator``, in row chunks, for corpora whose numpy
``(n, d, r)`` einsum would not fit in host memory (3M x 384 needs 74 GB).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "lowrank_embeddings",
    "lowrank_dataset_with_queries",
    "lowrank_embeddings_torch",
    "exact_knn",
    "exact_knn_graph",
    "recall_at_k",
]


def lowrank_embeddings(
    n: int,
    d: int,
    n_clusters: int = 64,
    r: int = 16,
    noise: float = 0.9,
    seed: int = 0,
) -> np.ndarray:
    """Clusters living on low-dimensional local manifolds (intrinsic dim r≪d).

    The proxy for MiniLM-style corpora (PUBMED23/GOOAQ): ambient d=384 but
    local intrinsic dimensionality ~10–30.
    """
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, n_clusters, n)
    u = rng.normal(size=(n_clusters, d, r)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    spec = ((1.0 + np.arange(r)) ** -0.5).astype(np.float32)
    z = rng.normal(size=(n, r)).astype(np.float32) * spec
    x = centers[assign] + noise * np.einsum("ndr,nr->nd", u[assign], z)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32)


def lowrank_dataset_with_queries(
    n: int,
    q: int,
    d: int,
    n_clusters: int = 64,
    r: int = 16,
    noise: float = 0.9,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """(data, held-out queries), one distribution — the challenge's regime."""
    allpts = lowrank_embeddings(
        n + q, d, n_clusters=n_clusters, r=r, noise=noise, seed=seed
    )
    perm = np.random.default_rng(seed + 0x9E3779B9).permutation(n + q)
    allpts = allpts[perm]
    return allpts[:n], allpts[n:]


def lowrank_embeddings_torch(
    n: int,
    d: int,
    *,
    generator: torch.Generator,
    n_clusters: int = 64,
    r: int = 16,
    noise: float = 0.9,
    chunk: int = 1 << 15,
) -> torch.Tensor:
    """:func:`lowrank_embeddings`' distribution, drawn on ``generator``'s device.

    Rows are i.i.d. given the cluster tables, so any row split of the result
    (corpus rows first, queries last) is a corpus and held-out queries from
    one distribution.  The numbers differ from the numpy version's: torch
    and numpy generators give different streams from one seed.
    """
    dev = generator.device
    centers = torch.randn(n_clusters, d, generator=generator, device=dev)
    centers /= torch.linalg.vector_norm(centers, dim=1, keepdim=True)
    u = torch.randn(n_clusters, d, r, generator=generator, device=dev)
    u /= torch.linalg.vector_norm(u, dim=1, keepdim=True)
    spec = (1.0 + torch.arange(r, device=dev, dtype=torch.float32)) ** -0.5
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        assign = torch.randint(0, n_clusters, (m,), generator=generator, device=dev)
        z = torch.randn(m, r, generator=generator, device=dev) * spec
        x = centers[assign] + noise * torch.bmm(u[assign], z[:, :, None])[:, :, 0]
        out[s : s + m] = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return out


def exact_knn(
    data: np.ndarray, queries: np.ndarray, k: int, chunk: int = 1024
) -> Tuple[np.ndarray, np.ndarray]:
    """Brute-force k-NN (squared L2). Returns (ids (Q,k), dists (Q,k))."""
    data_sq = (data * data).sum(1)
    ids = np.empty((len(queries), k), np.int32)
    dists = np.empty((len(queries), k), np.float32)
    for s in range(0, len(queries), chunk):
        q = queries[s : s + chunk]
        d2 = data_sq[None, :] - 2.0 * (q @ data.T) + (q * q).sum(1)[:, None]
        part = np.argpartition(d2, k - 1, axis=1)[:, :k]
        pd = np.take_along_axis(d2, part, axis=1)
        srt = np.argsort(pd, axis=1)
        ids[s : s + chunk] = np.take_along_axis(part, srt, axis=1)
        dists[s : s + chunk] = np.take_along_axis(pd, srt, axis=1)
    return ids, dists


def exact_knn_graph(data: np.ndarray, k: int, chunk: int = 1024) -> np.ndarray:
    """Exact k-NN graph ids (self excluded)."""
    ids, _ = exact_knn(data, data, k + 1, chunk=chunk)
    out = np.empty((len(data), k), np.int32)
    for i in range(len(data)):
        row = ids[i]
        row = row[row != i][:k]
        out[i] = row
    return out


def recall_at_k(pred_ids: np.ndarray, true_ids: np.ndarray) -> float:
    """Mean |pred ∩ true| / k (the challenge's recall metric)."""
    k = true_ids.shape[1]
    hits = 0
    for p, t in zip(pred_ids, true_ids):
        hits += len(set(p[:k].tolist()) & set(t.tolist()))
    return hits / (len(true_ids) * k)
