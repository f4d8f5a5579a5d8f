"""Synthetic corpora drawn on the device from the run's seed.

A frozen copy of the port's low-rank generator (``lowrank_embeddings_torch``):
clusters on low-dimensional local manifolds, the stand-in for MiniLM-style
sentence embeddings such as PUBMED23's and GOOAQ's (ambient d = 384, local
intrinsic dimension about 10-30).  Rows are i.i.d. given the cluster tables,
so the rows after the corpus are held-out queries of the same draw.
"""

from __future__ import annotations

import torch


def lowrank_rows(n: int, d: int, *, generator: torch.Generator, n_clusters: int = 64,
                 r: int = 16, noise: float = 0.9, chunk: int = 1 << 15) -> torch.Tensor:
    """(n, d) float32 unit rows on ``generator``'s device."""
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


def draw(cfg: dict, extra_rows: int, seed: int, device) -> torch.Tensor:
    """The corpus (``cfg["rows"]`` rows) followed by ``extra_rows`` held-out rows."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    a = cfg["assumed"]
    return lowrank_rows(cfg["rows"] + extra_rows, cfg["dim"], generator=gen,
                        n_clusters=a["n_clusters"], r=a["intrinsic_rank"],
                        noise=a["noise"])
