"""Deterministic, resumable synthetic LM data: a copy of ``repro.data.pipeline``.

Every batch is a pure function of (seed, step) through a counter-based
numpy generator, so a restore from a checkpoint resumes the stream
exactly and any host materializes any shard of any batch without
coordination (host h takes rows [h B/H, (h+1) B/H) of batch ``step``).
The stream mixes Zipf-distributed unigrams with repeated n-gram motifs,
so the loss falls measurably within tens of steps at smoke scale.
Batches are bit-equal to ``repro``'s; :meth:`TokenPipeline.torch_batch`
puts one on a device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    n_motifs: int = 64
    motif_len: int = 8


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # Zipf unigram table + motif bank (shared, tiny)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks
        self._probs = (probs / probs.sum()).astype(np.float64)
        self._motifs = rng.integers(
            0, cfg.vocab_size, (cfg.n_motifs, cfg.motif_len), dtype=np.int64
        )

    def batch_at(self, step: int, host: int = 0, n_hosts: int = 1) -> Dict[str, np.ndarray]:
        """Materialize (this host's rows of) batch ``step``."""
        cfg = self.cfg
        rows = cfg.global_batch // n_hosts
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, host, 0xD1CE])
        )
        toks = rng.choice(
            cfg.vocab_size, size=(rows, cfg.seq_len + 1), p=self._probs
        ).astype(np.int64)
        # overlay motifs: ~25% of positions covered by repeated n-grams
        n_spans = (rows * (cfg.seq_len + 1)) // (4 * cfg.motif_len)
        if n_spans:
            r = rng.integers(0, rows, n_spans)
            c = rng.integers(0, cfg.seq_len + 1 - cfg.motif_len, n_spans)
            m = rng.integers(0, cfg.n_motifs, n_spans)
            for i in range(n_spans):
                toks[r[i], c[i] : c[i] + cfg.motif_len] = self._motifs[m[i]]
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "mask": np.ones((rows, cfg.seq_len), np.float32),
        }

    def torch_batch(self, step: int, device, extra: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Dict[str, torch.Tensor]:
        """Batch ``step`` as tensors on ``device`` (``repro``'s ``jax_batch``)."""
        b = {k: torch.from_numpy(v).to(device) for k, v in self.batch_at(step).items()}
        if extra:
            b.update(extra)
        return b
