"""Continuous-batching serve scheduler: port of ``repro.serve.scheduler``.

The engine multiplexes a stream of requests onto ``n_slots`` persistent
decode lanes:

* a new request prefills into a free lane (its caches are copied into
  that lane's rows: k, v and pos of an attention layer, the state ``h``
  and the conv window of an SSM layer);
* every engine step decodes ALL lanes in one ``decode_step`` call: lanes
  sit at different positions, so the caches are lane-major with a ``pos``
  row a lane, and the step takes a ``(n_slots,)`` position vector (each
  lane writes its own ring slot; ``repro`` vmaps batch-1 caches);
* finished lanes (EOS, ``max_new_tokens`` or ``max_seq``) are freed and
  refilled at the next step — no batch drain.

``sample(logits, hidden)`` picks each lane's next token from its logits
(B, Vp) and final hidden state (B, D); the default is greedy.  ``repro``'s
closure takes the logits alone; the hidden state is what lets it compose
with the kNN-LM mix (:func:`knn_lm_sampler`).  One card has no mesh, so
``repro``'s ``rules`` argument is gone.  As ``repro``'s, the engine passes
no frames or patches to prefill, so it serves the decoder-only configs
(dense, MoE, Mamba-2 and the hybrid).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.types import SearchParams
from repro_torch.models.model import Transformer
from repro_torch.serve.retrieval import RetrievalStore, knn_lm_mix

Sampler = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def greedy(logits: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
    return logits.argmax(dim=-1)


def knn_lm_sampler(store: RetrievalStore, params: SearchParams, lam: float = 0.25,
                   temperature: float = 1.0) -> Sampler:
    """Greedy over the kNN-LM mixture of the model and ``store``."""

    def sample(logits: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
        logp = knn_lm_mix(logits.float(), hidden.float(), store, params, lam=lam,
                          temperature=temperature)
        return logp.argmax(dim=-1)

    return sample


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray           # (prompt_len,) int32
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class _Slot:
    req: Optional[Request] = None
    pos: int = 0                 # next position to write
    remaining: int = 0


def _copy_lane(lane, one, i: int) -> None:
    """Row 0 of every tensor of the batch-1 cache ``one`` into row ``i`` of
    the lane-major cache ``lane`` (an attention or an SSM cache)."""
    for f in dataclasses.fields(lane):
        dst = getattr(lane, f.name)
        if isinstance(dst, torch.Tensor):
            dst[i] = getattr(one, f.name)[0]


class ContinuousBatchingEngine:
    def __init__(self, model: Transformer, n_slots: int = 4, max_seq: int = 128,
                 sample: Optional[Sampler] = None):
        self.model = model
        self.n_slots, self.max_seq = n_slots, max_seq
        self.sample = sample or greedy
        self.queue: Deque[Request] = deque()
        self.slots = [_Slot() for _ in range(n_slots)]
        # lane-major caches: row i of every layer's k/v/pos is lane i
        self.caches = model.make_decode_caches(n_slots, max_seq, dtype=model.dtype)
        self.next_tok = torch.zeros((n_slots,), dtype=torch.int64, device=model.device)
        self.finished: Dict[int, Request] = {}
        self._steps = 0

    # --- public API ------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def run(self, max_steps: int = 1000) -> Dict[int, Request]:
        """Drive the engine until the queue and all lanes drain."""
        while (self.queue or any(s.req for s in self.slots)) and \
                self._steps < max_steps:
            self._admit()
            self._step()
        return self.finished

    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if s.req is not None)

    @property
    def steps(self) -> int:
        return self._steps

    # --- internals ---------------------------------------------------------
    def _admit(self) -> None:
        for i, slot in enumerate(self.slots):
            if slot.req is None and self.queue:
                self._prefill_into(i, self.queue.popleft())

    def _prefill_into(self, i: int, req: Request) -> None:
        logits, caches1, hidden = self.model.prefill(np.asarray(req.prompt)[None, :],
                                                     with_hidden=True)
        caches1 = self.model.pad_caches(caches1, self.max_seq)
        for lane, one in zip(self.caches, caches1):
            _copy_lane(lane, one, i)
        tok = int(self.sample(logits, hidden)[0])
        self.next_tok[i] = tok
        self.slots[i] = _Slot(req=req, pos=len(req.prompt),
                              remaining=req.max_new_tokens)
        req.output.append(tok)

    def _step(self) -> None:
        if self.active == 0:
            return
        positions = torch.tensor([s.pos if s.req else 0 for s in self.slots],
                                 dtype=torch.int64, device=self.model.device)
        logits, _, hidden = self.model.decode_step(self.next_tok[:, None], positions,
                                                   self.caches, with_hidden=True)
        toks = self.sample(logits, hidden).long()
        self.next_tok = toks
        self._steps += 1
        for i, (slot, t) in enumerate(zip(self.slots, toks.tolist())):
            if slot.req is None:
                continue
            slot.req.output.append(t)
            slot.pos += 1
            slot.remaining -= 1
            if (slot.remaining <= 0
                    or (slot.req.eos_id is not None and t == slot.req.eos_id)
                    or slot.pos >= self.max_seq):
                slot.req.done = True
                self.finished[slot.req.uid] = slot.req
                self.slots[i] = _Slot()
