"""Deadline-ordered (EDF) micro-batch formation, as a pure function.

Copy of ``repro.serve.batching``.

FIFO batching lets the queue head lead, and a long-deadline
bulk scan arriving first could head-block a short-deadline interactive
request behind it.  :func:`form_batch` replaces that with earliest-
deadline-first selection over the whole queue, while keeping every
invariant the engine's bit-equality tests rely on:

* **EDF order** — the ticket with the earliest *effective* deadline
  leads; the rest of the batch is the EDF-order prefix of the live
  tickets sharing the lead's :class:`SearchParams` that fits the row cap.
* **Expiry shedding** — tickets whose deadline has already passed are
  shed BEFORE dispatch (returned in ``BatchPlan.expired``), never batched.
* **Params homogeneity** — one batch, one ``SearchParams``: heterogeneous
  params cost extra batches, never wrong results.  Unlike FIFO, a
  different-params ticket no longer ends the batch — it simply waits for
  its own class's turn (no head-of-line blocking across params classes).
* **No starvation** — a ticket submitted without a deadline gets the
  effective deadline ``submitted_mono + no_deadline_horizon``: it ages
  like everything else, so a steady stream of fresh urgent tickets can
  delay it by at most the horizon (the fairness bound the property tests
  assert), never forever.

Purity is the point: the function reads ``now`` as an argument, mutates
nothing, and returns a :class:`BatchPlan` partition of its input — the
engine applies the plan under its queue lock, and Hypothesis drives the
function directly with no engine, no clock, no threads.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

__all__ = ["BatchPlan", "effective_deadline", "form_batch"]

#: Effective-deadline horizon (seconds) for tickets submitted without one.
DEFAULT_NO_DEADLINE_HORIZON_S = 60.0


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """The pure output of :func:`form_batch`: a partition of the queue.

    ``batch`` dispatches now (EDF order, params-homogeneous, row-capped);
    ``expired`` is shed before dispatch; every other input ticket stays
    queued.  ``batch + expired + remaining`` is exactly the input — the
    conservation property the tests assert.
    """

    batch: Tuple[Any, ...]
    expired: Tuple[Any, ...]

    @property
    def rows(self) -> int:
        return sum(int(t.queries.shape[0]) for t in self.batch)


def effective_deadline(
    ticket: Any,
    no_deadline_horizon: float = DEFAULT_NO_DEADLINE_HORIZON_S,
) -> float:
    """A ticket's EDF priority instant (monotonic-clock seconds).

    Tickets carrying a real deadline use it.  Deadline-less tickets age
    from their submission instant plus the horizon — still a finite
    instant, so they cannot be starved by an endless stream of
    deadline-bearing arrivals (eventually their effective deadline is the
    earliest in the queue).
    """
    if ticket.deadline is not None:
        return float(ticket.deadline)
    return float(ticket.submitted_mono) + float(no_deadline_horizon)


def form_batch(
    pending: Sequence[Any],
    *,
    max_rows: int,
    now: float,
    no_deadline_horizon: float = DEFAULT_NO_DEADLINE_HORIZON_S,
) -> BatchPlan:
    """Select one EDF micro-batch (and the expired tickets to shed).

    Args:
      pending: queued tickets.  Each needs ``queries.shape[0]`` (rows),
        ``params`` (hashable, equality-comparable), ``deadline`` (a
        monotonic instant or None) and ``submitted_mono`` (monotonic
        submission instant) — the duck-typed subset of
        :class:`~repro_torch.serve.engine.SearchTicket`.  ``seq`` (admission
        order) breaks deadline ties deterministically when present.
      max_rows: micro-batch row cap.  The lead ticket is exempt (a single
        oversized request still dispatches, alone) — the cap bounds
        *batching*, it does not reject admitted work.
      now: the current monotonic instant (passed in: purity).
      no_deadline_horizon: aging horizon for deadline-less tickets.

    Returns a :class:`BatchPlan`; ``plan.batch`` is empty only when every
    pending ticket expired (or ``pending`` itself is empty).
    """
    if max_rows < 1:
        raise ValueError(f"max_rows must be >= 1, got {max_rows}")
    live = []
    expired = []
    for t in pending:
        if t.deadline is not None and now > t.deadline:
            expired.append(t)
        else:
            live.append(t)
    if not live:
        return BatchPlan((), tuple(expired))

    def key(t):
        return (
            effective_deadline(t, no_deadline_horizon),
            getattr(t, "seq", 0),
        )

    order = sorted(live, key=key)
    lead = order[0]
    batch = [lead]
    rows = int(lead.queries.shape[0])
    for t in order[1:]:
        if t.params != lead.params:
            continue  # a different class waits its turn, blocks nothing
        r = int(t.queries.shape[0])
        if rows + r > max_rows:
            # stop at the first same-params ticket that does not fit:
            # taking a LATER-deadline ticket instead would break EDF order
            # within the class
            break
        batch.append(t)
        rows += r
    return BatchPlan(tuple(batch), tuple(expired))
