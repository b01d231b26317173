"""Iteration-level scheduling policy of the serving engine (counterpart
of ``singa_tpu/serve/scheduler.py``).

The engine asks one question per step: "these slots are free: which
queued requests run next?".  Asking it every iteration instead of once
per batch is continuous batching: requests retire one by one and the
same step's ``schedule()`` backfills their slots.

* FIFO admission, in arrival order;
* at most ``max_prefills_per_step`` admissions per ``schedule()`` call,
  so a burst of arrivals cannot starve the decode loop;
* admission control: ``enqueue`` raises :class:`QueueFullError` at
  ``max_queue_depth``, and ``schedule`` drops requests whose deadline
  passed before it admits any.

:class:`PriorityScheduler` keeps the queue ordered by priority, FIFO
within a priority.  The JAX scheduler's request-ledger hooks
(``observe/requests``) and its SLO load shedding are not ported yet.
Plain host code: no tensors, no device.
"""

from __future__ import annotations

from collections import deque
from typing import List, Tuple

from .request import GenerationRequest, QueueFullError

__all__ = ["FIFOScheduler", "PriorityScheduler"]


class FIFOScheduler:
    """FIFO queue and the admission policy of the module docstring."""

    def __init__(self, max_queue_depth: int = 64,
                 max_prefills_per_step=None):
        if max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {max_queue_depth}")
        if max_prefills_per_step is not None \
                and max_prefills_per_step < 1:
            raise ValueError(
                f"max_prefills_per_step must be >= 1 or None, got "
                f"{max_prefills_per_step}")
        self.max_queue_depth = int(max_queue_depth)
        self.max_prefills_per_step = max_prefills_per_step
        self._queue: deque = deque()

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    def _check_room(self, request):
        if len(self._queue) >= self.max_queue_depth:
            raise QueueFullError(
                f"scheduler queue full (depth {len(self._queue)} of "
                f"max {self.max_queue_depth}); rejecting "
                f"{request.request_id}")

    def enqueue(self, request: GenerationRequest):
        self._check_room(request)
        self._queue.append(request)

    def drain(self) -> List[GenerationRequest]:
        """Remove and return every queued request, in queue order."""
        out = list(self._queue)
        self._queue.clear()
        return out

    def requeue_front(self, request: GenerationRequest):
        """Put a popped but unadmitted request back at the head (its
        blocks did not fit this step: admission order blocks, it never
        skips)."""
        self._queue.appendleft(request)

    def schedule(self, free_slots: int, now: float
                 ) -> Tuple[List[GenerationRequest],
                            List[GenerationRequest]]:
        """``(admit, expired)``: ``admit`` in queue order, at most
        ``free_slots`` and ``max_prefills_per_step``; ``expired`` the
        requests past their deadline, removed from the whole queue."""
        expired = [r for r in self._queue
                   if r.deadline is not None and now > r.deadline]
        if expired:
            dead = {id(r) for r in expired}
            self._queue = deque(r for r in self._queue
                                if id(r) not in dead)
        cap = free_slots
        if self.max_prefills_per_step is not None:
            cap = min(cap, self.max_prefills_per_step)
        admit = []
        while self._queue and len(admit) < cap:
            admit.append(self._queue.popleft())
        return admit, expired


class PriorityScheduler(FIFOScheduler):
    """Strict-priority admission: the queue is ordered by
    ``GenerationRequest.priority`` (higher first), FIFO within a
    priority, so priority-0 traffic behaves exactly as under
    :class:`FIFOScheduler`."""

    def enqueue(self, request: GenerationRequest):
        self._check_room(request)
        p = request.priority
        i = len(self._queue)
        while i > 0 and self._queue[i - 1].priority < p:
            i -= 1
        self._queue.insert(i, request)

    def requeue_front(self, request: GenerationRequest):
        """Head of the request's own priority class: ahead of equal
        priorities, behind anything higher that arrived meanwhile."""
        i = 0
        while i < len(self._queue) \
                and self._queue[i].priority > request.priority:
            i += 1
        self._queue.insert(i, request)
