"""Request/result surface of the serving engine (counterpart of
``singa_tpu/serve/request.py``).

A :class:`GenerationRequest` is what callers submit; the engine hands
back a :class:`RequestHandle` at once, and the request waits in the
scheduler's queue until a slot and its KV blocks are free.  The result
arrives as a :class:`GenerationResult` on the handle when the request
retires; ``on_token`` streams every token the moment it is emitted (the
prefill token included).

Rejections are distinct types, because callers react to them in
opposite ways: :class:`QueueFullError` (back-pressure: retry later) and
:class:`DeadlineExceededError` (the answer is no longer wanted).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

__all__ = ["QueueFullError", "DeadlineExceededError", "EngineFailedError",
           "RestartBudgetExceededError", "FleetDownError", "LoadShedError",
           "GenerationRequest", "GenerationResult", "RequestHandle"]

_req_counter = itertools.count()


class QueueFullError(RuntimeError):
    """Admission control: the scheduler queue is at ``max_queue_depth``.
    Raised by ``submit``; the request was never accepted."""


class DeadlineExceededError(RuntimeError):
    """The request's deadline passed before a slot could run it; the
    handle's ``result()`` raises this."""


class EngineFailedError(RuntimeError):
    """The engine's decode or prefill raised, and the engine failed
    itself rather than wedging: every in-flight and queued request is
    rejected with one of these.  ``started`` tells requests that held a
    slot (tokens may have streamed) from queued ones that never
    started."""

    def __init__(self, message, request_id=None, started=None,
                 engine_step=None):
        super().__init__(message)
        self.request_id = request_id
        self.started = started
        self.engine_step = engine_step


class RestartBudgetExceededError(EngineFailedError):
    """The supervisor's restart budget is spent: the remaining requests
    are rejected with this instead of being requeued into an engine
    that keeps dying."""


class FleetDownError(EngineFailedError):
    """Every replica of a fleet is unhealthy, so there is no sibling to
    fail over to (``ServeFleet.submit`` raises it, ``serve/fleet.py``)."""


class LoadShedError(RuntimeError):
    """The request was shed by SLO-pressure admission (the queue at
    ``SLO.queue_depth_max``): a lower-priority queued request evicted
    for a higher-priority arrival, or an arrival refused while the
    queue is saturated.  Unlike :class:`QueueFullError` (the hard
    bound) shedding is a policy: clients should drop, not retry at
    once."""


@dataclass
class GenerationRequest:
    """One generation job.

    ``prompt_ids``: 1-D int token ids.  ``temperature <= 0`` is greedy
    decoding; otherwise ``seed`` keys the request's sampling noise: its
    threefry key ``split(PRNGKey(seed), 1)[0]``, split once a step and
    carried through preemption and swap, which depends on nothing of the
    slot or the batch, so the engine's streams equal offline ``generate``
    and the JAX engine's at the same seed.  ``deadline`` is an absolute time on
    the engine's clock; a request still queued past it is rejected.
    ``on_token(request, token)`` streams each emitted token.
    ``priority`` orders admission under ``scheduler="priority"`` (higher
    first).  ``stop_token`` retires the request the moment it is
    emitted (``finish_reason="stop"``), mid-chunk on a speculative
    engine, whose steps emit up to ``spec_k`` tokens (``on_token`` sees
    each).

    ``pin_session``: on an engine with a prefix cache, retire pins the
    whole finished sequence in the cache and hands back a
    ``SessionHandle`` as ``GenerationResult.session``, whose
    ``request(extra)`` builds the next turn (without a cache the handle
    still builds it, cold).  ``session_of``: the ``SessionHandle`` this
    request continues (set by ``SessionHandle.request``).

    ``n``: parallel sampling (fork, ``serve/fork.py``).  ``n > 1``
    admits the prompt once and decodes n branches that share every
    prompt block of the paged pool copy-on-first-write; ``submit``
    returns a ``ForkHandle``.  Branch 0 is the exact stream ``n = 1``
    would produce, branch k > 0 samples with the key ``fold_in(parent
    key, k)``, as in the JAX engine.  Paged engines only; not with
    ``pin_session`` (a session continues one stream), and
    ``max_new_tokens >= 2`` (the branches share the first token).
    ``structured``: a token automaton (``serve/structured.py``:
    ``JsonSchemaAutomaton``, or any object with ``initial``, ``mask``,
    ``advance`` and ``done``) whose per-state vocabulary mask every
    emitted token obeys; the request retires with ``"stop"`` the moment
    the automaton completes."""

    prompt_ids: np.ndarray
    max_new_tokens: int = 20
    temperature: float = 0.0
    seed: int = 0
    deadline: Optional[float] = None
    on_token: Optional[Callable] = None
    priority: int = 0
    pin_session: bool = False
    session_of: Optional[object] = None
    stop_token: Optional[int] = None
    n: int = 1
    structured: Optional[object] = None
    request_id: str = field(
        default_factory=lambda: f"req-{next(_req_counter)}")

    def __post_init__(self):
        self.prompt_ids = np.asarray(self.prompt_ids,
                                     np.int32).reshape(-1)
        if self.prompt_ids.size == 0:
            raise ValueError("prompt_ids must be non-empty")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}"
                " (a serve request that generates nothing is a no-op)")
        if self.stop_token is not None:
            self.stop_token = int(self.stop_token)
        self.n = int(self.n)
        if self.n < 1:
            raise ValueError(f"n must be >= 1, got {self.n}")
        if self.n > 1 and self.pin_session:
            raise ValueError(
                f"n={self.n} with pin_session: a pinned session continues "
                f"ONE stream; submit n=1 with pin_session and fork() the "
                f"continuation instead")
        if self.n > 1 and self.max_new_tokens < 2:
            raise ValueError(
                f"n={self.n} with max_new_tokens={self.max_new_tokens}: "
                f"the branches share the prompt and the first sampled "
                f"token, so a 1-token request has nothing to diverge on; "
                f"raise max_new_tokens or drop n")
        if self.structured is not None:
            for attr in ("initial", "mask", "advance", "done"):
                if not callable(getattr(self.structured, attr, None)):
                    raise ValueError(
                        f"structured= must be a token automaton with "
                        f"initial()/mask()/advance()/done() (see "
                        f"serve.structured.JsonSchemaAutomaton); "
                        f"{type(self.structured).__name__} has no "
                        f"callable {attr!r}")


@dataclass
class GenerationResult:
    """Terminal state of a request.  ``tokens`` is prompt +
    continuation (the array offline ``generate`` returns);
    ``finish_reason`` is ``"length"``, ``"stop"`` (the stop token, or a
    structured request's automaton completed) or ``"pruned"`` (a fork
    branch cut by ``prune()``, with everything emitted so far).
    Latencies are on the engine's clock: ``ttft`` is submit to first
    token, ``tpot`` the mean time between tokens after it.
    ``session``: the pinned ``SessionHandle`` of a ``pin_session``
    request, else None.  ``branch``: the branch of a fork group (0 for
    plain requests); ``score``: a fork branch's summed log-probability
    of its chosen tokens under the raw float32 distribution, the shared
    first token scoring 0.0 (None outside a fork group)."""

    request_id: str
    tokens: np.ndarray
    finish_reason: str
    ttft: float
    tpot: Optional[float]
    queue_time: float
    admitted_step: int
    finished_step: int
    session: Optional[object] = None
    branch: int = 0
    score: Optional[float] = None


class RequestHandle:
    """Caller-side view of a submitted request.  ``done()`` flips when
    the engine retires or rejects it; ``result()`` returns the
    :class:`GenerationResult` or raises the rejection."""

    def __init__(self, request: GenerationRequest):
        self.request = request
        self._result: Optional[GenerationResult] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._result is not None or self._error is not None

    def result(self) -> GenerationResult:
        if self._error is not None:
            raise self._error
        if self._result is None:
            raise RuntimeError(
                f"{self.request.request_id} not finished; drive the "
                "engine (step()/run_until_complete()) first")
        return self._result

    def _finish(self, result: GenerationResult):
        self._result = result

    def _reject(self, error: BaseException):
        self._error = error
