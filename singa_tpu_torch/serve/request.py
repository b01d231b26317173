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


@dataclass
class GenerationRequest:
    """One generation job.

    ``prompt_ids``: 1-D int token ids.  ``temperature <= 0`` is greedy
    decoding; otherwise ``seed`` keys the request's sampling noise, which
    depends on the seed and the position of the sampled token only (not
    on the slot or the batch), so the engine's streams equal offline
    ``generate`` at the same seed.  ``deadline`` is an absolute time on
    the engine's clock; a request still queued past it is rejected.
    ``on_token(request, token)`` streams each emitted token.
    ``priority`` orders admission under ``scheduler="priority"`` (higher
    first).  ``stop_token`` retires the request the moment it is
    emitted (``finish_reason="stop"``).

    ``pin_session``, ``n`` and ``structured`` are the JAX engine's
    prefix-cache sessions, parallel sampling (fork) and structured
    decoding; the port's engine raises ``NotImplementedError`` for
    them at submit."""

    prompt_ids: np.ndarray
    max_new_tokens: int = 20
    temperature: float = 0.0
    seed: int = 0
    deadline: Optional[float] = None
    on_token: Optional[Callable] = None
    priority: int = 0
    pin_session: bool = False
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


@dataclass
class GenerationResult:
    """Terminal state of a request.  ``tokens`` is prompt +
    continuation (the array offline ``generate`` returns);
    ``finish_reason`` is ``"length"`` or ``"stop"``.  Latencies are on
    the engine's clock: ``ttft`` is submit to first token, ``tpot`` the
    mean time between tokens after it."""

    request_id: str
    tokens: np.ndarray
    finish_reason: str
    ttft: float
    tpot: Optional[float]
    queue_time: float
    admitted_step: int
    finished_step: int


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
