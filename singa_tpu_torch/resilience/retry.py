"""Retry policies (counterpart of ``singa_tpu/resilience/retry.py``):
exponential backoff with jitter, retry budgets, and the transient/fatal
split of errors.

:func:`is_transient` retries OS-level I/O errors (``OSError`` and its
subclasses), ``TimeoutError`` and transient :class:`~.faults.FaultInjected`;
everything else is fatal and re-raised at the first attempt.  The JAX
package also names its ``io.binfile.CorruptRecordError`` fatal; the port
has no ``io`` module yet, so that branch comes with it.  Each
re-attempt increments ``resilience.retries{site=}`` and each spent budget
``resilience.gave_up{site=}``.  Jitter draws from a seeded RNG and
``sleep`` can be replaced, so tests are deterministic.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass

from ..observe import trace as _trace
from ..observe.registry import registry as _registry
from ..utils.logging import get_channel
from .faults import FaultInjected

__all__ = ["RetryPolicy", "RetryBudgetExceededError", "is_transient",
           "retry_call", "DEFAULT_POLICY"]


class RetryBudgetExceededError(RuntimeError):
    """Every attempt of a retryable operation failed transiently.  The
    last underlying error is chained as ``__cause__``; ``site`` and
    ``attempts`` say where and how hard we tried."""

    def __init__(self, site, attempts, last_error):
        super().__init__(
            f"{site}: gave up after {attempts} attempts "
            f"(last error: {last_error!r})")
        self.site = site
        self.attempts = attempts
        self.last_error = last_error


def is_transient(exc, extra_types=()) -> bool:
    """Default transient/fatal split.  Injected faults carry their own
    classification; ``extra_types`` are transient too."""
    if isinstance(exc, FaultInjected):
        return exc.transient
    if extra_types and isinstance(exc, tuple(extra_types)):
        return True
    return isinstance(exc, (OSError, TimeoutError))


@dataclass(frozen=True)
class RetryPolicy:
    """``max_attempts`` total tries (1 = no retry).  Delay before
    re-attempt k (0-based) is ``min(base * 2**k, max) * (1 + jitter *
    U[0,1))`` with U drawn from ``random.Random(seed)``.

    ``seed=None`` (the default) seeds from OS entropy per call, so N
    processes hitting the same shared-dependency failure at the same
    step retry at DECORRELATED instants — the thundering-herd breakup
    jitter exists for.  Pass an explicit seed for deterministic
    backoff sequences in tests."""

    max_attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.5
    seed: int | None = None

    def delay(self, attempt, rng) -> float:
        d = min(self.base_delay_s * (2 ** attempt), self.max_delay_s)
        return d * (1.0 + self.jitter * rng.random())


DEFAULT_POLICY = RetryPolicy()


def retry_call(fn, site, policy=None, classify=is_transient,
               sleep=time.sleep, reg=None):
    """Run ``fn()`` under ``policy``.  Fatal errors re-raise
    immediately; transient ones back off and retry until the budget is
    spent, then raise :class:`RetryBudgetExceededError` chained to the
    last error."""
    policy = policy if policy is not None else DEFAULT_POLICY
    reg = reg if reg is not None else _registry()
    rng = random.Random(policy.seed)
    log = get_channel("resilience")
    last = None
    for attempt in range(policy.max_attempts):
        try:
            return fn()
        except Exception as e:
            if not classify(e):
                raise
            last = e
            if attempt + 1 >= policy.max_attempts:
                break
            reg.counter(
                "resilience.retries",
                help="transient failures retried with backoff",
                site=site).inc()
            d = policy.delay(attempt, rng)
            _trace.event("resilience/retry", cat="resilience",
                         site=site, attempt=attempt + 1,
                         delay_s=round(d, 4), error=repr(e))
            log.warning("%s: transient failure (attempt %d/%d), "
                        "retrying in %.3fs: %r", site, attempt + 1,
                        policy.max_attempts, d, e)
            sleep(d)
    reg.counter(
        "resilience.gave_up",
        help="retry budgets exhausted (operation failed for good)",
        site=site).inc()
    _trace.event("resilience/gave_up", cat="resilience", site=site,
                 attempts=policy.max_attempts, error=repr(last))
    log.error("%s: retry budget exhausted after %d attempts: %r",
              site, policy.max_attempts, last)
    raise RetryBudgetExceededError(site, policy.max_attempts,
                                   last) from last

