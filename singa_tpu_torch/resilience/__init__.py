"""Resilience (counterpart of ``singa_tpu/resilience``): fault injection
sites and retry policies.  The JAX package's ``CheckpointManager``
(``resilience/checkpoint.py``) is not ported yet."""

from . import faults  # noqa: F401
from . import retry  # noqa: F401
from .faults import (FaultInjected, FailAfterN, FailOnce,  # noqa: F401
                     FailRate, Latency, clear, inject, injected)
from .retry import (RetryBudgetExceededError, RetryPolicy,  # noqa: F401
                    is_transient, retry_call)
