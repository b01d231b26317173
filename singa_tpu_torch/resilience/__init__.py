"""Resilience (counterpart of ``singa_tpu/resilience``): fault injection
sites (``faults``), retry policies (``retry``) and the
``CheckpointManager`` (``checkpoint``: step directories with manifests,
retention, and the fallback past corrupt checkpoints)."""

from . import faults  # noqa: F401
from . import retry  # noqa: F401
from .checkpoint import (CheckpointCorruptError,  # noqa: F401
                         CheckpointManager, NoValidCheckpointError)
from .faults import (FaultInjected, FailAfterN, FailOnce,  # noqa: F401
                     FailRate, Latency, clear, inject, injected)
from .retry import (RetryBudgetExceededError, RetryPolicy,  # noqa: F401
                    is_transient, retry_call)
