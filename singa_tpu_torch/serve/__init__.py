"""Serving (counterpart of ``singa_tpu/serve``): the continuous-batching
engine over the paged KV arena, with the paged decode attention kernel
(``ops/paged_attention.py``) on its decode path.

    >>> eng = model.serve(max_slots=8, paged=PagedConfig(block_size=32))
    >>> h = eng.submit(GenerationRequest(prompt_ids, max_new_tokens=32))
    >>> eng.run_until_complete()
    >>> h.result().tokens
"""

from .engine import InferenceEngine
from .paged import PagedConfig, PagedKVArena
from .request import (DeadlineExceededError, EngineFailedError,
                      GenerationRequest, GenerationResult,
                      PoolExhaustedError, QueueFullError, RequestHandle)
from .scheduler import FIFOScheduler, PriorityScheduler
from .stats import EngineStats

__all__ = ["InferenceEngine", "PagedConfig", "PagedKVArena",
           "GenerationRequest", "GenerationResult", "RequestHandle",
           "QueueFullError", "DeadlineExceededError", "EngineFailedError",
           "PoolExhaustedError", "FIFOScheduler", "PriorityScheduler",
           "EngineStats"]
