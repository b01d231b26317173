"""Serving (counterpart of ``singa_tpu/serve``): the continuous-batching
engine over the slot arena (the default: a dense cache row a slot) or
the paged KV arena, whose decode path runs the paged decode attention
kernel (``ops/paged_attention.py``); either arena in the compute dtype or
as int8 values with per-row scales (``cache_dtype="int8"``).

    >>> eng = model.serve()                      # the slot arena
    >>> eng = model.serve(max_slots=8, paged=PagedConfig(block_size=32),
    ...                   cache_dtype="int8")    # paged, int8 KV
    >>> h = eng.submit(GenerationRequest(prompt_ids, max_new_tokens=32))
    >>> eng.run_until_complete()
    >>> h.result().tokens

Each decode width's step is captured as a CUDA graph on the card
(``InferenceEngine(capture=True)``, the default; the slot arena has one
width); ``jit_cache_size()`` counts the captured steps.
"""

from .engine import InferenceEngine
from .jitpin import jit_cache_size
from .paged import PagedConfig, PagedKVArena
from .request import (DeadlineExceededError, EngineFailedError,
                      GenerationRequest, GenerationResult, QueueFullError,
                      RequestHandle)
from .scheduler import FIFOScheduler, PriorityScheduler
from .stats import EngineStats

__all__ = ["InferenceEngine", "PagedConfig", "PagedKVArena",
           "GenerationRequest", "GenerationResult", "RequestHandle",
           "QueueFullError", "DeadlineExceededError", "EngineFailedError",
           "FIFOScheduler", "PriorityScheduler", "EngineStats",
           "jit_cache_size"]
