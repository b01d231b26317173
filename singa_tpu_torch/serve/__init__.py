"""Serving (counterpart of ``singa_tpu/serve``): the continuous-batching
engine over the slot arena (the default: a dense cache row a slot) or
the paged KV arena, whose decode path runs the paged decode attention
kernel (``ops/paged_attention.py``); either arena in the compute dtype or
as int8 values with per-row scales (``cache_dtype="int8"``), with an
optional radix prefix cache and pinned multi-turn sessions
(``prefix_cache=PrefixCacheConfig(...)``, ``pin_session=True``),
speculative decoding with a draft model (``draft_model=``, ``spec_k=``),
a chunked-prefill token budget and admission interleave
(``PagedConfig(prefill_token_budget=, admit_per_step=)``),
sliding-window models on the paged arena, and on the paged arena fork
(``GenerationRequest(n=)``, ``eng.fork()``, ``eng.prune()``: branches
sharing KV blocks copy-on-write, ``ForkHandle`` / ``BranchHandle``) and
structured decoding (``GenerationRequest(structured=
JsonSchemaAutomaton(schema, vocab))``); serve SLOs
(``slo=observe.SLO(...)``) and the supervisor that rebuilds a failed
engine, requeues what it had not started and sheds under SLO pressure
(``EngineSupervisor``).

    >>> eng = model.serve()                      # the slot arena
    >>> eng = model.serve(max_slots=8, paged=PagedConfig(block_size=32),
    ...                   cache_dtype="int8")    # paged, int8 KV
    >>> h = eng.submit(GenerationRequest(prompt_ids, max_new_tokens=32))
    >>> eng.run_until_complete()
    >>> h.result().tokens

Each decode width's step is captured as a CUDA graph on the card
(``InferenceEngine(capture=True)``, the default; the slot arena and a
speculative engine have one width; a paged step is keyed too by whether
it takes vocabulary masks and returns log-probabilities);
``jit_cache_size()`` counts the captured steps.
"""

from .engine import InferenceEngine
from .ep import EPConfig
from .fork import BranchHandle, ForkHandle
from .jitpin import jit_cache_size
from .paged import PagedConfig, PagedKVArena
from .pp import PPConfig
from .prefix import PrefixCache, PrefixCacheConfig, SessionHandle
from .request import (DeadlineExceededError, EngineFailedError,
                      FleetDownError, GenerationRequest, GenerationResult,
                      LoadShedError, QueueFullError, RequestHandle,
                      RestartBudgetExceededError)
from .scheduler import FIFOScheduler, PriorityScheduler
from .stats import EngineStats
from .structured import JsonSchemaAutomaton, TokenAutomaton
from .supervisor import EngineSupervisor
from .tp import TPConfig

__all__ = ["InferenceEngine", "PagedConfig", "PagedKVArena",
           "GenerationRequest", "GenerationResult", "RequestHandle",
           "QueueFullError", "DeadlineExceededError", "EngineFailedError",
           "FIFOScheduler", "PriorityScheduler", "EngineStats",
           "jit_cache_size", "PrefixCache", "PrefixCacheConfig",
           "SessionHandle", "ForkHandle", "BranchHandle", "TokenAutomaton",
           "JsonSchemaAutomaton", "EngineSupervisor", "LoadShedError",
           "RestartBudgetExceededError", "FleetDownError", "TPConfig",
           "EPConfig", "PPConfig"]
