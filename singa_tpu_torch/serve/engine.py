"""Continuous-batching inference engine over the KV-cached GPT-2 decoder
(counterpart of ``singa_tpu/serve/engine.py``).

* **iteration-level steps**: each ``step()`` advances every live slot
  by one token in one batched pool step, retires requests that reached
  their budget or stop token at once, and backfills freed slots from the
  scheduler's queue in the same step;
* **the slot arena** (``paged=None``, the default): one dense cache row
  of ``max_len`` positions a slot, ``(L, max_slots, H_kv, max_len,
  D)``; an admission writes its prefilled row into its slot, and the
  step advances every slot at once over fixed shapes, dead slots on
  clamped inputs (token 0, position 0) whose outputs are ignored;
* **paged KV** (``paged=PagedConfig(...)``, ``serve/paged.py``): one
  block pool; admission is bounded by free blocks as well as free
  slots, a request's KV grows block by block (each step first grows
  every live slot's block table to cover the position it writes);
* **preemption** (paged only, as in the JAX engine): when the pool runs
  out, a strictly-lower-priority live request is swapped to host memory
  (its blocks freed, its KV kept as a byte copy), or a slot that cannot
  grow swaps itself out; swapped requests resume, highest priority
  first, as blocks return, and continue exactly where they stopped;
* **int8 KV** (``cache_dtype="int8"``, either arena): the arena or pool
  holds (int8 values, float32 per-row scales) pairs; admission prefill
  quantizes its rows, each step quantizes the K/V it writes, and swap
  images carry the scales;
* **exactness**: an admission prefills its prompt at its own length and
  samples the first token as ``generate`` does; each decode step runs
  the dense ``decode_step`` (slot arena: the per-row math of offline
  ``generate``), ``decode_step_paged`` (the ``paged_attn`` kernel,
  ``kernel="block"``) or the dense gather oracle (``kernel="gather"``),
  and samples with noise keyed by (seed, position), so float32 streams
  equal offline ``generate`` (at the same ``cache_dtype``) away from
  exact argmax ties.

The device work goes through :class:`_LocalExec`, the seam that the JAX
engine's sharded executors plug into.  The JAX engine's per-row
functions, vmapped over slots there (``_decode_row_paged``,
``_decode_row``, ``_select_sample``), are slot dimensions here:
:func:`_pool_decode_step` and ``serve/paged.py``'s
``_paged_decode_kernel`` and ``_paged_decode_step`` return every lane's
logits, and ``gpt2_decode._sample`` takes each row's temperature, so
greedy and sampled rows share one call.

**Captured decode steps** (``capture=True``, the default; the JAX engine
jits its pool step): the slot arena's step has one width, ``max_slots``;
a paged step's width is the halving bucket of ``max_slots`` covering the
live slots (``_paged_width``).  Each width's step (the forward with its
``paged_attn`` launches, the in-place cache writes and the sampling)
reads its inputs from persistent device buffers
(``paged.DecodeInputs``), which the engine fills with one staged
host-to-device copy a step.  A width's first step runs eagerly, as a
real step, and the step is then captured as a CUDA graph (``graphs.py``;
all of an engine's graphs share one memory pool); every later step at
that width is one replay, after which the host reads the step's tokens
once.  On the CPU the same widths, buffers and first-step rule run the
step function itself.  ``capture=False`` runs every step eagerly, like
``jax.disable_jit``; the gather oracle (``kernel="gather"``) and the
admission prefill always run eagerly.  ``serve.jitpin.jit_cache_size()``
counts the prepared steps of the open engines.

Not ported yet, each refused with ``NotImplementedError`` at
construction or submit (``ROADMAP.md``): the prefix cache and sessions,
speculative decoding (``draft_model``, ``spec_k``), tensor / expert /
pipeline parallelism (``tp``, ``ep``, ``pp``), fork (``n > 1``),
structured decoding, SLO targets and load shedding, sliding-window
models.  The JAX engine's preemption paths for those (window drops,
copy-on-write forks, speculative draft rows, prefix-cache eviction) are
not ported with them, and its ``_paged_retire`` (prefix-cache adoption
of a retiring slot's blocks) is ``_free_slot_blocks`` here.
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from .. import graphs
from ..models.gpt2_decode import (_check_sampling, _leaves, _logits,
                                  _quant_flag, _sample, check_decodable,
                                  decode_step, extract_params, kv_zeros,
                                  prefill)
from ..observe import trace as _trace
from . import jitpin
from .paged import (DecodeInputs, PagedConfig, PagedKVArena, _embed,
                    _paged_decode_kernel, _paged_decode_step, seeds)
from .request import (DeadlineExceededError, EngineFailedError,
                      GenerationRequest, GenerationResult, RequestHandle)
from .scheduler import FIFOScheduler, PriorityScheduler
from .stats import EngineStats

__all__ = ["InferenceEngine"]


def _owed(what):
    raise NotImplementedError(f"{what} is not ported to the serve engine "
                              f"yet (ROADMAP.md)")


def _prefill_batch(params, ids, n_head, eps, quant=False):
    """Admission prefill of R prompts of one length: ids (R, P) ->
    (last-position logits (R, V) float32, k rows, v rows (L, R, H_kv, P,
    D), quantized (values, scales) pairs with ``quant``).  At R = 1 it is
    the JAX engine's ``_prefill_one``."""
    hidden, kc, vc = prefill(params, ids, n_head, eps, quant_cache=quant)
    return _logits(hidden[:, -1], params).float(), kc, vc


def _pool_decode_step(params, kc, vc, inp, n_head, eps):
    """The slot arena's step: advance EVERY slot one token.  ``inp``: the
    slots' device inputs (:meth:`DecodeInputs.view` at width
    ``max_slots``), arenas (L, S, H_kv, max_len, D) (or int8 pairs),
    written in place at each slot's position.  Dead slots run the same
    math on clamped inputs (token 0, position 0: fixed shapes; they write
    their own row's lane 0, which the next admission into the slot
    overwrites) and their outputs are ignored.  One ``decode_step`` over
    all slots, the per-row math of offline ``generate``.  Returns (S, V)
    logits."""
    live = inp["live"] != 0
    toks = torch.where(live, inp["toks"], 0)
    p_c = torch.where(live, inp["pos"], 0)
    logits, _, _ = decode_step(params, _embed(params, toks, p_c), kc, vc,
                               p_c, n_head, eps)
    return logits


def _row(c, r):
    """Row ``r`` of a batch of cache rows (L, R, ...) as (L, 1, ...), each
    leaf of an int8 pair."""
    if isinstance(c, tuple):
        return tuple(t[:, r:r + 1] for t in c)
    return c[:, r:r + 1]


def _write_slot(kc, vc, kc_row, vc_row, slot):
    """Install an admitted request's prefilled rows (L, 1, H_kv, P, D) at
    lanes [0, P) of ``slot`` in the arenas, every leaf; the lanes past P
    keep what they held, which no position of the request reads before
    it writes it."""
    for arena, row in ((kc, kc_row), (vc, vc_row)):
        for leaf, r in zip(_leaves(arena), _leaves(row)):
            leaf[:, slot, :, :r.shape[3]] = r[:, 0]


def _read_slot(kc, vc, slot):
    """A copy of ``slot``'s rows (L, 1, H_kv, max_len, D) (int8 pairs)."""
    def row(c):
        out = tuple(t[:, slot:slot + 1].clone() for t in _leaves(c))
        return out if isinstance(c, tuple) else out[0]

    return row(kc), row(vc)


class _LocalExec:
    """The engine's single-device executor: every device dispatch of the
    engine goes through this surface."""

    def __init__(self, eng):
        self._e = eng

    def pool_decode_step(self, params, kc, vc, inp):
        """(S, V) logits of the slot arena's step over every slot."""
        return _pool_decode_step(params, kc, vc, inp, **self._e._statics)

    def write_slot(self, kc, vc, kc_row, vc_row, slot):
        _write_slot(kc, vc, kc_row, vc_row, slot)

    def read_slot(self, kc, vc, slot):
        return _read_slot(kc, vc, slot)

    def paged_decode_step(self, params, pool_k, pool_v, inp, block,
                          kernel="block", n_rb=None):
        """(S, V) logits of one pool step over the lanes ``inp``
        (``DecodeInputs.view``); the gather oracle needs ``n_rb``, the
        blocks it copies a lane."""
        if kernel == "block":
            return _paged_decode_kernel(params, pool_k, pool_v, inp, block,
                                        **self._e._statics)
        return _paged_decode_step(params, pool_k, pool_v, inp, n_rb, block,
                                  **self._e._statics)

    def prefill_batch(self, params, ids):
        return _prefill_batch(params, ids, **self._e._statics,
                              quant=self._e._quant)


class _Slot:
    """Host bookkeeping of one live request; ``blocks`` is its block
    table (pool block ids)."""

    __slots__ = ("handle", "emitted", "remaining", "first_token_time",
                 "admit_time", "admitted_step", "blocks")

    def __init__(self, handle, max_new, now, step, blocks):
        self.handle = handle
        self.emitted = []
        self.remaining = max_new
        self.first_token_time = None
        self.admit_time = now
        self.admitted_step = step
        self.blocks = blocks


class _Swapped:
    """A preempted request's host-side state: the byte copy of its KV
    lanes and every scrap of slot bookkeeping, so a resume continues the
    exact token stream the uninterrupted run would have produced (its
    sampling noise is keyed by (seed, position)).  A swapped request has
    STARTED (its admission token streamed): an engine failure rejects it
    with ``started=True``."""

    __slots__ = ("handle", "request", "emitted", "remaining",
                 "first_token_time", "admit_time", "admitted_step", "pos",
                 "tok", "temp", "seed", "image", "seq", "t_preempt")

    @property
    def priority(self):
        return self.request.priority


class InferenceEngine:
    """In-process continuous-batching engine for a ``GPT2LMHead``, on the
    model's device.

    >>> eng = model.serve(max_slots=8)      # or paged=PagedConfig(...)
    >>> h = eng.submit(GenerationRequest(prompt, max_new_tokens=32))
    >>> eng.run_until_complete()
    >>> h.result().tokens      # == model.generate(prompt, ...)

    ``paged`` (default None: the slot arena) is a ``PagedConfig``, a dict
    of its arguments or True; ``cache_dtype="int8"`` keeps the KV as int8
    values with per-row scales (``model.generate(...,
    cache_dtype="int8")`` is then the offline oracle).  ``max_len``
    (default ``n_positions``) bounds prompt + ``max_new_tokens`` and is
    the slot arena's row width; ``dtype`` casts the weights
    (``torch.bfloat16``);
    ``top_k`` / ``top_p`` are engine-wide filters of sampled requests;
    ``scheduler`` is ``"fifo"`` (default), ``"priority"`` or an
    instance; ``clock`` is injectable for tests; ``capture`` (default
    True) replays each decode width's step as a CUDA graph on the card
    (module docstring), ``False`` runs every step eagerly."""

    def __init__(self, model, max_slots=8, max_len=None, dtype=None,
                 scheduler=None, top_k=0, top_p=None,
                 clock=time.monotonic, slo=None, prefix_cache=None,
                 draft_model=None, spec_k=None, cache_dtype=None,
                 paged=None, tp=None, ep=None, pp=None, capture=True):
        cfg = model.cfg
        check_decodable(cfg)
        owed = [("prefix_cache", prefix_cache not in (None, False)),
                ("speculative decoding (draft_model, spec_k)",
                 draft_model is not None or spec_k is not None),
                ("tensor/expert/pipeline-parallel serving (tp, ep, pp)",
                 any(x not in (None, False) for x in (tp, ep, pp))),
                ("SLO targets and load shedding (slo)", slo is not None)]
        for what, asked in owed:
            if asked:
                _owed(what)
        self._quant = _quant_flag(cache_dtype)
        if paged is False:
            paged = None
        elif paged is True:
            paged = PagedConfig()
        elif isinstance(paged, dict):
            paged = PagedConfig(**paged)
        if paged is not None and not isinstance(paged, PagedConfig):
            raise ValueError(f"paged must be a PagedConfig, a kwargs dict, "
                             f"True or None, got {type(paged)}")
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.model = model
        self.cfg = cfg
        self.max_slots = int(max_slots)
        self.max_len = int(max_len or cfg.n_positions)
        if self.max_len > cfg.n_positions:
            raise ValueError(f"max_len ({self.max_len}) exceeds n_positions "
                             f"({cfg.n_positions})")
        if paged is not None and self.max_len % paged.block_size != 0:
            raise ValueError(
                f"max_len ({self.max_len}) must be a multiple of the paged "
                f"block_size ({paged.block_size}) so block tables tile the "
                f"row exactly")
        self._top_k = _check_sampling(top_k, top_p, cfg.vocab_size)
        self._top_p = top_p
        self._clock = clock
        if scheduler == "priority":
            scheduler = PriorityScheduler()
        elif scheduler == "fifo":
            scheduler = FIFOScheduler()
        elif isinstance(scheduler, str):
            raise ValueError(f"unknown scheduler {scheduler!r}: pass "
                             f"'fifo', 'priority', or a scheduler instance")
        self.scheduler = scheduler or FIFOScheduler()
        self.stats = EngineStats(self.max_slots, clock)

        model.eval()
        self._params = extract_params(model, dtype=dtype)
        self._statics = dict(n_head=cfg.n_head,
                             eps=float(cfg.layer_norm_eps))
        self._x = _LocalExec(self)
        L, H_kv, D = cfg.n_layer, cfg.n_kv_head, cfg.n_embd // cfg.n_head
        cdt = self._params["wte"].dtype
        dev = self._params["wte"].device
        self.paged_arena = None
        self._kc = self._vc = None
        if paged is not None:
            self.paged_arena = PagedKVArena(
                paged, L, H_kv, D, cdt, self.max_len, dev,
                engine_label=self.stats.engine_label,
                reg=self.stats.registry, quant=self._quant)
            self.stats.paged_source = self.paged_arena.snapshot
            row_blocks = self.paged_arena.row_blocks
        else:
            shape = (L, self.max_slots, H_kv, self.max_len, D)
            self._kc = kv_zeros(shape, cdt, self._quant, dev)
            self._vc = kv_zeros(shape, cdt, self._quant, dev)
            row_blocks = 0
        self.capture = bool(capture)
        self._inputs = DecodeInputs(self.max_slots, row_blocks, dev)
        self._steps = {}  # decode width -> graphs.Step
        self._graph_pool = None
        jitpin.track(self)
        S = self.max_slots
        self._slots = [None] * S
        self._toks = np.zeros(S, np.int64)
        self._pos = np.zeros(S, np.int64)
        self._temps = np.zeros(S, np.float32)
        self._seeds = np.zeros(S, np.int64)
        self._handles = {}
        self._swapped = []
        self._swap_seq = itertools.count()
        self._closed = False
        self._failed = False
        self.step_count = 0

    # -- submission ------------------------------------------------------
    def submit(self, request) -> RequestHandle:
        """Queue a request; returns a handle at once.  Raises
        ``QueueFullError`` under back-pressure and ``ValueError`` for a
        request that could never fit."""
        self._check_open()
        if not isinstance(request, GenerationRequest):
            request = GenerationRequest(np.asarray(request))
        self.validate_request(request)
        if request.request_id in self._handles:
            raise ValueError(f"request_id {request.request_id!r} is already "
                             f"in flight")
        handle = RequestHandle(request)
        self.stats.on_submit()
        try:
            self.scheduler.enqueue(request)
        except Exception:
            self.stats.on_queue_full()
            _trace.event("serve/request_rejected", cat="serve",
                         request=request.request_id, reason="queue_full")
            raise
        handle._submit_time = self._clock()
        self._handles[request.request_id] = handle
        return handle

    def validate_request(self, request):
        """Raise for a request this engine could never serve: prompt +
        ``max_new_tokens`` beyond ``max_len``, more blocks than the pool
        holds, or a feature not ported yet."""
        if request.n > 1:
            _owed("fork (GenerationRequest(n > 1))")
        if request.structured is not None:
            _owed("structured decoding")
        if request.pin_session:
            _owed("pin_session (prefix-cache sessions)")
        plen = len(request.prompt_ids)
        need = plen + request.max_new_tokens
        if need > self.max_len:
            raise ValueError(
                f"prompt ({plen}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds the engine's max_len "
                f"({self.max_len})")
        arena = self.paged_arena
        if arena is None:
            return
        worst = (need - 1) // arena.block_size + 1
        if worst > arena.num_blocks:
            raise ValueError(
                f"request needs up to {worst} KV blocks but the paged pool "
                f"holds {arena.num_blocks}; raise PagedConfig.num_blocks or "
                f"lower max_new_tokens")

    @property
    def pending(self) -> bool:
        """True while any request is queued, holds a slot, or is swapped
        out awaiting resume."""
        return (self.scheduler.queue_depth > 0
                or any(s is not None for s in self._slots)
                or bool(self._swapped))

    @property
    def live_slots(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def live_request_ids(self):
        """Ids of the requests that have STARTED: holding a slot or
        swapped out (a swapped request streamed at least its admission
        token), so never safely re-runnable elsewhere."""
        ids = {s.handle.request.request_id
               for s in self._slots if s is not None}
        ids.update(sw.request.request_id for sw in self._swapped)
        return ids

    def check_block_accounting(self):
        """Leak check: every used pool block belongs to a live slot's
        table.  Raises AssertionError naming the counts; returns the
        used-block count."""
        arena = self.paged_arena
        if arena is None:
            return 0
        owned = {b for s in self._slots if s is not None for b in s.blocks
                 if b != arena.trash}
        if arena.blocks_used != len(owned):
            raise AssertionError(
                f"paged-arena block leak: {arena.blocks_used} blocks used, "
                f"{len(owned)} held by live slots")
        return arena.blocks_used

    def close(self, force=False):
        """Release the pool and unregister the metrics.  The engine must
        be drained first unless ``force``.  Idempotent; also the
        context-manager exit."""
        if self._closed:
            return
        if self.pending and not force:
            raise RuntimeError(
                f"close() with work in flight (queue="
                f"{self.scheduler.queue_depth}, live={self.live_slots}); "
                f"drain with run_until_complete() first")
        if not force and not self._failed:
            self.check_block_accounting()
        self._steps = {}
        self._graph_pool = None
        self.stats.unregister()
        if self.paged_arena is not None:
            self.paged_arena.unregister()
        self._kc = self._vc = None
        self._params = None
        self._swapped = []
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        self.close(force=exc_type is not None)
        return False

    # -- the step loop ---------------------------------------------------
    def _check_open(self):
        if self._closed:
            raise RuntimeError(
                "engine is closed; build a new one with model.serve()")
        if self._failed:
            raise EngineFailedError("engine has failed; build a new one",
                                    engine_step=self.step_count)

    def step(self) -> bool:
        """One iteration: grow block tables, decode every live slot by
        one token, retire finished requests, backfill freed slots.
        Returns ``pending``.  A raising step fails the engine: every
        in-flight and queued request is rejected typed and the error
        raises."""
        self._check_open()
        try:
            with torch.no_grad():
                self._grow_live_slots()
                if any(s is not None for s in self._slots):
                    self._decode_once()
                self._schedule(self._clock())
        except Exception as e:
            err = self._fail(e)
            if err is e:
                raise
            raise err from e
        self.stats.on_schedule(self.scheduler.queue_depth)
        self.step_count += 1
        return self.pending

    def run_until_complete(self, max_steps=None):
        """Drive ``step()`` until every submitted request resolves."""
        steps = 0
        while self.pending:
            self.step()
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(
                    f"engine did not drain within {max_steps} steps "
                    f"(queue={self.scheduler.queue_depth}, "
                    f"live={self.live_slots})")

    def _fail(self, cause):
        """Reject every live or swapped-out (``started=True``) and queued
        (``started=False``) request typed and return the error for
        ``step()`` to raise: ``cause`` itself when it is an
        ``EngineFailedError``."""
        self._failed = True
        step = self.step_count
        err = cause if isinstance(cause, EngineFailedError) else \
            EngineFailedError(f"engine failed at step {step}: {cause!r}",
                              engine_step=step)
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            self._free_slot_blocks(slot)
            rid = slot.handle.request.request_id
            slot.handle._reject(EngineFailedError(
                f"{err} ({rid} was in flight, {len(slot.emitted)} tokens "
                f"emitted)", request_id=rid, started=True, engine_step=step))
            self._slots[i] = None
            self._handles.pop(rid, None)
        for sw in self._swapped:
            rid = sw.request.request_id
            sw.handle._reject(EngineFailedError(
                f"{err} ({rid} was swapped out mid-decode, "
                f"{len(sw.emitted)} tokens emitted)", request_id=rid,
                started=True, engine_step=step))
            self._handles.pop(rid, None)
        self._swapped = []
        for req in self.scheduler.drain():
            h = self._handles.pop(req.request_id, None)
            if h is not None:
                h._reject(EngineFailedError(
                    f"{err} ({req.request_id} was queued)",
                    request_id=req.request_id, started=False,
                    engine_step=step))
        return err

    def _decode_once(self):
        lanes = [i for i, s in enumerate(self._slots) if s is not None]
        n = len(lanes)
        arena = self.paged_arena
        if arena is None:
            # the slot arena: slot i is lane i, every slot steps
            w = self.max_slots
            sel = [i if s is not None else -1
                   for i, s in enumerate(self._slots)]
        else:
            w = self._paged_width(n)
            sel = lanes + [-1] * (w - n)
        live = np.asarray([i >= 0 for i in sel])
        pick = np.where(live, sel, 0)
        self._inputs.stage(self._toks[pick], self._pos[pick], live,
                           self._seeds[pick], np.where(live,
                                                       self._temps[pick], 0),
                           self._block_tables(sel))
        with _trace.span("serve/decode_step", cat="serve",
                         step=self.step_count, live=n, width=w):
            self._inputs.load()
            if arena is not None and arena.config.kernel == "gather":
                n_rb = int(self._pos[lanes].max()) // arena.block_size + 1
                toks = self._decode_fn(w, n_rb)()
            else:
                toks = self._decode_captured(w)
            nxt = toks.cpu().numpy()
        self.stats.on_decode_step(n)
        now = self._clock()
        for r, i in enumerate(sel):
            if i >= 0:
                self._toks[i] = nxt[r]
                self._pos[i] += 1
                self._emit(i, self._slots[i], int(nxt[r]), now)

    def _decode_fn(self, w, n_rb=None):
        """The decode step at width ``w``: the pool step over the first
        ``w`` lanes of the device inputs (the slot arena's over all its
        slots) and the sampling, returning (w,) int64 tokens."""
        arena = self.paged_arena
        inp = self._inputs.view(w)

        def step():
            if arena is None:
                logits = self._x.pool_decode_step(self._params, self._kc,
                                                  self._vc, inp)
            else:
                logits = self._x.paged_decode_step(
                    self._params, arena.pool_k, arena.pool_v, inp,
                    arena.block_size, kernel=arena.config.kernel,
                    n_rb=n_rb)
            return _sample(logits, inp["temps"], seeds(inp),
                           inp["pos"].long() + 1, self._top_k, self._top_p)

        return step

    def _decode_captured(self, w):
        """(w,) tokens of one step at width ``w`` (the slot arena's, or a
        block-kernel step): a replay of the width's captured step; the
        first step at a width runs eagerly and then captures it (which
        runs nothing), so no request advances twice."""
        step = self._steps.get(w)
        if step is not None:
            return step()
        fn = self._decode_fn(w)
        if not self.capture:
            return fn()
        dev = self._inputs.buf.device
        toks = graphs.warm(fn, dev)
        if dev.type == "cuda" and self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        self._steps[w] = graphs.Step(fn, dev, pool=self._graph_pool)
        return toks

    def _emit(self, idx, slot, token, now):
        slot.emitted.append(token)
        slot.remaining -= 1
        req = slot.handle.request
        self.stats.on_token()
        if slot.first_token_time is None:
            slot.first_token_time = now
        if req.on_token is not None:
            try:
                req.on_token(req, token)
            except Exception as e:  # the client's callback: reject it alone
                self._free_slot_blocks(slot)
                self._slots[idx] = None
                self._handles.pop(req.request_id, None)
                _trace.event("serve/request_rejected", cat="serve",
                             request=req.request_id,
                             reason="on_token_callback")
                slot.handle._reject(e)
                return
        stop = req.stop_token is not None and token == req.stop_token
        if stop or slot.remaining <= 0:
            self._retire(idx, slot, now, "stop" if stop else "length")

    def _retire(self, idx, slot, now, finish_reason):
        req = slot.handle.request
        n = len(slot.emitted)
        _trace.event("serve/retire", cat="serve", request=req.request_id,
                     slot=idx, tokens=n, step=self.step_count)
        submit_t = getattr(slot.handle, "_submit_time", slot.admit_time)
        result = GenerationResult(
            request_id=req.request_id,
            tokens=np.concatenate([req.prompt_ids,
                                   np.asarray(slot.emitted, np.int32)]),
            finish_reason=finish_reason,
            ttft=slot.first_token_time - submit_t,
            tpot=((now - slot.first_token_time) / (n - 1)
                  if n > 1 else None),
            queue_time=slot.admit_time - submit_t,
            admitted_step=slot.admitted_step,
            finished_step=self.step_count)
        self._free_slot_blocks(slot)
        slot.handle._finish(result)
        self.stats.on_complete(result)
        self._slots[idx] = None
        self._handles.pop(req.request_id, None)

    def _free_slot_blocks(self, slot):
        arena = self.paged_arena
        if arena is not None:
            arena.free([b for b in slot.blocks if b != arena.trash])
        slot.blocks = []

    def _block_tables(self, idxs):
        """(len(idxs), max_len // B) int32 block tables, trash-padded;
        entries of ``idxs`` < 0 are dead lanes (all trash).  The slot
        arena has none: (len(idxs), 0)."""
        arena = self.paged_arena
        if arena is None:
            return np.zeros((len(idxs), 0), np.int32)
        tables = np.full((len(idxs), arena.row_blocks), arena.trash,
                         np.int32)
        for r, i in enumerate(idxs):
            if i >= 0:
                blocks = self._slots[i].blocks
                tables[r, :len(blocks)] = blocks
        return tables

    def _paged_width(self, n_live):
        """Decode width for ``n_live`` live slots: the smallest halving
        bucket of ``max_slots`` ({S, S/2, S/4, ...}) that covers them."""
        w = self.max_slots
        while w >= 2 and w >= 2 * n_live:
            w //= 2
        return max(w, n_live)

    def _grow_live_slots(self):
        """Before the decode step, every live slot must own the block
        holding the position it writes.  A slot that cannot grow (pool
        exhausted, no strictly-lower-priority victim) swaps itself out:
        its blocks free the pool for the others and it resumes once
        capacity returns, so the pool never livelocks with every slot
        too big to advance.  The slot arena's rows are whole: nothing to
        grow."""
        if self.paged_arena is None:
            return
        B = self.paged_arena.block_size
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            short = int(self._pos[i]) // B + 1 - len(slot.blocks)
            if short <= 0:
                continue
            got = self._alloc_blocks(short, slot.handle.request.priority,
                                     exclude_idx=i)
            if got is None:
                self._preempt_slot(i, reason="pool_exhausted")
                continue
            slot.blocks.extend(got)

    def _alloc_blocks(self, n, priority, exclude_idx=None):
        """``n`` pool blocks for a request at ``priority``, preempting
        strictly-lower-priority live slots (lowest priority, then latest
        admitted) until the allocation fits, or None.  Strictly lower
        only: equal priorities never preempt each other, which is what
        makes every preemption chain end.  Feasibility is checked before
        any side effect: if the free blocks and every eligible victim's
        blocks together cannot cover ``n``, nothing is preempted (that
        would be pure swap churn)."""
        arena = self.paged_arena
        avail = arena.blocks_free + sum(
            sum(1 for b in s.blocks
                if b != arena.trash and arena.ref_count(b) == 1)
            for i, s in enumerate(self._slots)
            if s is not None and i != exclude_idx
            and s.handle.request.priority < priority)
        if n > avail:
            return None
        while True:
            got = arena.alloc(n)
            if got is not None:
                return got
            victim = self._pick_victim(priority, exclude=exclude_idx)
            if victim is None:
                return None
            self._preempt_slot(victim, reason="preempted")

    def _pick_victim(self, below_priority, exclude=None):
        """The live slot to preempt for a ``below_priority`` claimant:
        strictly lower priority only; the lowest first, ties to the
        latest admitted (least sunk progress).  None when nothing
        qualifies."""
        best = None
        for i, s in enumerate(self._slots):
            if s is None or i == exclude:
                continue
            p = s.handle.request.priority
            if p >= below_priority:
                continue
            k = (p, -s.admitted_step)
            if best is None or k < best[0]:
                best = (k, i)
        return None if best is None else best[1]

    def _preempt_slot(self, idx, reason):
        """Swap one live request to host memory and free its blocks: one
        gather and one copy of the lanes it has written, and its slot
        bookkeeping saved for the resume."""
        arena = self.paged_arena
        slot = self._slots[idx]
        req = slot.handle.request
        pos = int(self._pos[idx])
        sw = _Swapped()
        sw.handle = slot.handle
        sw.request = req
        sw.emitted = slot.emitted
        sw.remaining = slot.remaining
        sw.first_token_time = slot.first_token_time
        sw.admit_time = slot.admit_time
        sw.admitted_step = slot.admitted_step
        sw.pos = pos
        sw.tok = int(self._toks[idx])
        sw.temp = float(self._temps[idx])
        sw.seed = int(self._seeds[idx])
        sw.seq = next(self._swap_seq)
        sw.t_preempt = self._clock()
        # the blocks holding positions < pos; pos itself is written next
        sw.image = arena.swap_out(slot.blocks, (pos - 1) // arena.block_size
                                  + 1)
        n_freed = len(slot.blocks)
        self._free_slot_blocks(slot)
        self._slots[idx] = None
        self._swapped.append(sw)
        arena.on_preempt()
        _trace.event("serve/preempt", cat="serve", request=req.request_id,
                     slot=idx, reason=reason, pos=pos, blocks_freed=n_freed,
                     tokens=len(sw.emitted))

    def _try_resume(self, now):
        """Resume swapped-out requests, highest priority first (FIFO
        within a priority): allocate the blocks up to the one its next
        position writes (preempting strictly-lower live slots if need
        be), scatter the host copy back, restore the slot.  If the head
        does not fit, nothing behind it jumps the line."""
        arena = self.paged_arena
        while self._swapped:
            # a resume's own preemption appends to the list: sort again
            self._swapped.sort(key=lambda s: (-s.priority, s.seq))
            free = self._free_slots()
            if not free:
                return
            sw = self._swapped[0]
            blocks = self._alloc_blocks(sw.pos // arena.block_size + 1,
                                        sw.priority)
            if blocks is None:
                return
            idx = free[0]
            arena.swap_in(sw.image, blocks)
            slot = _Slot(sw.handle, sw.remaining, sw.admit_time,
                         sw.admitted_step, blocks)
            slot.emitted = sw.emitted
            slot.first_token_time = sw.first_token_time
            self._slots[idx] = slot
            self._toks[idx] = sw.tok
            self._pos[idx] = sw.pos
            self._temps[idx] = sw.temp
            self._seeds[idx] = sw.seed
            self._swapped.pop(0)
            _trace.event("serve/resume", cat="serve",
                         request=sw.request.request_id, slot=idx,
                         pos=sw.pos, swapped_s=now - sw.t_preempt)

    def _blocked_priority(self):
        """A swapped request still waiting after the resume pass outranks
        fresh arrivals at or below its priority (it already streamed
        tokens): their admission waits behind it."""
        return (max(sw.priority for sw in self._swapped)
                if self._swapped else None)

    # -- admission -------------------------------------------------------
    def _free_slots(self):
        return [i for i, s in enumerate(self._slots) if s is None]

    def _reject_expired(self, expired, now):
        for req in expired:
            self.stats.on_deadline_expired()
            _trace.event("serve/request_rejected", cat="serve",
                         request=req.request_id, reason="deadline")
            self._handles.pop(req.request_id)._reject(DeadlineExceededError(
                f"{req.request_id}: deadline {req.deadline} passed at {now} "
                f"before a slot was available"))

    def _schedule(self, now):
        """Resume swapped-out requests first (they already streamed
        tokens), then admit queued requests into free slots while their
        first blocks fit, preempting strictly-lower-priority slots for
        them (a request whose blocks do not fit, or that a swapped
        request outranks, waits at the head of the queue), prefill the
        admitted ones (one batched prefill per prompt length) and emit
        their first tokens."""
        self._try_resume(now)
        if self.scheduler.queue_depth == 0:
            return
        free = self._free_slots()
        admit, expired = self.scheduler.schedule(len(free), now)
        self._reject_expired(expired, now)
        arena = self.paged_arena
        blocked_p = self._blocked_priority()
        placed = []
        for k, req in enumerate(admit):
            blocks = None
            if arena is None:
                blocks = []
            elif blocked_p is None or req.priority > blocked_p:
                blocks = self._alloc_blocks(
                    len(req.prompt_ids) // arena.block_size + 1,
                    req.priority)
            if blocks is None:
                for r in reversed(admit[k:]):
                    self.scheduler.requeue_front(r)
                break
            placed.append((free.pop(0), req, blocks))
        by_len = {}
        for p in placed:
            by_len.setdefault(len(p[1].prompt_ids), []).append(p)
        dev = self._params["wte"].device
        for plen, group in by_len.items():
            ids = torch.as_tensor(np.stack([r.prompt_ids for _, r, _ in group]),
                                  device=dev)
            with _trace.span("serve/prefill", cat="serve", prompt_len=plen,
                             requests=len(group), step=self.step_count):
                logits, kc, vc = self._x.prefill_batch(self._params, ids)
            self.stats.on_prefill()
            for r, (idx, req, blocks) in enumerate(group):
                self._admit(idx, req, now, blocks, logits[r:r + 1],
                            _row(kc, r), _row(vc, r))

    def _admit(self, idx, req, now, blocks, logit, kc_row, vc_row):
        """Write one prefilled request's K/V into its blocks (the slot
        arena: into its slot), sample its first token (position ``plen``)
        and emit it."""
        handle = self._handles[req.request_id]
        plen = len(req.prompt_ids)
        if self.paged_arena is None:
            self._x.write_slot(self._kc, self._vc, kc_row, vc_row, idx)
        else:
            self.paged_arena.scatter_row(kc_row, vc_row,
                                         dict(enumerate(blocks)))
        temp = np.float32(req.temperature)
        tok0 = int(_sample(logit, [temp], [req.seed], [plen], self._top_k,
                           self._top_p)[0])
        t_first = self._clock()
        slot = _Slot(handle, req.max_new_tokens, now, self.step_count,
                     blocks)
        self._slots[idx] = slot
        self.stats.on_admission(now - getattr(handle, "_submit_time", now),
                                t_first - now)
        self._toks[idx] = tok0
        self._pos[idx] = plen
        self._temps[idx] = temp
        self._seeds[idx] = req.seed
        self._emit(idx, slot, tok0, t_first)
