"""Continuous-batching inference engine over the KV-cached GPT-2 decoder
(counterpart of ``singa_tpu/serve/engine.py``, its paged branch).

* **iteration-level steps**: each ``step()`` grows every live slot's
  block table to cover the position it writes, advances every live slot
  by one token in one batched pool step, retires requests that reached
  their budget or stop token at once, and backfills freed slots from the
  scheduler's queue in the same step;
* **paged KV** (``paged=PagedConfig(...)``, ``serve/paged.py``): one
  block pool; admission is bounded by free blocks as well as free
  slots, and a request's KV grows block by block;
* **exactness**: an admission prefills its prompt at its own length and
  samples the first token as ``generate`` does; each decode step runs
  ``decode_step_paged`` (the ``paged_attn`` kernel, ``kernel="block"``)
  or the dense gather oracle (``kernel="gather"``), and samples with
  noise keyed by (seed, position), so float32 streams equal offline
  ``generate`` away from exact argmax ties.

The device work goes through :class:`_LocalExec`, the seam that the JAX
engine's sharded executors plug into.  The JAX engine's per-row
functions, vmapped over slots there (``_decode_row_paged``,
``_decode_row``, ``_select_sample``), are slot dimensions here:
``serve/paged.py``'s ``_paged_decode_kernel`` and ``_paged_decode_step``
return every lane's logits, and ``gpt2_decode._sample`` takes each row's
temperature, so greedy and sampled rows share one call.  Every step runs
eagerly; the
decode width is the halving bucket of ``max_slots`` covering the live
slots (``_paged_width``), the fixed widths a CUDA-graph capture of the
step would need.

Not ported yet, each refused with ``NotImplementedError`` at
construction or submit (``ROADMAP.md``): the slot arena (``paged=None``),
the prefix cache and sessions, speculative decoding (``draft_model``,
``spec_k``), int8 KV (``cache_dtype``), tensor / expert / pipeline
parallelism (``tp``, ``ep``, ``pp``), fork (``n > 1``), structured
decoding, SLO targets and load shedding, sliding-window models.
Preemption and swap are not ported either: a live slot that cannot grow
fails the engine with :class:`PoolExhaustedError`.  So the JAX engine's
``_alloc_blocks`` (allocation that preempts lower-priority slots) is
``PagedKVArena.alloc`` here, and its ``_paged_retire`` (prefix-cache
adoption of a retiring slot's blocks) is ``_free_slot_blocks``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models.gpt2_decode import (_check_sampling, _logits, _sample,
                                  check_decodable, extract_params, prefill)
from ..observe import trace as _trace
from .paged import (PagedConfig, PagedKVArena, _paged_decode_kernel,
                    _paged_decode_step)
from .request import (DeadlineExceededError, EngineFailedError,
                      GenerationRequest, GenerationResult,
                      PoolExhaustedError, RequestHandle)
from .scheduler import FIFOScheduler, PriorityScheduler
from .stats import EngineStats

__all__ = ["InferenceEngine"]


def _owed(what):
    raise NotImplementedError(f"{what} is not ported to the serve engine "
                              f"yet (ROADMAP.md)")


def _prefill_batch(params, ids, n_head, eps):
    """Admission prefill of R prompts of one length: ids (R, P) ->
    (last-position logits (R, V) float32, k rows, v rows (L, R, H_kv, P,
    D)).  At R = 1 it is the JAX engine's ``_prefill_one``."""
    hidden, kc, vc = prefill(params, ids, n_head, eps)
    return _logits(hidden[:, -1], params).float(), kc, vc


class _LocalExec:
    """The engine's single-device executor: every device dispatch of the
    engine goes through this surface."""

    def __init__(self, eng):
        self._e = eng

    def paged_decode_step(self, params, pool_k, pool_v, tables, toks, pos,
                          live, block, kernel="block"):
        fn = _paged_decode_kernel if kernel == "block" \
            else _paged_decode_step
        return fn(params, pool_k, pool_v, tables, toks, pos, live, block,
                  **self._e._statics)

    def prefill_batch(self, params, ids):
        return _prefill_batch(params, ids, **self._e._statics)


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


class InferenceEngine:
    """In-process continuous-batching engine for a ``GPT2LMHead``, on the
    model's device.

    >>> eng = model.serve(max_slots=8, paged=PagedConfig(block_size=32))
    >>> h = eng.submit(GenerationRequest(prompt, max_new_tokens=32))
    >>> eng.run_until_complete()
    >>> h.result().tokens      # == model.generate(prompt, ...)

    ``max_len`` (default ``n_positions``) bounds prompt +
    ``max_new_tokens``; ``dtype`` casts the weights (``torch.bfloat16``);
    ``top_k`` / ``top_p`` are engine-wide filters of sampled requests;
    ``scheduler`` is ``"fifo"`` (default), ``"priority"`` or an
    instance; ``clock`` is injectable for tests."""

    def __init__(self, model, max_slots=8, max_len=None, dtype=None,
                 scheduler=None, top_k=0, top_p=None,
                 clock=time.monotonic, slo=None, prefix_cache=None,
                 draft_model=None, spec_k=None, cache_dtype=None,
                 paged=None, tp=None, ep=None, pp=None):
        cfg = model.cfg
        check_decodable(cfg)
        owed = [("the slot arena (paged=None)", paged is None
                 or paged is False),
                ("prefix_cache", prefix_cache not in (None, False)),
                ("speculative decoding (draft_model, spec_k)",
                 draft_model is not None or spec_k is not None),
                ("cache_dtype (int8 KV)", cache_dtype is not None),
                ("tensor/expert/pipeline-parallel serving (tp, ep, pp)",
                 any(x not in (None, False) for x in (tp, ep, pp))),
                ("SLO targets and load shedding (slo)", slo is not None)]
        for what, asked in owed:
            if asked:
                _owed(what)
        if paged is True:
            paged = PagedConfig()
        elif isinstance(paged, dict):
            paged = PagedConfig(**paged)
        if not isinstance(paged, PagedConfig):
            raise ValueError(f"paged must be a PagedConfig, a kwargs dict "
                             f"or True, got {type(paged)}")
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.model = model
        self.cfg = cfg
        self.max_slots = int(max_slots)
        self.max_len = int(max_len or cfg.n_positions)
        if self.max_len > cfg.n_positions:
            raise ValueError(f"max_len ({self.max_len}) exceeds n_positions "
                             f"({cfg.n_positions})")
        if self.max_len % paged.block_size != 0:
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
        self.paged_arena = PagedKVArena(
            paged, cfg.n_layer, cfg.n_kv_head, cfg.n_embd // cfg.n_head,
            self._params["wte"].dtype, self.max_len,
            self._params["wte"].device,
            engine_label=self.stats.engine_label, reg=self.stats.registry)
        self.stats.paged_source = self.paged_arena.snapshot
        S = self.max_slots
        self._slots = [None] * S
        self._toks = np.zeros(S, np.int64)
        self._pos = np.zeros(S, np.int64)
        self._temps = np.zeros(S, np.float32)
        self._seeds = np.zeros(S, np.int64)
        self._handles = {}
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
        """Raise for a request this engine could never serve: beyond its
        position space, more blocks than the pool holds, or a feature not
        ported yet."""
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
        worst = (need - 1) // arena.block_size + 1
        if worst > arena.num_blocks:
            raise ValueError(
                f"request needs up to {worst} KV blocks but the paged pool "
                f"holds {arena.num_blocks}; raise PagedConfig.num_blocks or "
                f"lower max_new_tokens")

    @property
    def pending(self) -> bool:
        """True while any request is queued or holds a slot."""
        return (self.scheduler.queue_depth > 0
                or any(s is not None for s in self._slots))

    @property
    def live_slots(self) -> int:
        return sum(s is not None for s in self._slots)

    def check_block_accounting(self):
        """Leak check: every used pool block belongs to a live slot's
        table.  Raises AssertionError naming the counts; returns the
        used-block count."""
        arena = self.paged_arena
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
        self.stats.unregister()
        self.paged_arena.unregister()
        self._params = None
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
        """Reject every live (``started=True``) and queued
        (``started=False``) request typed and return the error for
        ``step()`` to raise: ``cause`` itself when it is an
        ``EngineFailedError`` (such as ``PoolExhaustedError``)."""
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
        sel = lanes + [-1] * (self._paged_width(n) - n)
        live = np.asarray([i >= 0 for i in sel])
        pick = np.where(live, sel, 0)
        arena = self.paged_arena
        with _trace.span("serve/decode_step", cat="serve",
                         step=self.step_count, live=n):
            logits = self._x.paged_decode_step(
                self._params, arena.pool_k, arena.pool_v,
                self._block_tables(sel), self._toks[pick],
                self._pos[pick], live, arena.block_size,
                kernel=arena.config.kernel)
            nxt = _sample(logits[:n], self._temps[lanes], self._seeds[lanes],
                          self._pos[lanes] + 1, self._top_k, self._top_p)
        self.stats.on_decode_step(n)
        now = self._clock()
        for i, tok in zip(lanes, nxt):
            self._toks[i] = tok
            self._pos[i] += 1
            self._emit(i, self._slots[i], int(tok), now)

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
        arena.free([b for b in slot.blocks if b != arena.trash])
        slot.blocks = []

    def _block_tables(self, idxs):
        """(len(idxs), max_len // B) int32 block tables, trash-padded;
        entries of ``idxs`` < 0 are dead lanes (all trash)."""
        arena = self.paged_arena
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
        holding the position it writes.  Raises
        :class:`PoolExhaustedError` when the pool has no block for it
        (preemption and swap are not ported)."""
        B = self.paged_arena.block_size
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            short = int(self._pos[i]) // B + 1 - len(slot.blocks)
            if short <= 0:
                continue
            got = self.paged_arena.alloc(short)
            if got is None:
                raise PoolExhaustedError(
                    f"{slot.handle.request.request_id} at position "
                    f"{int(self._pos[i])} needs {short} more KV block(s) "
                    f"and the pool ({self.paged_arena.num_blocks} blocks) "
                    f"has {self.paged_arena.blocks_free} free; preemption "
                    f"and swap are not ported yet (ROADMAP.md): raise "
                    f"PagedConfig.num_blocks or lower max_slots",
                    request_id=slot.handle.request.request_id,
                    started=True, engine_step=self.step_count)
            slot.blocks.extend(got)

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
        """Admit queued requests into free slots while their first blocks
        fit (a request whose blocks do not fit waits at the head of the
        queue), prefill the admitted ones (one batched prefill per prompt
        length) and emit their first tokens."""
        if self.scheduler.queue_depth == 0:
            return
        free = self._free_slots()
        admit, expired = self.scheduler.schedule(len(free), now)
        self._reject_expired(expired, now)
        B = self.paged_arena.block_size
        placed = []
        for k, req in enumerate(admit):
            blocks = self.paged_arena.alloc(len(req.prompt_ids) // B + 1)
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
                            kc[:, r:r + 1], vc[:, r:r + 1])

    def _admit(self, idx, req, now, blocks, logit, kc_row, vc_row):
        """Write one prefilled request's K/V into its blocks, sample its
        first token (position ``plen``) and emit it."""
        handle = self._handles[req.request_id]
        plen = len(req.prompt_ids)
        self.paged_arena.scatter_row(kc_row, vc_row, dict(enumerate(blocks)))
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
