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
* **prefix cache and sessions** (``prefix_cache=``, either arena,
  ``serve/prefix.py``): an admission looks up the longest cached block
  prefix of its prompt, pins it and prefills only the rest, in
  block-width ``prefill_chunk`` passes; every admission of a cached
  engine, cold ones too, prefills so from a zero row, so warm and cold
  streams agree by construction.  On the paged arena a warm slot's block
  table points at the tree's blocks (``arena.share``; its first
  ``n_shared`` lanes), the decode step's ``paged_attn`` reads them in
  place, and a retiring slot's full prompt blocks are adopted by the tree
  without a copy (``_paged_retire``); the slot arena copies the matched
  blocks into its row and donates from it (``_prefix_retire``).
  ``pin_session=True`` pins the whole finished sequence
  (``GenerationResult.session``, a ``SessionHandle``), its generated
  region recomputed through ``prefill_chunk`` first; unreferenced cached
  blocks count as free for admission and are evicted LRU;
* **speculative decoding** (``draft_model=``, ``spec_k=``, either
  arena): each step runs ``spec_k`` decode steps of the draft on its own
  slot-shaped arena and one verify chunk of the target (the paged
  arena: ``chunk_step_paged``, one ``paged_attn`` launch a layer at Q =
  ``spec_k``), then ``spec_verify``; a step emits up to ``spec_k``
  tokens a slot, and retiring fires per token, so a budget or a stop
  token retires a slot mid-chunk.  Greedy requests accept by argmax
  match (the non-speculative streams), sampled ones by rejection
  sampling (distributed as direct target sampling).  Speculative steps
  run at full width (the draft arena is slot-indexed) as one captured
  graph;
* **chunked-prefill token budget**
  (``PagedConfig(prefill_token_budget=)``): at most that many prompt
  tokens prefill a step, every admission in block-width
  ``prefill_chunk`` passes from a fresh row (the prefix cache's
  canonical form), a long prompt across several steps while the live
  slots decode every step; its slot is reserved but not live until the
  last chunk lands (``_Prefilling``); ``PagedConfig(admit_per_step=)``
  caps admissions a scheduling pass;
* **fork** (paged only, ``serve/fork.py``): ``GenerationRequest(n=N)``
  admits its prompt once, emits the first token, and forks N - 1 branches
  off the slot in the same scheduling pass: each branch's block table is
  a copy of the parent's, every block of it gaining a reference in the
  arena (no KV byte moves), so the decode step's ``paged_attn`` reads
  the shared blocks through several slots' tables.  Before a step writes
  into a block a sibling still references, the writing slot copies it
  (copy-on-write, ``serve.fork.cow_copies``).  ``fork(request_id)``
  splits a live request mid-stream and ``prune(request_id)`` cuts a
  branch, freeing its private blocks.  Each branch sums the
  log-probability of its tokens under the raw distribution (the step
  returns it while a fork branch is live), its ``score``;
* **structured decoding** (paged only, ``serve/structured.py``): before
  each step the host asks every structured slot's automaton for its
  state's vocabulary mask; the step takes the masks of its lanes as a
  ``(width, vocab)`` bool input (only when a structured slot is live),
  the sampler drops masked tokens to ``NEG_INF``, and the emitted token
  advances the automaton, whose completion retires the request with
  ``"stop"``.  A state whose mask admits no token rejects that request
  alone (``structured_dead_end``);
* **sliding-window models** (``GPT2Config(attn_window=W)``, paged only):
  a slot drops the blocks that left its window back to the free list
  (its table keeps the trash block there), a long prompt admits with its
  in-window blocks only, and the step passes the window to
  ``paged_attn``, so a long chat holds and reads O(W) blocks;
* **exactness**: an admission prefills its prompt at its own length and
  samples the first token as ``generate`` does; each decode step runs
  the dense ``decode_step`` (slot arena: the per-row math of offline
  ``generate``), ``decode_step_paged`` (the ``paged_attn`` kernel,
  ``kernel="block"``) or the dense gather oracle (``kernel="gather"``),
  and samples with the request's threefry key chain (``ops/prng.py``:
  ``split(PRNGKey(seed), 1)[0]`` at admission, one ``split`` a decode
  step, ``split(key, 3)`` a speculative one, ``fold_in`` a fork; the
  JAX engine's), so float32 streams equal offline ``generate`` and the
  JAX engine's (at the same ``cache_dtype``; windowed
  models: its rolling cache) away from exact argmax ties.

The device work goes through :class:`_LocalExec`, the seam that the JAX
engine's sharded executors plug into.  The JAX engine's per-row
functions, vmapped over slots there (``_decode_row_paged``,
``_decode_row``, ``_select_sample``, ``_spec_row``), are slot
dimensions here: :func:`_pool_decode_step` and ``serve/paged.py``'s
``_paged_decode_kernel``, ``_paged_decode_step`` and ``spec_step``
return every lane's logits or tokens, and ``gpt2_decode._sample`` takes
each row's temperature, so greedy and sampled rows share one call.

**Captured decode steps** (``capture=True``, the default; the JAX engine
jits its pool step): the slot arena's step has one width, ``max_slots``;
a paged step's width is the halving bucket of ``max_slots`` covering the
live slots (``_paged_width``); a speculative step's is ``max_slots``.
A paged step that takes vocabulary masks or returns the chosen tokens'
log-probabilities is keyed (width, masked, with_lp), as those flags are
in the JAX engine's jit key, a plain one by its width alone, so an
engine captures at most four steps a width, whatever the grammars and
fork patterns it serves, and a plain engine the steps it always did.
Each width's step (the forward with its ``paged_attn`` launches, the
in-place cache writes and the sampling or verify) reads its inputs from
persistent device buffers (``paged.DecodeInputs``), which the engine
fills with one staged host-to-device copy a step.  A width's first step
runs eagerly, as a real step, and the step is then captured as a CUDA
graph (``graphs.py``; all of an engine's graphs share one memory pool);
every later step at that width is one replay, after which the host reads
the step's tokens once.  On the CPU the same widths, buffers and
first-step rule run the step function itself.  ``capture=False`` runs
every step eagerly, like ``jax.disable_jit``; the gather oracle
(``kernel="gather"``) and the admission prefill always run eagerly.
``serve.jitpin.jit_cache_size()`` counts the prepared steps of the open
engines.

**Observability** (``observe/``), each one module-flag read a site when
off: the request ledger's hooks (submit, queue, admission, prefix hit,
prefill chunk, first token, each step's tokens, preemption, resume,
retire, typed rejection; a fork branch's submit, admission and first
token at its branch point), the step profiler's fences (``begin`` /
``end`` around ``step()``, host segments inside, and the device window
of every dispatch: ``_ProfExec`` wraps ``_LocalExec``, and the decode
step, a graph replay once captured, is timed as one dispatch), the
watchdog's heartbeat (``serve.e<label>``: armed at the top of a step,
the decode step's time fed after it, disarmed when the engine drains or
fails), and ``slo=observe.SLO(...)``'s violation counters
(``serve/stats.py``).  The hooks are host code around the dispatches, so
none of them enters a captured step.  ``_faults.check(
"serve.decode_step")`` at the top of each decode step is the chaos hook
``EngineSupervisor`` (``serve/supervisor.py``) recovers from.

**Sharded engines** (``tp=``, ``ep=``, ``pp=``; ``serve/tp.py``,
``serve/ep.py``, ``serve/pp.py``): every device operation of the engine
is a method of its device layer (:class:`_Device`), which takes host
values only; on a sharded engine rank 0 runs the whole engine and sends
each call to the other ranks, whose mirror engines run it on their
shards (``serve/shard.py``).  The JAX engine's refusal matrix of the
three knobs runs before any metric registers.  ``TPConfig(ring_prefill=
True)`` prefills cold admissions of at least ``ring_min_tokens`` tokens
by ring attention over the tp ranks.  Not ported yet: the prefix
cache's fleet index (``ROADMAP.md``).
"""

from __future__ import annotations

import itertools
import math
import time
from dataclasses import replace

import numpy as np
import torch

from .. import graphs
from ..models.gpt2_decode import (_check_sampling, _leaves, _logits,
                                  _norm_window, _quant_flag, _sample,
                                  check_decodable, chosen_logprob,
                                  decode_step, kv_zeros, prefill,
                                  prefill_chunk)
from ..ops import prng
from ..observe import monitor as _monitor
from ..observe import requests as _reqs
from ..observe import stepprof as _stepprof
from ..observe import trace as _trace
from ..resilience import faults as _faults
from . import jitpin
from .fork import BranchHandle, ForkHandle
from .paged import (DecodeInputs, PagedConfig, PagedKVArena, _embed,
                    _paged_decode_kernel, _paged_decode_step, spec_step)
from .prefix import PrefixCache, PrefixCacheConfig, SessionHandle
from .request import (DeadlineExceededError, EngineFailedError,
                      GenerationRequest, GenerationResult, LoadShedError,
                      RequestHandle)
from .scheduler import FIFOScheduler, PriorityScheduler
from .stats import EngineStats

__all__ = ["InferenceEngine"]


def _prefill_batch(params, ids, n_head, eps, quant=False, window=None):
    """Admission prefill of R prompts of one length: ids (R, P) ->
    (last-position logits (R, V) float32, k rows, v rows (L, R, H_kv, P,
    D), quantized (values, scales) pairs with ``quant``; ``window``:
    banded, the linear layout).  At R = 1 it is the JAX engine's
    ``_prefill_one``."""
    hidden, kc, vc = prefill(params, ids, n_head, eps, quant_cache=quant,
                             window=window, rolling=False)
    return _logits(hidden[:, -1], params).float(), kc, vc


def _chunk_row(params, ids, kc_row, vc_row, off, chunk, n_head, eps,
               window=None):
    """Offset prefill of one block-width window of a cache row: embed
    tokens [off, off + chunk) of the padded (W,) ``ids`` at their
    positions and advance them through ``prefill_chunk`` against rows
    (L, 1, H_kv, W, D) (int8 pairs) that hold canonical K/V below
    ``off``, written in place.  Returns the (1, chunk, E) final-LN hidden
    (the JAX engine's ``_chunk_row``)."""
    pos = torch.arange(off, off + chunk, device=ids.device)
    x = (params["wte"][ids[off:off + chunk]] + params["wpe"][pos])[None]
    hidden, _, _ = prefill_chunk(params, x, kc_row, vc_row, off, n_head,
                                 eps, window)
    return hidden


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
                                        **self._e._statics,
                                        window=self._e._window)
        return _paged_decode_step(params, pool_k, pool_v, inp, n_rb, block,
                                  **self._e._statics)

    def spec_step(self, inp, n_rb=None):
        """(S, spec_k + 1) tokens and accept counts of one speculative
        step over the lanes ``inp`` (``paged.spec_step``) against the
        engine's pools or slot arena and its draft arena; ``n_rb``: the
        gather oracle's blocks a lane."""
        e = self._e
        arena = e.paged_arena
        kc, vc = (e._kc, e._vc) if arena is None else (arena.pool_k,
                                                       arena.pool_v)
        st = e._statics
        return spec_step(e._params, e._d_params, kc, vc, e._dkc, e._dvc,
                         inp, e.spec_k, (st["n_head"], st["eps"]),
                         e._d_statics, e._top_k, e._top_p,
                         block=None if arena is None else arena.block_size,
                         window=e._window, n_rb=n_rb)

    def prefill_batch(self, params, ids):
        return _prefill_batch(params, ids, **self._e._statics,
                              quant=self._e._quant, window=self._e._window)

    def draft_prefill(self, ids):
        """The draft's K/V rows (L_d, R, H_d, P, D_d) of prompts ids (R,
        P): its admission, cold whatever the target's was."""
        e = self._e
        n_head, eps = e._d_statics
        _, kc, vc = prefill(e._d_params, ids, n_head, eps,
                            quant_cache=e._quant)
        return kc, vc

    def chunk_row(self, params, ids, kc_row, vc_row, off, chunk):
        """(1, chunk, E) hidden of one ``_chunk_row`` window; the rows
        take its K/V in place."""
        return _chunk_row(params, ids, kc_row, vc_row, off, chunk,
                          **self._e._statics, window=self._e._window)

    def logits(self, params, hidden):
        """float32 logits of final-LN ``hidden`` rows (R, E) -> (R, V)."""
        return _logits(hidden, params).float()

    def finish_step(self, logits, sample, w, with_lp):
        """A decode step's tokens (and log-probabilities) from its
        logits: ``sample(logits)``."""
        return sample(logits)

    # the host images of swapped KV: a sharded executor gathers the
    # shards into the whole row and cuts a rank's slice back out
    def gather_kv(self, row):
        return row

    def slice_kv(self, row):
        return row

    def kv_meta(self, pool):
        """The pool leaf an image is validated against (its global
        geometry)."""
        return pool


class _Device:
    """Every device operation of the engine, each a method that takes
    host values only (numpy arrays, block ids, slot indices, offsets)
    and works on the engine's device state: its placed weights, arenas,
    pools, decode inputs, captured steps and the rows of admissions in
    flight (kept here by slot).  The single-device engine calls it
    directly; a sharded engine's controller (rank 0) sends each call to
    the worker ranks first (``serve/shard.py``), whose mirror engines
    run the same method on their own shards."""

    def __init__(self, eng):
        self._e = eng
        self._pf = {}  # reserved slot -> [ids, kc_row, vc_row, hidden]

    def _dev(self):
        return self._e._params["wte"].device

    def _put(self, kc, vc, r, dest):
        """Row ``r`` of prefilled rows into a slot (``("slot", idx)``) or
        pool blocks (``("blocks", {lane: block})``)."""
        e = self._e
        kind, where = dest
        if kind == "slot":
            e._x.write_slot(e._kc, e._vc, _row(kc, r), _row(vc, r), where)
        else:
            e.paged_arena.scatter_row(_row(kc, r), _row(vc, r), where)

    def prefill_rows(self, ids, dests):
        """Admission prefill of prompts ``ids`` (R, P), row r's K/V put at
        ``dests[r]``; returns the (R, V) float32 last-position logits."""
        e = self._e
        t = torch.as_tensor(np.asarray(ids, np.int64), device=self._dev())
        logits, kc, vc = e._x.prefill_batch(e._params, t)
        for r, dest in enumerate(dests):
            self._put(kc, vc, r, dest)
        return logits

    def ring_prefill(self, ids, plen, lanes):
        """A cold admission prefilled sequence-sharded by ring attention
        (``TPExecutor.ring_prefill``): ``ids`` (W,) right-padded; its
        K/V into ``lanes``; returns the (1, V) logits at ``plen - 1``."""
        e = self._e
        t = torch.as_tensor(np.asarray(ids, np.int64)[None],
                            device=self._dev())
        logit, kc, vc = e._x.ring_prefill(t, plen)
        e.paged_arena.scatter_row(kc, vc, lanes)
        return logit

    def draft_admit(self, idx, ids):
        """The draft's rows of prompt ``ids`` (P,) into its slot ``idx``."""
        e = self._e
        t = torch.as_tensor(np.asarray(ids, np.int64)[None],
                            device=self._dev())
        e._x.write_slot(e._dkc, e._dvc, *e._x.draft_prefill(t), idx)

    def pf_begin(self, idx, ids, blocks, width):
        """A chunked admission's private row in slot ``idx``: ``width``
        lanes holding the cached ``blocks``' K/V at its first lanes
        (copied out of the arena or the prefix cache's pool), zeros past;
        ``ids`` (width,) the padded prompt."""
        e = self._e
        dev = self._dev()
        cache = e.prefix_cache
        if cache is not None:
            kc_row, vc_row = cache.copy_into_row(blocks, width)
        else:
            L, H_kv, D = e._kv_geom
            shape = (L, 1, H_kv, width, D)
            cdt = e._params["wte"].dtype
            kc_row = kv_zeros(shape, cdt, e._quant, dev)
            vc_row = kv_zeros(shape, cdt, e._quant, dev)
        self._pf[idx] = [torch.as_tensor(np.asarray(ids, np.int64),
                                         device=dev), kc_row, vc_row, None]

    def pf_chunk(self, idx, off, chunk):
        """One block-width pass of slot ``idx``'s admission at ``off``."""
        e = self._e
        pf = self._pf[idx]
        pf[3] = e._x.chunk_row(e._params, pf[0], pf[1], pf[2], off, chunk)

    def pf_finish(self, idx, lane, dest):
        """The admission's last chunk landed: its row to ``dest``; returns
        the (1, V) logits of hidden lane ``lane`` of the last chunk."""
        e = self._e
        ids, kc_row, vc_row, hidden = self._pf.pop(idx)
        logit = e._x.logits(e._params, hidden[:, lane])
        self._put(kc_row, vc_row, 0, dest)
        return logit

    def _canonicalize(self, kc_row, vc_row, tokens, j_lo, j_hi, block):
        """Recompute blocks [j_lo, j_hi) of rows holding ``tokens``
        through ``prefill_chunk``, in place: decode-step K/V is not the
        canonical form the tree stores."""
        if j_hi <= j_lo:
            return
        e = self._e
        width = _leaves(kc_row)[0].shape[3]
        ids = np.zeros(width, np.int64)
        n = min(width, len(tokens))
        ids[:n] = tokens[:n]
        ids = torch.as_tensor(ids, device=self._dev())
        for j in range(j_lo, j_hi):
            e._x.chunk_row(e._params, ids, kc_row, vc_row, j * block, block)

    def canon_blocks(self, blocks, tokens, j_lo, j_hi):
        """Paged donation: recompute lanes [j_lo, j_hi) of the row in
        ``blocks`` and write them back to their blocks."""
        arena = self._e.paged_arena
        kc_row, vc_row = arena.gather_row(blocks)
        self._canonicalize(kc_row, vc_row, tokens, j_lo, j_hi,
                           arena.block_size)
        arena.scatter_row(kc_row, vc_row,
                          {j: blocks[j] for j in range(j_lo, j_hi)})

    def donate_slot(self, idx, tokens, j_lo, j_hi, placed):
        """Slot-arena donation: slot ``idx``'s row, lanes [j_lo, j_hi)
        recomputed, copied into the prefix cache's pool at ``placed``
        ((lane, block) pairs)."""
        e = self._e
        cache = e.prefix_cache
        kc_row, vc_row = e._x.read_slot(e._kc, e._vc, idx)
        self._canonicalize(kc_row, vc_row, tokens, j_lo, j_hi,
                           cache.block_size)
        cache.write_blocks(kc_row, vc_row, placed)

    def copy_block(self, src, dst):
        self._e.paged_arena.copy_block(src, dst)

    def swap_out(self, blocks, n_data):
        x = self._e._x
        return self._e.paged_arena.swap_out(blocks, n_data,
                                            gather=x.gather_kv)

    def swap_in(self, image, blocks):
        x = self._e._x
        self._e.paged_arena.swap_in(image, blocks, cut=x.slice_kv,
                                    meta=x.kv_meta)

    def draft_read(self, idx):
        """Host copies of the draft's rows of slot ``idx``."""
        e = self._e
        rows = e._x.read_slot(e._dkc, e._dvc, idx)
        return tuple(tuple(t.cpu() for t in _leaves(r)) for r in rows)

    def draft_write(self, idx, rows):
        e = self._e
        dev = self._dev()
        rows = [tuple(t.to(dev) for t in r) for r in rows]
        e._x.write_slot(e._dkc, e._dvc,
                        *(r if e._quant else r[0] for r in rows), idx)

    def decode(self, key, staged, masks, n_rb):
        """One decode step of ``key``: the staged host inputs (the
        ``DecodeInputs`` layout) and vocabulary masks to the device,
        then the step (a replay once captured; the gather oracle's, with
        ``n_rb`` blocks a lane, always eager).  Returns its tokens (and
        log-probabilities)."""
        e = self._e
        inputs = e._inputs
        if staged is not inputs._h:
            inputs._h[:] = staged
        if masks is not None:
            inputs.stage_masks(masks)
        inputs.load()
        if n_rb is not None:
            return e._step_fn(key, n_rb)()
        return e._captured(key)


def _timed(name):
    def call(self, *a, **kw):
        fn = getattr(self._inner, name)
        if not _stepprof._active:
            return fn(*a, **kw)
        return _stepprof.timed_dispatch(fn, a, kw)

    call.__name__ = name
    return call


class _ProfExec:
    """The step profiler's hook at the executor seam: each dispatch of
    the wrapped executor is timed (host dispatch, then the device
    window) while ``stepprof`` is on, and passes straight through (one
    flag read) while it is off."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        # the untimed surface (logits, sampling, swap gathers, placement)
        return getattr(self._inner, name)

    pool_decode_step = _timed("pool_decode_step")
    paged_decode_step = _timed("paged_decode_step")
    spec_step = _timed("spec_step")
    prefill_batch = _timed("prefill_batch")
    draft_prefill = _timed("draft_prefill")
    chunk_row = _timed("chunk_row")
    write_slot = _timed("write_slot")
    read_slot = _timed("read_slot")


class _Slot:
    """Host bookkeeping of one live request; ``blocks`` is its block
    table (pool block ids), whose first ``n_shared`` are the prefix
    cache's (shared, never written by this slot); ``prefix_nodes`` the
    cached path it holds a reference to while live.

    Fork fields: ``group`` ties the branches of one fork family (None for
    a plain request; while a live slot has one, the step returns the
    log-probabilities that ``score`` sums), ``branch`` is the slot's
    index in it, and ``cow`` marks a slot whose blocks a sibling may
    still reference (the growth pass copies such a block before the step
    writes into it).  ``automaton`` and ``astate``: a structured
    request's grammar and its state."""

    __slots__ = ("handle", "emitted", "remaining", "first_token_time",
                 "admit_time", "admitted_step", "blocks", "n_shared",
                 "prefix_nodes", "group", "branch", "score", "cow",
                 "automaton", "astate")

    def __init__(self, handle, max_new, now, step, blocks, nodes=()):
        self.handle = handle
        self.emitted = []
        self.remaining = max_new
        self.first_token_time = None
        self.admit_time = now
        self.admitted_step = step
        self.blocks = blocks
        self.prefix_nodes = list(nodes)
        self.n_shared = len(self.prefix_nodes)
        self.group = None
        self.branch = 0
        self.score = 0.0
        self.cow = False
        self.automaton = None
        self.astate = None


class _Swapped:
    """A preempted request's host-side state: the byte copy of its KV
    lanes and every scrap of slot bookkeeping, so a resume continues the
    exact token stream the uninterrupted run would have produced (its
    sampling key rides the swap).  A swapped request has
    STARTED (its admission token streamed): an engine failure rejects it
    with ``started=True``."""

    __slots__ = ("handle", "request", "emitted", "remaining",
                 "first_token_time", "admit_time", "admitted_step", "pos",
                 "tok", "temp", "key", "image", "seq", "t_preempt",
                 "j_lo", "draft", "group", "branch", "score", "automaton",
                 "astate")

    @property
    def priority(self):
        return self.request.priority


class _Prefilling:
    """An admission in flight through block-width chunk passes (the
    chunked-prefill budget's, and every admission of an engine with a
    prefix cache): its slot is reserved and its blocks allocated, its
    K/V lives in a private row (``kc_row``/``vc_row``) that ``off``
    advances across steps; when the last chunk lands the first token is
    sampled from ``hidden``, the row goes into the blocks (or the slot)
    and the slot goes live.  Nothing has streamed, so an engine failure
    rejects it with ``started=False`` and frees its blocks."""

    __slots__ = ("handle", "request", "off", "last_off", "blocks", "nodes",
                 "t_admit", "admitted_step", "seq")


class _PrefixJob:
    """One shippable-prefix build (:meth:`InferenceEngine.
    start_prefix_build`): the prompt, its ``n_goal`` full blocks, the
    acquired cached ``nodes``, the chunk passes' row and next offset, and
    the engine that owns them."""

    __slots__ = ("tokens", "plen", "n_goal", "engine", "nodes", "hit",
                 "off", "last_off", "ids", "kc_row", "vc_row")


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
    ``prefix_cache`` (default None: off) is a ``PrefixCacheConfig``, a
    dict of its arguments or True (module docstring);
    ``scheduler`` is ``"fifo"`` (default), ``"priority"`` or an
    instance; ``clock`` is injectable for tests; ``capture`` (default
    True) replays each decode width's step as a CUDA graph on the card
    (module docstring), ``False`` runs every step eagerly; ``slo`` is
    an ``observe.SLO`` whose violations ``stats`` counts; ``tp`` /
    ``ep`` / ``pp`` (a ``TPConfig`` / ``EPConfig`` / ``PPConfig``, a
    kwargs dict or a width) shard the engine over the process group's
    ranks, built on rank 0 while the others run
    ``serve.shard.worker_loop()`` (module docstring)."""

    def __init__(self, model, max_slots=8, max_len=None, dtype=None,
                 scheduler=None, top_k=0, top_p=None,
                 clock=time.monotonic, slo=None, prefix_cache=None,
                 draft_model=None, spec_k=None, cache_dtype=None,
                 paged=None, tp=None, ep=None, pp=None, capture=True):
        cfg = model.cfg
        check_decodable(cfg)
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
        self._window = _norm_window(cfg)
        if self._window is not None:
            # the JAX engine's windowed composition limits, checked before
            # any state exists
            if paged is None:
                raise NotImplementedError(
                    f"serve engine supports sliding-window models only in "
                    f"paged mode (attn_window={cfg.attn_window}): pass "
                    f"paged=PagedConfig(...); the slot arena's "
                    f"position-indexed rows cannot roll, and offline "
                    f"GPT2LMHead.generate serves without an engine")
            if paged.kernel != "block":
                raise ValueError(
                    f"sliding-window serving requires PagedConfig("
                    f"kernel='block'), got {paged.kernel!r}: the gather "
                    f"oracle materializes the full row and would attend "
                    f"blocks the windowed slot already dropped")
            if prefix_cache is not None and prefix_cache is not False:
                raise NotImplementedError(
                    "prefix_cache on a sliding-window model: windowed slots "
                    "drop out-of-window blocks, so a retiring request's "
                    "prompt is no longer a block prefix the radix tree "
                    "could adopt; serve windowed models without a prefix "
                    "cache")
        if spec_k is not None and draft_model is None:
            raise ValueError(
                f"spec_k={spec_k} without draft_model: speculative decoding "
                f"needs a draft to propose; pass draft_model= (or drop "
                f"spec_k)")
        self.draft = draft_model
        self.spec_k = 4 if spec_k is None else int(spec_k)
        if draft_model is not None:
            dcfg = draft_model.cfg
            if self.spec_k < 2:
                raise ValueError(
                    f"spec_k must be >= 2, got {self.spec_k} (one proposal "
                    f"+ the bonus token is the smallest chunk)")
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft/target vocab mismatch: draft {dcfg.vocab_size} "
                    f"vs target {cfg.vocab_size}: the draft must propose "
                    f"from the target's token space")
            if dcfg.n_positions < (max_len or cfg.n_positions):
                raise ValueError(
                    f"draft n_positions ({dcfg.n_positions}) < engine "
                    f"max_len ({max_len or cfg.n_positions}): the draft "
                    f"cache must cover every position the target can reach")
            if _norm_window(dcfg) is not None:
                raise NotImplementedError(
                    f"speculative serve does not support sliding-window "
                    f"drafts (attn_window={dcfg.attn_window})")
            if paged is not None and self.spec_k > paged.block_size:
                raise ValueError(
                    f"spec_k ({self.spec_k}) > paged block_size "
                    f"({paged.block_size}): a verify chunk would span more "
                    f"than two pool blocks; raise block_size or lower "
                    f"spec_k")
        self._spec_pad = 0 if draft_model is None else self.spec_k - 1
        # tensor / expert / pipeline parallelism: the whole refusal matrix
        # runs here, before any metric registers (serve/shard.py)
        from . import shard as _shard
        sharded = _shard.check_sharded(
            cfg, model, tp=tp, ep=ep, pp=pp, paged=paged,
            prefix_cache=prefix_cache, draft_model=draft_model,
            window=self._window, quant=self._quant, capture=capture)
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
        self._budget = None if paged is None else paged.prefill_token_budget
        self.stats = EngineStats(self.max_slots, clock,
                                 spec=draft_model is not None,
                                 budget=self._budget is not None,
                                 fork=paged is not None, slo=slo)
        # a watchdog source per engine: with one shared source a wedged
        # engine would hide behind a sibling that keeps beating
        self._hb_source = "serve.e" + self.stats.engine_label
        self._fork_seq = itertools.count(1)

        if sharded is not None and not _shard.is_mirror(model):
            # the controller: the worker ranks build this engine's mirror
            # from what it ships them now
            _shard.announce(sharded, model, draft_model, dtype,
                            dict(max_slots=max_slots, max_len=max_len,
                                 top_k=top_k, top_p=top_p,
                                 prefix_cache=prefix_cache, spec_k=spec_k,
                                 cache_dtype=cache_dtype, paged=paged,
                                 tp=tp, ep=ep, pp=pp, capture=capture))
        model.eval()
        self._params = _shard.decode_params(model, dtype)
        self._statics = dict(n_head=cfg.n_head,
                             eps=float(cfg.layer_norm_eps))
        L, H_kv, D = cfg.n_layer, cfg.n_kv_head, cfg.n_embd // cfg.n_head
        #: the sharded executor (serve/tp.py, ep.py, pp.py) or None
        self._shard = None
        self._ring_min = None
        if sharded is not None:
            self._shard = _shard.make_executor(sharded, self)
            self._params = self._shard.place_params(self._params)
            L, H_kv = self._shard.kv_geometry(L, H_kv)
            self._ring_min = self._shard.ring_min_tokens
        self._kv_geom = (L, H_kv, D)
        self._x = _ProfExec(self._shard or _LocalExec(self))
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
        # the draft's own slot-shaped arena, advanced in lockstep with the
        # target by the speculative step
        self._d_params = self._d_statics = self._dkc = self._dvc = None
        if draft_model is not None:
            draft_model.eval()
            dcfg = draft_model.cfg
            self._d_params = _shard.decode_params(draft_model, dtype)
            self._d_statics = (dcfg.n_head, float(dcfg.layer_norm_eps))
            shape = (dcfg.n_layer, self.max_slots, dcfg.n_kv_head,
                     self.max_len, dcfg.n_embd // dcfg.n_head)
            ddt = self._d_params["wte"].dtype
            self._dkc = kv_zeros(shape, ddt, self._quant, dev)
            self._dvc = kv_zeros(shape, ddt, self._quant, dev)
        self.capture = bool(capture)
        self._inputs = DecodeInputs(
            self.max_slots, row_blocks, dev,
            n_keys=1 if draft_model is None else self.spec_k + 2)
        self._steps = {}  # decode width -> graphs.Step
        self._graph_pool = None
        jitpin.track(self)
        S = self.max_slots
        self._slots = [None] * S
        self._toks = np.zeros(S, np.int64)
        self._pos = np.zeros(S, np.int64)
        self._temps = np.zeros(S, np.float32)
        # each slot's threefry key (the JAX engine's ``_keys``), advanced
        # on the host: a step stages the keys it samples with
        self._keys = np.zeros((S, 2), np.uint32)
        self._handles = {}
        self._swapped = []
        self._swap_seq = itertools.count()
        self._prefilling = {}  # reserved slot -> _Prefilling
        self._prefill_seq = itertools.count()
        self._closed = False
        self._failed = False
        self.step_count = 0
        self.prefix_cache = self._make_prefix_cache(prefix_cache, L, H_kv,
                                                    D, cdt, dev)
        dev_layer = _Device(self)
        self._dev = dev_layer
        if self._shard is not None:
            self._shard.account_kv()
            self.stats.shard_sources[self._shard.kind] = self._shard.snapshot
            if not _shard.is_mirror(model):
                self._dev = _shard.Mirror(dev_layer, self._shard)

    def _make_prefix_cache(self, config, L, H_kv, D, dtype, dev):
        """The engine's radix prefix cache for ``config`` (None, False,
        True, a kwargs dict, possibly empty, or a ``PrefixCacheConfig``),
        or None.  On the paged arena the tree shares the arena's blocks,
        so its block size must be the arena's, and the arena evicts
        unreferenced cached blocks before an allocation fails; on the slot
        arena ``max_len`` must be a multiple of the block size."""
        if config is None or config is False:
            return None
        if config is True:
            config = PrefixCacheConfig()
        elif isinstance(config, dict):
            config = PrefixCacheConfig(**config)
        if not isinstance(config, PrefixCacheConfig):
            raise ValueError(f"prefix_cache must be a PrefixCacheConfig, a "
                             f"kwargs dict, or True, got {type(config)}")
        arena = self.paged_arena
        if arena is not None and config.block_size != arena.block_size:
            raise ValueError(
                f"prefix_cache.block_size ({config.block_size}) != paged "
                f"block_size ({arena.block_size}): a paged engine keeps one "
                f"block pool, so the cache shares its granularity (its "
                f"num_blocks is ignored: capacity is the arena's)")
        if arena is None and self.max_len % config.block_size != 0:
            raise ValueError(
                f"max_len ({self.max_len}) must be a multiple of "
                f"prefix_cache.block_size ({config.block_size}) so chunked "
                f"prefill windows never cross the row's edge")
        cache = PrefixCache(config, L, H_kv, D, dtype, dev,
                            engine_label=self.stats.engine_label,
                            reg=self.stats.registry, quant=self._quant,
                            arena=arena)
        if arena is not None:
            arena.evict_cb = cache._evict_one
        self.stats.prefix_source = cache.snapshot
        return cache

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
        t_sub = self._clock()
        if _reqs._active:
            # starts this request's timeline, or continues it with a new
            # hop after a supervisor's requeue
            _reqs._ledger.on_submit(
                request.request_id, engine=self.stats.engine_label,
                t=t_sub, prompt_len=len(request.prompt_ids),
                max_new_tokens=request.max_new_tokens)
        self.stats.on_submit()
        try:
            self.scheduler.enqueue(request)
        except Exception:
            self.stats.on_queue_full()
            _trace.event("serve/request_rejected", cat="serve",
                         request=request.request_id, reason="queue_full")
            if _reqs._active:
                _reqs._ledger.on_reject(
                    request.request_id, t=self._clock(),
                    reason="queue_full", engine=self.stats.engine_label,
                    started=False)
            raise
        handle._submit_time = t_sub
        self._handles[request.request_id] = handle
        if request.n > 1:
            # the scheduler forks n - 1 branches off the slot the moment
            # the prompt admits: hand back the n-branch view
            handle._fork_children = []
            return ForkHandle(self, handle)
        return handle

    def validate_request(self, request):
        """Raise for a request this engine could never serve: prompt +
        ``max_new_tokens`` (+ ``spec_k - 1`` positions of verify headroom
        on a speculative engine) beyond ``max_len``, more blocks than the
        pool holds (a windowed slot holds at most a window's blocks and
        the one it writes), or a fork or structured request the engine
        cannot compose with (:meth:`_validate_fork_structured`)."""
        plen = len(request.prompt_ids)
        need = plen + request.max_new_tokens
        pad = self._spec_pad
        if need + pad > self.max_len:
            raise ValueError(
                f"prompt ({plen}) + max_new_tokens "
                f"({request.max_new_tokens})"
                + (f" + spec_k-1 ({pad})" if pad else "")
                + f" exceeds the engine's max_len ({self.max_len})")
        arena = self.paged_arena
        if arena is not None:
            B = arena.block_size
            worst = (need - 1 + pad) // B + 1
            if self._window is not None:
                worst = min(worst, (self._window - 1 + pad) // B + 2)
            if worst > arena.num_blocks:
                raise ValueError(
                    f"request needs up to {worst} KV blocks but the paged "
                    f"pool holds {arena.num_blocks}; raise "
                    f"PagedConfig.num_blocks or lower max_new_tokens")
        if request.n > 1 or request.structured is not None:
            self._validate_fork_structured(request)

    def _validate_fork_structured(self, request):
        """The JAX engine's composition limits of ``n > 1`` and
        ``structured=``, raised as the same ``ValueError``s: a paged
        engine without a draft; ``n > 1`` also without a window or a
        prefill budget and with a pool that holds the shared prompt
        blocks and every branch's tail; an automaton over the model's
        vocabulary whose initial state admits a token."""
        what = (f"n={request.n}" if request.n > 1
                else "structured decoding")
        if self.paged_arena is None:
            raise ValueError(
                f"{what} needs a paged engine (model.serve(paged="
                f"PagedConfig(...))): forking rides on the arena's "
                f"per-block reference counts and structured masks on its "
                f"paged step")
        if self.draft is not None:
            raise ValueError(
                f"{what} is incompatible with speculative decoding (the "
                f"verify chunk samples several tokens a step; per-token "
                f"masks and branch log-probabilities need the one-token "
                f"step)")
        if request.n > 1:
            if self._window is not None:
                raise ValueError(
                    f"n={request.n} on a sliding-window engine: windowed "
                    f"slots drop out-of-window blocks, which a sibling may "
                    f"still share; fork needs the whole block table")
            if self._budget is not None:
                raise ValueError(
                    f"n={request.n} with a chunked-prefill budget: branches "
                    f"fork off the admission pass, which the budget splits "
                    f"across steps; use a plain paged admission for forked "
                    f"requests")
            B = self.paged_arena.block_size
            plen = len(request.prompt_ids)
            shared = plen // B
            tail = (plen + request.max_new_tokens - 1) // B + 1 - shared
            if shared + request.n * tail > self.paged_arena.num_blocks:
                raise ValueError(
                    f"n={request.n} needs up to {shared} shared + "
                    f"{request.n}x{tail} per-branch KV blocks but the paged "
                    f"pool holds {self.paged_arena.num_blocks}; raise "
                    f"PagedConfig.num_blocks, lower n, or lower "
                    f"max_new_tokens")
        if request.structured is not None:
            a = request.structured
            vocab = int(self.cfg.vocab_size)
            vs = getattr(a, "vocab_size", None)
            if vs is not None and int(vs) != vocab:
                raise ValueError(
                    f"structured automaton covers vocab_size={vs} but the "
                    f"model's vocab is {vocab}: the mask would mis-index the "
                    f"logits")
            m0 = np.asarray(a.mask(a.initial()), bool)
            if m0.shape != (vocab,):
                raise ValueError(
                    f"structured mask shape {m0.shape} != ({vocab},): masks "
                    f"are one bool a vocabulary token")
            if not m0.any():
                raise ValueError(
                    "structured automaton's initial state accepts no token: "
                    "the grammar cannot be satisfied under this vocabulary")

    @property
    def pending(self) -> bool:
        """True while any request is queued, holds a slot, is prefilling
        in chunks, or is swapped out awaiting resume."""
        return (self.scheduler.queue_depth > 0
                or any(s is not None for s in self._slots)
                or bool(self._prefilling) or bool(self._swapped))

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
        """Leak check of the paged arena: ``used == cached +
        live_referenced``, every used pool block owned by the prefix
        cache's tree or held by a live slot's table or an admission still
        prefilling (a block both cached and shared by a slot, or shared
        by fork branches, counts once: ownership is the block id, and the
        reference counts only decide when ``free`` recycles it).  Raises
        AssertionError naming the counts; returns the used-block count."""
        arena = self.paged_arena
        if arena is None:
            return 0
        owned = set()
        if self.prefix_cache is not None:
            owned.update(self.prefix_cache.cached_block_ids())
        n_cached = len(owned)
        owned.update(b for s in self._slots if s is not None
                     for b in s.blocks if b != arena.trash)
        owned.update(b for pf in self._prefilling.values()
                     for b in pf.blocks if b != arena.trash)
        if arena.blocks_used != len(owned):
            raise AssertionError(
                f"paged-arena block leak: {arena.blocks_used} blocks used, "
                f"owners account for {len(owned)} ({n_cached} cached + "
                f"{len(owned) - n_cached} held by live slots only)")
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
        if self._shard is not None:
            self._shard.close(self._dev)
        self._steps = {}
        self._graph_pool = None
        self.stats.unregister()
        _monitor.forget(self._hb_source)
        _stepprof.forget_engine(self.stats.engine_label)
        if self.prefix_cache is not None:
            self.prefix_cache.unregister()
        if self.paged_arena is not None:
            self.paged_arena.unregister()
        self._kc = self._vc = self._dkc = self._dvc = None
        self._params = self._d_params = None
        self._swapped = []
        self._prefilling = {}
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
        if _monitor.active():
            # armed before the dispatches: a first step after an idle
            # spell that wedges is then an armed, silent source
            _monitor.heartbeat(self._hb_source)
        if _stepprof._active:
            _stepprof.begin(self.stats.engine_label, self.step_count)
        try:
            with torch.no_grad():
                self._grow_live_slots()
                if any(s is not None for s in self._slots):
                    self._decode_once()
                if _stepprof._active:
                    _stepprof.push("schedule")
                self._schedule(self._clock())
                if _stepprof._active:
                    _stepprof.pop()
        except Exception as e:
            _stepprof.abort()
            err = self._fail(e)
            if err is e:
                raise
            raise err from e
        self.stats.on_schedule(self.scheduler.queue_depth)
        self.step_count += 1
        if _stepprof._active:
            _stepprof.end()
        pending = self.pending
        if not pending and _monitor.active():
            # drained: alive, but idle is not hung
            _monitor.heartbeat(self._hb_source, busy=False)
        return pending

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
        """Reject every live or swapped-out (``started=True``) and
        prefilling or queued (``started=False``) request typed, returning
        the blocks of those prefilling, and return the error for
        ``step()`` to raise: ``cause`` itself when it is an
        ``EngineFailedError``."""
        self._failed = True
        step = self.step_count
        err = cause if isinstance(cause, EngineFailedError) else \
            EngineFailedError(f"engine failed at step {step}: {cause!r}",
                              engine_step=step)
        _trace.event("serve/engine_failed", cat="serve", step=step,
                     error=repr(cause), live=self.live_slots,
                     queued=self.scheduler.queue_depth)
        self.stats.registry.counter(
            "resilience.engine_failures",
            help="serve engines failed by a raising decode/prefill").inc()
        t_fail = self._clock()

        def rejected(rid, started):
            _trace.event("serve/request_rejected", cat="serve",
                         request=rid, reason="engine_failed",
                         started=started)
            if _reqs._active:
                _reqs._ledger.on_reject(rid, t=t_fail,
                                        reason="engine_failed",
                                        engine=self.stats.engine_label,
                                        started=started)

        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            self._release_prefix(slot)
            self._free_slot_blocks(slot)
            rid = slot.handle.request.request_id
            rejected(rid, True)
            slot.handle._reject(EngineFailedError(
                f"{err} ({rid} was in flight, {len(slot.emitted)} tokens "
                f"emitted)", request_id=rid, started=True, engine_step=step))
            self._slots[i] = None
            self._handles.pop(rid, None)
        for pf in self._prefilling.values():
            rid = pf.request.request_id
            self._free_prefilling(pf)
            rejected(rid, False)
            pf.handle._reject(EngineFailedError(
                f"{err} ({rid} was prefilling at offset {pf.off}, nothing "
                f"streamed)", request_id=rid, started=False,
                engine_step=step))
            self._handles.pop(rid, None)
        self._prefilling = {}
        for sw in self._swapped:
            rid = sw.request.request_id
            rejected(rid, True)
            sw.handle._reject(EngineFailedError(
                f"{err} ({rid} was swapped out mid-decode, "
                f"{len(sw.emitted)} tokens emitted)", request_id=rid,
                started=True, engine_step=step))
            self._handles.pop(rid, None)
        self._swapped = []
        for req in self.scheduler.drain():
            h = self._handles.pop(req.request_id, None)
            if h is not None:
                rejected(req.request_id, False)
                h._reject(EngineFailedError(
                    f"{err} ({req.request_id} was queued)",
                    request_id=req.request_id, started=False,
                    engine_step=step))
        # a request popped from the queue but not yet in a slot (its
        # prefill raised) streamed nothing: requeue-safe
        for rid, h in list(self._handles.items()):
            if not h.done():
                rejected(rid, False)
                h._reject(EngineFailedError(
                    f"{err} ({rid} was admitting, not started)",
                    request_id=rid, started=False, engine_step=step))
        self._handles.clear()
        if _monitor.active():
            # dead, not hung
            _monitor.heartbeat(self._hb_source, busy=False)
        return err

    def shed(self, reason="slo_pressure", below_priority=None):
        """Shed the lowest-priority queued request
        (``FIFOScheduler.shed_lowest``), rejecting its handle with
        :class:`LoadShedError`; returns it, or None.  The supervisor's
        SLO-pressure admission calls this; engine users may too."""
        victim = self.scheduler.shed_lowest(reason,
                                            below_priority=below_priority)
        if victim is None:
            return None
        h = self._handles.pop(victim.request_id, None)
        if h is not None:
            h._reject(LoadShedError(
                f"{victim.request_id} shed ({reason}): priority "
                f"{victim.priority} was the lowest queued under SLO "
                f"pressure"))
        _trace.event("serve/shed", cat="serve", reason=reason,
                     request=victim.request_id, priority=victim.priority)
        _trace.event("serve/request_rejected", cat="serve",
                     request=victim.request_id, reason=f"shed:{reason}")
        if _reqs._active:
            _reqs._ledger.on_reject(victim.request_id, t=self._clock(),
                                    reason=f"shed:{reason}",
                                    engine=self.stats.engine_label,
                                    started=False)
        return victim

    def _mask_pass(self):
        """The structured slots' vocabulary masks for this step, ``{slot:
        (V,) bool}``, from their automata on the host (memoized per state
        by ``JsonSchemaAutomaton``).  A state whose mask admits no token
        rejects that request typed (``structured_dead_end``); the engine
        serves the others."""
        masks = {}
        for i, s in enumerate(self._slots):
            if s is None or s.automaton is None:
                continue
            m = np.asarray(s.automaton.mask(s.astate), bool)
            if m.any():
                masks[i] = m
                continue
            rid = s.handle.request.request_id
            self._reject_live(i, s, ValueError(
                f"{rid}: structured automaton state {s.astate!r} admits no "
                f"vocabulary token; the grammar cannot complete from here"),
                "structured_dead_end")
        return masks

    def _step_keys(self, sel, live):
        """The sampling keys of one step's lanes ``sel`` (slot or -1),
        (w, n_keys, 2) ``uint32``, and each live slot's key advanced past
        them, as the JAX engine's step advances ``_keys``: a plain step
        splits the key (sample with the first half, carry the second); a
        speculative one splits it in three (draft, verify, carry), the
        draft key in ``spec_k`` (one a proposal step) and the verify key
        in two (accept test, correction token)."""
        pick = np.where(live, sel, 0)
        if self.draft is None:
            ks = prng.split(self._keys[pick])
            step, carry = ks[:, :1], ks[:, 1]
        else:
            ks = prng.split(self._keys[pick], 3)
            step = np.concatenate([prng.split(ks[:, 0], self.spec_k),
                                   prng.split(ks[:, 1])], 1)
            carry = ks[:, 2]
        self._keys[pick[live]] = carry[live]
        return step

    def _decode_once(self):
        if _faults._armed:
            # the chaos hook: a fault here is a raising decode step (the
            # speculative step's too); step() fails the engine typed
            _faults.check("serve.decode_step")
        masks = self._mask_pass()
        lanes = [i for i, s in enumerate(self._slots) if s is not None]
        n = len(lanes)
        if n == 0:
            return
        with_lp = any(self._slots[i].group is not None for i in lanes)
        arena = self.paged_arena
        if arena is None or self.draft is not None:
            # the slot arena, and every speculative step (its draft arena
            # is slot-indexed): slot i is lane i, every slot steps
            w = self.max_slots
            sel = [i if s is not None else -1
                   for i, s in enumerate(self._slots)]
        else:
            w = self._paged_width(n)
            sel = lanes + [-1] * (w - n)
        live = np.asarray([i >= 0 for i in sel])
        pick = np.where(live, sel, 0)
        self._inputs.stage(self._toks[pick], self._pos[pick], live,
                           self._step_keys(sel, live),
                           np.where(live, self._temps[pick], 0),
                           self._block_tables(sel))
        rows = None
        if masks:
            rows = np.ones((w, self.cfg.vocab_size), bool)
            for r, i in enumerate(sel):
                if i in masks:
                    rows[r] = masks[i]
        # a plain step keeps its width as its key, as before fork and
        # structured decoding: a plain engine's steps stay what they were
        key = (w, bool(masks), with_lp) if masks or with_lp else w
        gather = arena is not None and arena.config.kernel == "gather"
        name = "serve/decode_step" if self.draft is None else \
            "serve/spec_step"
        _mon = _monitor.active()
        _hb_t0 = time.perf_counter() if _mon else 0.0
        fresh = not gather and self.capture and key not in self._steps
        _sp = _stepprof._active
        with _trace.span(name, cat="serve", step=self.step_count, live=n,
                         width=w):
            n_rb = None
            if gather:
                n_rb = (int(self._pos[lanes].max()) + self._spec_pad) \
                    // arena.block_size + 1
            # the step is one dispatch to the profiler: a replay once
            # captured, never a call through the executor
            args = (key, self._inputs._h, rows, n_rb)
            toks = (_stepprof.timed_dispatch(self._dev.decode, args, {})
                    if _sp else self._dev.decode(*args))
            if _sp:
                _stepprof.push("sync")
            lps = None
            if with_lp:
                toks, lps = toks
                lps = lps.cpu().numpy()
            nxt = toks.cpu().numpy()
            if _sp:
                _stepprof.pop()
        if _mon:
            # the first step of a key runs eagerly and captures: its time
            # would poison the step-time estimator
            _monitor.heartbeat(self._hb_source,
                               step_time=time.perf_counter() - _hb_t0,
                               fresh_compile=fresh)
        self.stats.on_decode_step(n)
        now = self._clock()
        led = _reqs._ledger if _reqs._active else None
        lbl = self.stats.engine_label
        if _sp:
            _stepprof.push("emit")
        for r, i in enumerate(sel):
            if i < 0:
                continue
            slot = self._slots[i]
            rid = slot.handle.request.request_id
            if self.draft is None:
                if slot.group is not None:
                    # summed before _emit, which may retire the slot and
                    # seal the score into its result
                    slot.score += float(lps[r])
                self._toks[i] = nxt[r]
                self._pos[i] += 1
                self._emit(i, slot, int(nxt[r]), now)
                if led is not None:
                    if _sp:
                        _stepprof.push("ledger")
                    led.on_step(rid, engine=lbl, t=now, tokens=1)
                    if _sp:
                        _stepprof.pop()
                continue
            # a speculative chunk: the accepted proposals and the
            # correction (or bonus) token, until the request retires
            a_draft = int(nxt[r, -1])
            self.stats.on_spec(a_draft, self.spec_k - 1)
            emitted = 0
            for j in range(a_draft + 1):
                self._emit(i, slot, int(nxt[r, j]), now)
                emitted += 1
                if self._slots[i] is not slot:
                    break
            if led is not None:
                if _sp:
                    _stepprof.push("ledger")
                led.on_step(rid, engine=lbl, t=now, tokens=emitted,
                            accepted=a_draft, drafted=self.spec_k - 1)
                if _sp:
                    _stepprof.pop()
            if self._slots[i] is slot:
                self._toks[i] = nxt[r, emitted - 1]
                self._pos[i] += emitted
        if _sp:
            _stepprof.pop()

    def _step_fn(self, key, n_rb=None):
        """The step of ``key``, a width ``w`` or (``w``, masked, with_lp):
        the pool step over the first ``w`` lanes of the device inputs (the
        slot arena's over all its slots) and the sampling, returning (w,)
        int64 tokens, under the lanes' vocabulary masks when masked, and
        with their (w,) float32 log-probabilities under the raw
        distribution (:func:`chosen_logprob`) with_lp; on a speculative
        engine ``spec_step``, returning (w, spec_k + 1)."""
        w, masked, with_lp = key if isinstance(key, tuple) else \
            (key, False, False)
        arena = self.paged_arena
        inp = self._inputs.view(w)
        if self.draft is not None:
            return lambda: self._x.spec_step(inp, n_rb)
        mask = inp["masks"] if masked else None

        def sample(logits):
            toks = _sample(logits, inp["temps"], inp["keys"][:, 0],
                           self._top_k, self._top_p, mask=mask)
            if with_lp:
                return toks, chosen_logprob(logits, toks)
            return toks

        def step():
            if arena is None:
                logits = self._x.pool_decode_step(self._params, self._kc,
                                                  self._vc, inp)
            else:
                logits = self._x.paged_decode_step(
                    self._params, arena.pool_k, arena.pool_v, inp,
                    arena.block_size, kernel=arena.config.kernel,
                    n_rb=n_rb)
            return self._x.finish_step(logits, sample, w, with_lp)

        return step

    def _captured(self, key):
        """The outputs of one step of ``key`` (the slot arena's, a
        block-kernel step or a speculative one; :meth:`_step_fn`): a
        replay of the key's captured step; the first step of a key runs
        eagerly and then captures it (which runs nothing), so no request
        advances twice."""
        step = self._steps.get(key)
        if step is not None:
            return step()
        fn = self._step_fn(key)
        if not self.capture:
            return fn()
        dev = self._inputs.buf.device
        toks = graphs.warm(fn, dev)
        if dev.type == "cuda" and self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        self._steps[key] = graphs.Step(
            fn, dev, pool=self._graph_pool,
            capture_error_mode=("global" if self._shard is None
                                else self._shard.capture_mode()))
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
                self._reject_live(idx, slot, e, "on_token_callback")
                return
        if slot.automaton is not None:
            # the token the mask admitted advances the grammar; a refusal
            # means the mask and the automaton disagree, charged to this
            # request alone
            try:
                slot.astate = slot.automaton.advance(slot.astate, token)
            except Exception as e:
                self._reject_live(idx, slot, e, "structured_advance")
                return
            if slot.automaton.done(slot.astate):
                self._retire(idx, slot, now, "stop")
                return
        stop = req.stop_token is not None and token == req.stop_token
        if stop or slot.remaining <= 0:
            self._retire(idx, slot, now, "stop" if stop else "length")

    def _retire(self, idx, slot, now, finish_reason):
        req = slot.handle.request
        n = len(slot.emitted)
        _sp = _stepprof._active
        if _sp:
            _stepprof.push("retire")
        _trace.event("serve/retire", cat="serve", request=req.request_id,
                     slot=idx, tokens=n, step=self.step_count)
        if _reqs._active:
            if _sp:
                _stepprof.push("ledger")
            _reqs._ledger.on_retire(req.request_id,
                                    engine=self.stats.engine_label, t=now,
                                    finish_reason=finish_reason, tokens=n)
            if _sp:
                _stepprof.pop()
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
            finished_step=self.step_count,
            branch=slot.branch,
            score=slot.score if slot.group is not None else None)
        if self.prefix_cache is not None:
            self._donate(idx, slot, req, result)
        elif req.pin_session:
            # no cache: the handle still builds the next turn, cold
            result.session = SessionHandle(result.tokens)
        self._free_slot_blocks(slot)
        slot.handle._finish(result)
        self.stats.on_complete(result)
        self._slots[idx] = None
        self._handles.pop(req.request_id, None)
        self._fork_event(None)
        if _sp:
            _stepprof.pop()

    def _reject_live(self, idx, slot, error, reason):
        """Reject a live slot's request typed (its client callback
        raised, its grammar reached a dead end or refused a token, its
        copy-on-write copy faulted): its prefix references and blocks
        are dropped and the handle raises ``error``.  The engine serves
        the others."""
        req = slot.handle.request
        self._release_prefix(slot)
        self._free_slot_blocks(slot)
        self._slots[idx] = None
        self._handles.pop(req.request_id, None)
        _trace.event("serve/request_rejected", cat="serve",
                     request=req.request_id, reason=reason)
        if _reqs._active:
            _reqs._ledger.on_reject(req.request_id, t=self._clock(),
                                    reason=reason,
                                    engine=self.stats.engine_label,
                                    started=True)
        slot.handle._reject(error)
        self._fork_event(None)

    def _fork_event(self, what):
        """Count a fork event (``stats.on_fork``) and refresh the
        shared-blocks gauge, on a paged engine."""
        if self.paged_arena is not None:
            self.stats.on_fork(what, self.paged_arena.shared_blocks)

    def _free_slot_blocks(self, slot):
        """Drop the slot's reference to each of its blocks: a private
        block returns to the free list, a cached one it shares stays the
        tree's."""
        arena = self.paged_arena
        if arena is not None:
            arena.free([b for b in slot.blocks if b != arena.trash])
        slot.blocks = []

    def _release_prefix(self, slot):
        if self.prefix_cache is not None and slot.prefix_nodes:
            self.prefix_cache.release(slot.prefix_nodes)
            slot.prefix_nodes = []

    def _donate(self, idx, slot, req, result):
        """Retire into the prefix cache: the full blocks of the prompt
        (canonical: the admission's chunks wrote them and decode never
        touches positions below the prompt's length), and for a
        ``pin_session`` request the whole sequence, whose generated
        region is recomputed first, pinned as ``result.session``."""
        cache = self.prefix_cache
        B = cache.block_size
        plen, total = len(req.prompt_ids), len(result.tokens)
        want = bool(req.pin_session)
        n_goal = total // B if want else plen // B
        try:
            if self.paged_arena is not None:
                path = self._paged_retire(slot, result.tokens, plen,
                                          n_goal)
            else:
                path = self._prefix_retire(idx, result.tokens, plen,
                                           n_goal)
            if want:
                cache.acquire(path)
                result.session = SessionHandle(result.tokens, cache, path)
        finally:
            self._release_prefix(slot)

    def _paged_retire(self, slot, tokens, plen, n_goal):
        """Donation on the paged arena, without a copy: the tree adopts
        the slot's blocks.  A lane the tree already holds keeps the tree's
        block and the slot's reference to it (a shared prefix block) or
        the slot's duplicate goes; the blocks past the donation (the
        decode region, the growth block) are freed.  Returns the tree
        path."""
        arena, cache = self.paged_arena, self.prefix_cache
        B = cache.block_size
        # the last emitted token's position is never written, so its
        # block may not exist: a session pins one block less then
        n_goal = min(n_goal, len(slot.blocks))
        # fork: the tree adopts no block a live sibling still references
        # (the sibling's reference would outlive the adoption, and the
        # block would have two owners); the last sibling to retire holds
        # them alone and donates the whole prefix
        for j in range(slot.n_shared, n_goal):
            if arena.is_shared(slot.blocks[j]):
                n_goal = j
                break
        path = []
        if n_goal > 0:
            if n_goal > plen // B:
                self._dev.canon_blocks(list(slot.blocks),
                                       np.asarray(tokens, np.int64),
                                       plen // B, n_goal)
            path = cache.adopt_blocks(tokens, slot.blocks, n_goal)
        kept = {slot.blocks[j] for j in range(slot.n_shared, len(path))
                if path[j].block == slot.blocks[j]}
        arena.free([b for b in slot.blocks
                    if b != arena.trash and b not in kept])
        slot.blocks = []
        return path

    def _prefix_retire(self, idx, tokens, plen, n_goal):
        """Donation on the slot arena: the missing blocks are copied out
        of the slot's row into the cache's pool (a path already cached
        whole only has its recency refreshed).  Returns the tree path."""
        cache = self.prefix_cache
        if n_goal <= 0:
            return []
        existing = cache.lookup(tokens)[:n_goal]
        if len(existing) == n_goal:
            cache.touch(existing)
            return existing
        path, placed = cache.plan_donation(tokens, n_goal)
        self._dev.donate_slot(idx, np.asarray(tokens, np.int64),
                              plen // cache.block_size, n_goal, placed)
        return path

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
        """Before the decode step, every live slot must own the blocks
        holding the positions it writes (pos .. pos + spec_k - 1 on a
        speculative engine).  A windowed slot first drops the blocks that
        left its window: block j is dead once its last position falls
        below pos - window + 1, the lowest key the step's first query
        sees; its table entry becomes the trash block, so entries stay
        positional.  A slot that cannot grow (pool exhausted, no
        strictly-lower-priority victim) swaps itself out: its blocks free
        the pool for the others and it resumes once capacity returns, so
        the pool never livelocks with every slot too big to advance.  The
        slot arena's rows are whole: nothing to grow."""
        arena = self.paged_arena
        if arena is None:
            return
        B, W = arena.block_size, self._window
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            pos = int(self._pos[i])
            if W is not None:
                dead = min(max(0, (pos - W + 1) // B), len(slot.blocks))
                drop = [b for b in slot.blocks[:dead] if b != arena.trash]
                if drop:
                    arena.free(drop)
                    arena.on_window_drop(len(drop))
                    slot.blocks[:dead] = [arena.trash] * dead
            if slot.cow:
                # copy-on-first-write: the step writes position pos into
                # block pos // B; a sibling still referencing it gets to
                # keep its bytes, this slot a private copy.  Branches
                # fork past the cached prefix, so a cache-owned block is
                # never copied here
                wb = pos // B
                if wb < len(slot.blocks) and \
                        arena.is_shared(slot.blocks[wb]) and \
                        not self._cow_copy(i, slot, wb):
                    continue
            short = (pos + self._spec_pad) // B + 1 - len(slot.blocks)
            if short <= 0:
                continue
            got = self._alloc_blocks(short, slot.handle.request.priority,
                                     exclude_idx=i)
            if got is None:
                self._preempt_slot(i, reason="pool_exhausted")
                continue
            slot.blocks.extend(got)

    def _cow_copy(self, idx, slot, wb):
        """Give ``slot`` a private copy of its shared block ``wb`` before
        the step writes into it.  False when the slot did not survive:
        the pool ran out (it preempted itself) or the copy faulted (site
        ``serve.fork_copy``: that branch alone is rejected, typed, and its
        claim freed)."""
        arena = self.paged_arena
        got = self._alloc_blocks(1, slot.handle.request.priority,
                                 exclude_idx=idx)
        if got is None:
            self._preempt_slot(idx, reason="pool_exhausted")
            return False
        old = slot.blocks[wb]
        try:
            self._dev.copy_block(old, got[0])
        except Exception as e:
            arena.free(got)
            self._reject_live(idx, slot, e, "fork_copy")
            return False
        slot.blocks[wb] = got[0]
        arena.free([old])  # this slot's reference; the sibling keeps it
        self._fork_event("cow_copies")
        return True

    def _alloc_blocks(self, n, priority, exclude_idx=None):
        """``n`` pool blocks for a request at ``priority``, preempting
        strictly-lower-priority live slots (lowest priority, then latest
        admitted) until the allocation fits, or None.  Strictly lower
        only: equal priorities never preempt each other, which is what
        makes every preemption chain end.  Feasibility is checked before
        any side effect: if the free blocks and every eligible victim's
        blocks together cannot cover ``n``, nothing is preempted (that
        would be pure swap churn).  Unreferenced cached blocks count as
        available: the arena evicts them before an allocation fails."""
        arena = self.paged_arena
        avail = arena.blocks_free
        if self.prefix_cache is not None:
            avail += self.prefix_cache.evictable_blocks()
        avail += sum(
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
        sw.key = self._keys[idx].copy()
        sw.seq = next(self._swap_seq)
        sw.t_preempt = self._clock()
        # fork and grammar state ride the swap too: the resumed slot
        # scores and masks as the uninterrupted one would
        sw.group, sw.branch, sw.score = slot.group, slot.branch, slot.score
        sw.automaton, sw.astate = slot.automaton, slot.astate
        # the blocks holding positions < pos (pos itself is written next)
        # past the leading ones a windowed slot dropped, so the image is
        # O(window) like the slot
        j_lo = 0
        while j_lo < len(slot.blocks) and slot.blocks[j_lo] == arena.trash:
            j_lo += 1
        sw.j_lo = j_lo
        sw.image = self._dev.swap_out(
            list(slot.blocks[j_lo:]),
            max(0, (pos - 1) // arena.block_size + 1 - j_lo))
        sw.draft = None
        if self.draft is not None:
            sw.draft = self._dev.draft_read(idx)
        n_freed = len(slot.blocks) - j_lo
        self._release_prefix(slot)
        self._free_slot_blocks(slot)
        self._slots[idx] = None
        self._swapped.append(sw)
        arena.on_preempt()
        self._fork_event(None)
        _trace.event("serve/preempt", cat="serve", request=req.request_id,
                     slot=idx, reason=reason, pos=pos, blocks_freed=n_freed,
                     tokens=len(sw.emitted))
        if _reqs._active:
            _reqs._ledger.on_preempt(req.request_id,
                                     engine=self.stats.engine_label,
                                     t=sw.t_preempt)

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
            blocks = self._alloc_blocks(
                (sw.pos + self._spec_pad) // arena.block_size + 1 - sw.j_lo,
                sw.priority)
            if blocks is None:
                return
            idx = free[0]
            self._dev.swap_in(sw.image, blocks)
            if sw.draft is not None:
                self._dev.draft_write(idx, sw.draft)
            # the dropped leading entries stay trash, as the
            # uninterrupted slot's table would hold them at this pos
            slot = _Slot(sw.handle, sw.remaining, sw.admit_time,
                         sw.admitted_step, [arena.trash] * sw.j_lo + blocks)
            slot.emitted = sw.emitted
            slot.first_token_time = sw.first_token_time
            # the swap-in wrote a private copy of every block: the resumed
            # slot shares nothing (cow stays off)
            slot.group, slot.branch, slot.score = sw.group, sw.branch, \
                sw.score
            slot.automaton, slot.astate = sw.automaton, sw.astate
            self._slots[idx] = slot
            self._toks[idx] = sw.tok
            self._pos[idx] = sw.pos
            self._temps[idx] = sw.temp
            self._keys[idx] = sw.key
            self._swapped.pop(0)
            _trace.event("serve/resume", cat="serve",
                         request=sw.request.request_id, slot=idx,
                         pos=sw.pos, swapped_s=now - sw.t_preempt)
            if _reqs._active:
                _reqs._ledger.on_resume(sw.request.request_id,
                                        engine=self.stats.engine_label,
                                        t=now)

    def _blocked_priority(self):
        """A swapped request still waiting after the resume pass outranks
        fresh arrivals at or below its priority (it already streamed
        tokens): their admission waits behind it."""
        return (max(sw.priority for sw in self._swapped)
                if self._swapped else None)

    # -- admission -------------------------------------------------------
    def _free_slots(self):
        """Slots neither live nor reserved by an admission in flight."""
        return [i for i, s in enumerate(self._slots)
                if s is None and i not in self._prefilling]

    def _reject_expired(self, expired, now):
        for req in expired:
            self.stats.on_deadline_expired()
            _trace.event("serve/request_rejected", cat="serve",
                         request=req.request_id, reason="deadline")
            if _reqs._active:
                _reqs._ledger.on_reject(req.request_id, t=now,
                                        reason="deadline",
                                        engine=self.stats.engine_label,
                                        started=False)
            self._handles.pop(req.request_id)._reject(DeadlineExceededError(
                f"{req.request_id}: deadline {req.deadline} passed at {now} "
                f"before a slot was available"))

    def _schedule(self, now):
        """Resume swapped-out requests first (they already streamed
        tokens), then, under a chunked-prefill budget, spend it on the
        admissions in flight (in admission order: an expensive head
        blocks the budget, it is never skipped), then admit queued
        requests into free slots (at most ``admit_per_step``) while their
        first blocks fit, preempting strictly-lower-priority slots for
        them (a request whose blocks do not fit, that a swapped request
        outranks, or that finds the budget spent, waits at the head of
        the queue).  Admissions prefill and emit their first token: one
        batched prefill per prompt length, or, with a prefix cache or a
        budget, block-width ``prefill_chunk`` passes (:meth:`
        _advance_prefilling`), a budgeted one possibly across steps."""
        self._try_resume(now)
        left = self._budget
        if left is not None:
            B = self.paged_arena.block_size
            for idx in sorted(self._prefilling,
                              key=lambda i: self._prefilling[i].seq):
                if left < B:
                    break
                left = self._advance_prefilling(idx, left)
        if self.scheduler.queue_depth == 0:
            return
        free = self._free_slots()
        arena, cache = self.paged_arena, self.prefix_cache
        cap = len(free)
        if arena is not None and arena.config.admit_per_step is not None:
            cap = min(cap, arena.config.admit_per_step)
        admit, expired = self.scheduler.schedule(cap, now)
        self._reject_expired(expired, now)
        blocked_p = self._blocked_priority()
        chunked = cache is not None or left is not None
        placed = []
        _sp = _stepprof._active
        for k, req in enumerate(admit):
            got = None
            if _sp:
                _stepprof.push("admit")
            # an n > 1 request admits only when a slot for every branch
            # is free this pass: a partly forked family would make the
            # branch count depend on the traffic
            if (left is None or left >= arena.block_size) \
                    and len(free) >= req.n:
                got = self._claim(req, blocked_p)
            if got is None:
                if _sp:
                    _stepprof.pop()
                for r in reversed(admit[k:]):
                    self.scheduler.requeue_front(r)
                break
            idx = free.pop(0)
            kids = [free.pop(0) for _ in range(req.n - 1)]
            if _reqs._active:
                # the queue-wait phase of this hop ends here
                _reqs._ledger.on_admit(req.request_id,
                                       engine=self.stats.engine_label,
                                       t=now, slot=idx,
                                       step=self.step_count)
            if chunked:
                handle = self._handles[req.request_id]
                self._begin_prefilling(idx, req, now, *got)
                left = self._advance_prefilling(idx, left)
                if kids:  # n > 1 has no budget: the admission finished
                    self._fork_group_admit(handle, kids, now)
            else:
                placed.append((idx, req, got[0], kids))
            if _sp:
                _stepprof.pop()
        by_len = {}
        for p in placed:
            ring = self._ring_min is not None and \
                len(p[1].prompt_ids) >= self._ring_min
            by_len.setdefault((len(p[1].prompt_ids), ring), []).append(p)
        for (plen, ring), group in by_len.items():
            if _sp:
                _stepprof.push("admit")
            # a windowed admission's leading entries are trash: their
            # lanes left the window before any query
            dests = [("slot", idx) if arena is None else
                     ("blocks", {j: b for j, b in enumerate(blocks)
                                 if b != arena.trash})
                     for idx, _, blocks, _ in group]
            with _trace.span("serve/prefill", cat="serve", prompt_len=plen,
                             requests=len(group), step=self.step_count,
                             ring=ring):
                if ring:
                    logits = torch.cat([self._ring_admit(r, d[1])
                                        for (_, r, _, _), d in
                                        zip(group, dests)])
                else:
                    logits = self._dev.prefill_rows(
                        np.stack([r.prompt_ids for _, r, _, _ in group]),
                        dests)
            self.stats.on_prefill()
            for r, (idx, req, blocks, kids) in enumerate(group):
                handle = self._handles[req.request_id]
                self._admit(idx, req, now, blocks, logits[r:r + 1])
                if kids:
                    self._fork_group_admit(handle, kids, now)
            if _sp:
                _stepprof.pop()

    def _ring_admit(self, req, lanes):
        """A cold admission of at least ``ring_min_tokens`` tokens through
        the ring-attention prefill (``TPConfig(ring_prefill=True)``): the
        prompt right-padded to a multiple of the block size and the tp
        width; returns its (1, V) logits."""
        plen = len(req.prompt_ids)
        m = math.lcm(self.paged_arena.block_size, self._shard.tp)
        ids = np.zeros(-(-plen // m) * m, np.int64)
        ids[:plen] = req.prompt_ids
        return self._dev.ring_prefill(ids, plen, lanes)

    def _claim(self, req, blocked_p):
        """An admission's cached prefix (pinned before its blocks are
        allocated, so the allocation's eviction cannot take it) and its
        first blocks, up to the one holding its prompt's last position,
        as ``(blocks, nodes)``; on a windowed model the entries below its
        first in-window lane are the trash block, never allocated.  None,
        with nothing held, when the blocks do not fit or a swapped request
        at ``blocked_p`` outranks it."""
        arena, cache = self.paged_arena, self.prefix_cache
        plen = len(req.prompt_ids)
        nodes = []
        if cache is not None:
            if _stepprof._active:
                _stepprof.push("prefix_lookup")
            nodes = cache.lookup(req.prompt_ids)[
                :(plen - 1) // cache.block_size]
            if _stepprof._active:
                _stepprof.pop()
            cache.acquire(nodes)
        blocks = [] if arena is None else None
        if arena is not None and (blocked_p is None
                                  or req.priority > blocked_p):
            B = arena.block_size
            j_lo = 0 if self._window is None else \
                max(0, (plen - self._window + 1) // B)
            got = self._alloc_blocks(plen // B + 1 - j_lo - len(nodes),
                                     req.priority)
            if got is not None:
                blocks = [arena.trash] * j_lo + got
        if blocks is None:
            if nodes:
                cache.release(nodes)
            return None
        return blocks, nodes

    def _chunk_width(self):
        cache = self.prefix_cache
        return cache.block_size if cache is not None else \
            self.paged_arena.block_size

    def _begin_prefilling(self, idx, req, now, blocks, nodes):
        """Reserve slot ``idx`` for a chunked admission holding ``blocks``
        and the pinned cached ``nodes``: a fresh row of the width its
        chunks span, the nodes' K/V at its first lanes and zeros past,
        which block-width passes advance from the first uncached block
        to the one holding the prompt's last token.  Registered before
        the row is made, so a failure from here on frees what it
        holds."""
        cache = self.prefix_cache
        B = self._chunk_width()
        plen = len(req.prompt_ids)
        pf = _Prefilling()
        pf.handle, pf.request = self._handles[req.request_id], req
        pf.blocks, pf.nodes = blocks, nodes
        pf.off, pf.last_off = len(nodes) * B, ((plen - 1) // B) * B
        pf.t_admit, pf.admitted_step = now, self.step_count
        pf.seq = next(self._prefill_seq)
        self._prefilling[idx] = pf
        width = pf.last_off + B
        ids = np.zeros(width, np.int64)
        ids[:plen] = req.prompt_ids
        self._dev.pf_begin(idx, ids, [n.block for n in nodes], width)

    def _advance_prefilling(self, idx, left=None):
        """Run slot ``idx``'s chunk passes while ``left`` budget tokens
        cover one (None: all of them), finishing the admission when the
        last lands.  Returns the budget left."""
        pf = self._prefilling[idx]
        B = self._chunk_width()
        req = pf.request
        with _trace.span("serve/prefill", cat="serve",
                         prompt_len=len(req.prompt_ids), requests=1,
                         step=self.step_count, offset=pf.off,
                         cached_tokens=len(pf.nodes) * B):
            while pf.off <= pf.last_off and (left is None or left >= B):
                if _faults._armed:
                    _faults.check("serve.prefill_chunk")
                self._dev.pf_chunk(idx, pf.off, B)
                if self._budget is not None:
                    self.stats.on_budget_chunk()
                if _reqs._active and (pf.nodes or self._budget is not None):
                    # the JAX engine's chunk hops: a warm admission's or a
                    # budgeted one's (its cold admissions without a budget
                    # prefill whole, in no chunks)
                    _reqs._ledger.on_prefill_chunk(
                        req.request_id, engine=self.stats.engine_label,
                        t=self._clock(), offset=pf.off)
                pf.off += B
                if left is not None:
                    left -= B
        if pf.off > pf.last_off:
            self._finish_prefilling(idx)
        return left

    def _finish_prefilling(self, idx):
        """The last chunk landed: the row goes into the slot (the slot
        arena) or its lanes past the cached prefix into the request's
        blocks (paged: the table's first entries are the tree's blocks,
        shared, never copied), and the slot goes live with its first
        token sampled from the last chunk's hidden row."""
        pf = self._prefilling[idx]
        cache, arena = self.prefix_cache, self.paged_arena
        req = pf.request
        plen = len(req.prompt_ids)
        blocks, nodes = pf.blocks, pf.nodes
        if arena is None:
            dest = ("slot", idx)
        else:
            m = len(nodes)
            dest = ("blocks", {m + j: b for j, b in enumerate(blocks)
                               if b != arena.trash})
        logit = self._dev.pf_finish(idx, plen - 1 - pf.last_off, dest)
        if arena is not None:
            arena.share([n.block for n in nodes])
            blocks = [n.block for n in nodes] + blocks
        del self._prefilling[idx]
        if cache is not None:
            cache.on_admit(len(nodes), plen, request_id=req.request_id)
        self.stats.on_prefill()
        self._admit(idx, req, pf.t_admit, blocks, logit, nodes,
                    step=pf.admitted_step)

    def _free_prefilling(self, pf):
        """Return an unfinished admission's blocks and unpin its cached
        prefix."""
        arena = self.paged_arena
        if arena is not None:
            arena.free([b for b in pf.blocks if b != arena.trash])
        if pf.nodes:
            self.prefix_cache.release(pf.nodes)
        pf.blocks, pf.nodes = [], []

    def _admit(self, idx, req, now, blocks, logit, nodes=(), step=None):
        """Start a prefilled request in slot ``idx`` (its K/V already in
        its slot or blocks): on a speculative engine prefill the draft's
        row of the slot (cold: the prefix cache holds the target's K/V
        only), sample its first token (position ``plen``) from ``logit``
        and emit it.  ``nodes``: the cached path it holds while live;
        ``step``: the step it was admitted at (default this one)."""
        handle = self._handles[req.request_id]
        plen = len(req.prompt_ids)
        if self.draft is not None:
            self._dev.draft_admit(idx, req.prompt_ids)
        temp = np.float32(req.temperature)
        ast0 = mask0 = None
        if req.structured is not None:
            # the first token already obeys the grammar's initial state
            ast0 = req.structured.initial()
            mask0 = torch.as_tensor(
                np.asarray(req.structured.mask(ast0), bool)[None],
                device=logit.device)
        # the JAX engine's admission chain: split(PRNGKey(seed), 1)[0],
        # split once, sample with the first half and carry the second; a
        # greedy request's first token is the argmax, so nothing is drawn
        ks = prng.split(prng.split(prng.PRNGKey(req.seed), 1)[0])
        tok0 = int(_sample(logit, [temp], ks[:1] if temp > 0 else None,
                           self._top_k,
                           self._top_p, mask=mask0)[0])
        t_first = self._clock()
        slot = _Slot(handle, req.max_new_tokens, now,
                     self.step_count if step is None else step, blocks,
                     nodes)
        slot.automaton, slot.astate = req.structured, ast0
        self._slots[idx] = slot
        self.stats.on_admission(now - getattr(handle, "_submit_time", now),
                                t_first - now, warm=bool(nodes))
        if _reqs._active:
            _reqs._ledger.on_first_token(req.request_id,
                                         engine=self.stats.engine_label,
                                         t=t_first)
        self._toks[idx] = tok0
        self._pos[idx] = plen
        self._temps[idx] = temp
        self._keys[idx] = ks[1]
        self._emit(idx, slot, tok0, t_first)

    # -- fork (serve/fork.py) --------------------------------------------
    def _fork_group_admit(self, handle, kids, now):
        """Fork branches 1..n-1 of the ``n > 1`` admission of ``handle``
        off its freshly admitted slot into the slots ``kids`` the
        scheduling pass reserved.  If the first token already resolved
        the parent (a stop token, a completed grammar, a raising
        callback), every branch would have emitted that token alone: they
        seal at once with the parent's outcome instead."""
        req = handle.request
        rid = req.request_id
        pidx = next((i for i, s in enumerate(self._slots)
                     if s is not None and s.handle is handle), None)
        if pidx is None:
            for k in range(1, req.n):
                ch = RequestHandle(req)
                if handle._result is not None:
                    ch._finish(replace(handle._result,
                                       request_id=f"{rid}#{k}", branch=k))
                else:
                    ch._reject(handle._error)
                handle._fork_children.append(ch)
            return
        self._slots[pidx].group = next(self._fork_seq)
        for k, cidx in enumerate(kids, 1):
            self._spawn_branch(pidx, cidx, k, now)

    def _spawn_branch(self, parent_idx, child_idx, branch, now, seed=None,
                      max_new=None):
        """Clone the live slot ``parent_idx`` into ``child_idx`` as fork
        branch ``branch``: the child's block table is a copy of the
        parent's and each of its blocks gains a reference in the arena
        (no KV byte moves; the port's slots hold a reference to their
        cached prefix blocks too, so those gain one as well), its cached
        prefix nodes are acquired again, and the host state (token,
        position, temperature, emitted tokens, score, grammar state) is
        copied.  Both slots turn ``cow`` on.  The child's key is
        ``fold_in(parent key, branch)`` (or a fresh chain from ``seed``),
        as in the JAX engine, and it gets the parent's remaining budget
        (or ``max_new``)."""
        arena, cache = self.paged_arena, self.prefix_cache
        parent = self._slots[parent_idx]
        preq = parent.handle.request
        rid = preq.request_id
        child_rid = f"{rid}#{branch}"
        remaining = parent.remaining if max_new is None else int(max_new)
        child_req = replace(preq, request_id=child_rid, n=1,
                            max_new_tokens=(preq.max_new_tokens
                                            if max_new is None else
                                            remaining))
        child_handle = RequestHandle(child_req)
        child_handle._submit_time = now
        arena.share([b for b in parent.blocks if b != arena.trash])
        if cache is not None and parent.prefix_nodes:
            cache.acquire(parent.prefix_nodes)
        child = _Slot(child_handle, remaining, now, self.step_count,
                      list(parent.blocks), parent.prefix_nodes)
        child.n_shared = parent.n_shared
        child.emitted = list(parent.emitted)
        # the branch point is its first token: a branch pruned before its
        # own first step still seals with latencies
        child.first_token_time = now
        child.group, child.branch, child.score = parent.group, branch, \
            parent.score
        child.automaton, child.astate = parent.automaton, parent.astate
        parent.cow = child.cow = True
        self._toks[child_idx] = self._toks[parent_idx]
        self._pos[child_idx] = self._pos[parent_idx]
        self._temps[child_idx] = self._temps[parent_idx]
        self._keys[child_idx] = (
            prng.fold_in(self._keys[parent_idx], branch) if seed is None
            else prng.split(prng.PRNGKey(int(seed)), 1)[0])
        self._slots[child_idx] = child
        self._handles[child_rid] = child_handle
        kids = getattr(parent.handle, "_fork_children", None)
        if kids is None:
            kids = parent.handle._fork_children = []
        kids.append(child_handle)
        # a branch is a submission that skipped the queue and the
        # prefill: it balances completions, but records no admission
        # latency, which no client experienced
        self.stats.on_submit()
        if _reqs._active:
            lbl = self.stats.engine_label
            _reqs._ledger.on_submit(child_rid, engine=lbl, t=now,
                                    prompt_len=len(preq.prompt_ids),
                                    max_new_tokens=child_req.max_new_tokens)
            _reqs._ledger.on_admit(child_rid, engine=lbl, t=now,
                                   slot=child_idx, step=self.step_count,
                                   branch=branch)
            _reqs._ledger.on_first_token(child_rid, engine=lbl, t=now)
        _trace.event("serve/fork", cat="serve", request=child_rid,
                     parent=rid, slot=child_idx, branch=branch,
                     pos=int(self._pos[parent_idx]))
        self._fork_event("branches")
        return child_handle

    def fork(self, request_id, *, seed=None, max_new_tokens=None):
        """Split the live request ``request_id`` in two branches sharing
        every block decoded so far copy-on-write (tree search: fork the
        promising branch, ``prune`` the losers).  Returns a
        :class:`~singa_tpu_torch.serve.fork.BranchHandle` for the new
        branch; the original streams on unchanged.  ``seed``: the new
        branch's sampling seed (default: its key is ``fold_in(parent key,
        branch)``); ``max_new_tokens``: its remaining budget (default the
        parent's)."""
        self._check_open()
        if self.paged_arena is None or self.draft is not None \
                or self._window is not None:
            raise ValueError(
                "fork() needs a plain paged engine (no draft, no sliding "
                "window): the support matrix of GenerationRequest(n > 1)")
        if max_new_tokens is not None and int(max_new_tokens) < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        pidx = next((i for i, s in enumerate(self._slots)
                     if s is not None
                     and s.handle.request.request_id == request_id), None)
        if pidx is None:
            if self._handles.get(request_id) is None:
                raise ValueError(
                    f"{request_id}: unknown or already finished; fork() "
                    f"splits a live branch")
            if any(sw.request.request_id == request_id
                   for sw in self._swapped):
                state = "swapped out (preempted)"
            elif any(pf.request.request_id == request_id
                     for pf in self._prefilling.values()):
                state = "mid chunked prefill"
            else:
                state = "still queued"
            raise ValueError(
                f"{request_id} is {state}: fork() needs a live decoding "
                f"slot (step the engine until it decodes, then fork)")
        parent = self._slots[pidx]
        if parent.handle.request.pin_session:
            raise ValueError(
                f"{request_id} pins a session: a session continues ONE "
                f"stream; fork before pinning, or fork the continuation")
        free = self._free_slots()
        if not free:
            raise RuntimeError(
                f"no free slot to fork {request_id} into (max_slots="
                f"{self.max_slots}, all occupied); retire or prune a branch "
                f"first")
        if parent.group is None:
            parent.group = next(self._fork_seq)
        kids = getattr(parent.handle, "_fork_children", None)
        branch = len(kids) + 1 if kids else 1
        ch = self._spawn_branch(pidx, free[0], branch, self._clock(),
                                seed=seed, max_new=max_new_tokens)
        return BranchHandle(self, ch, branch)

    def prune(self, request_id):
        """Cut a fork branch (or any live or swapped-out request): drop
        its references to its blocks, which frees its private ones at
        once (a block a sibling or the prefix cache still holds stays),
        and seal a ``finish_reason="pruned"`` result with everything
        emitted so far.  ``ValueError`` for a request neither live nor
        swapped (a queued one expires by deadline, a finished one is
        sealed)."""
        if self._closed:
            raise RuntimeError(
                "engine is closed; build a new one with model.serve()")
        now = self._clock()
        for i, s in enumerate(self._slots):
            if s is not None and s.handle.request.request_id == request_id:
                self._fork_event("pruned")
                _trace.event("serve/prune", cat="serve", request=request_id,
                             slot=i, tokens=len(s.emitted))
                self._retire(i, s, now, "pruned")
                return
        for j, sw in enumerate(self._swapped):
            if sw.request.request_id != request_id:
                continue
            # a swapped request holds no block (freed at preemption):
            # sealing it is host bookkeeping
            n = len(sw.emitted)
            submit_t = getattr(sw.handle, "_submit_time", sw.admit_time)
            result = GenerationResult(
                request_id=request_id,
                tokens=np.concatenate([sw.request.prompt_ids,
                                       np.asarray(sw.emitted, np.int32)]),
                finish_reason="pruned",
                ttft=sw.first_token_time - submit_t,
                tpot=((now - sw.first_token_time) / (n - 1)
                      if n > 1 else None),
                queue_time=sw.admit_time - submit_t,
                admitted_step=sw.admitted_step,
                finished_step=self.step_count,
                branch=sw.branch,
                score=sw.score if sw.group is not None else None)
            self._fork_event("pruned")
            if _reqs._active:
                _reqs._ledger.on_retire(request_id,
                                        engine=self.stats.engine_label,
                                        t=now, finish_reason="pruned",
                                        tokens=n)
            _trace.event("serve/prune", cat="serve", request=request_id,
                         slot=None, tokens=n)
            sw.handle._finish(result)
            self.stats.on_complete(result)
            del self._swapped[j]
            self._handles.pop(request_id, None)
            return
        raise ValueError(
            f"{request_id}: not a live or swapped request; prune() cuts a "
            f"decoding branch (queued requests expire by deadline, finished "
            f"ones are already sealed)")

    # -- KV shipping (serve/fleet.py's disaggregated prefill) -------------
    # A prefill replica builds a prompt's full-block prefix in canonical
    # chunk form (the bytes a chunked admission computes), exports it as a
    # narrow host image, and a decode replica adopts the image's blocks
    # into its own radix tree, so the request's admission there is a
    # local warm hit.

    def _require_ship_support(self):
        self._check_open()
        if self.paged_arena is None or self.prefix_cache is None:
            raise RuntimeError(
                "KV shipping needs paged= and prefix_cache= on every "
                "replica: the ship format is the paged host image and "
                "residency lives in the radix tree")

    def start_prefix_build(self, prompt_ids):
        """Begin building the shippable prefix of ``prompt_ids``: its
        ``(plen - 1) // block_size`` full blocks (the last, partial block
        is recomputed by the admitting engine, which samples from it).
        Returns a :class:`_PrefixJob`, or None when nothing is shippable.
        A prefix already in this engine's tree starts complete (``hit``);
        the matched path is acquired until the job is exported or
        abandoned."""
        self._require_ship_support()
        arena, cache = self.paged_arena, self.prefix_cache
        B = arena.block_size
        toks = np.asarray(prompt_ids, np.int32).reshape(-1)
        plen = len(toks)
        n_goal = (plen - 1) // B
        if n_goal < 1:
            return None
        job = _PrefixJob()
        job.tokens, job.plen, job.n_goal, job.engine = toks, plen, n_goal, \
            self
        nodes = cache.lookup(toks)[:n_goal]
        cache.acquire(nodes)
        job.nodes = nodes
        job.hit = len(nodes) == n_goal
        job.off = len(nodes) * B
        job.last_off = (n_goal - 1) * B
        job.ids = job.kc_row = job.vc_row = None
        if job.hit:
            return job
        try:
            # the row of the request's own chunked admission (its width
            # too), so the shipped blocks are the bytes a cold chunked
            # admission on the destination would compute
            width = n_goal * B + B
            ids = np.zeros(width, np.int64)
            ids[:plen] = toks
            job.ids = torch.as_tensor(ids, device=self._params["wte"].device)
            job.kc_row, job.vc_row = cache.copy_into_row(
                [n.block for n in nodes], width)
        except Exception:
            self.abandon_prefix_build(job)
            raise
        return job

    def advance_prefix_build(self, job, max_tokens=None, rid=None):
        """Spend up to ``max_tokens`` prefill tokens on the build's chunk
        passes (None: finish it).  Returns True once the build is
        complete.  A raising chunk fails the engine typed, as a raising
        admission prefill inside ``step()`` does."""
        self._require_ship_support()
        if job.engine is not self:
            raise RuntimeError(
                "stale prefix build: the engine was rebuilt under it; "
                "restart the build")
        B = self.paged_arena.block_size
        left = (job.last_off - job.off + B if max_tokens is None
                else int(max_tokens))
        quantum = (_stepprof.begin_quantum(self.stats.engine_label,
                                           step=self.step_count)
                   if _stepprof._active else False)
        try:
            while left >= B and job.off <= job.last_off:
                if _faults._armed:
                    _faults.check("serve.prefill_chunk")
                off = job.off
                self._x.chunk_row(self._params, job.ids, job.kc_row,
                                  job.vc_row, off, B)
                job.off += B
                left -= B
                if _reqs._active and rid is not None:
                    _reqs._ledger.on_prefill_chunk(
                        rid, engine=self.stats.engine_label,
                        t=self._clock(), offset=off)
        except Exception as e:
            if quantum:
                _stepprof.abort()
            self.abandon_prefix_build(job)
            raise self._fail(e) from e
        if quantum:
            _stepprof.end()
        return job.off > job.last_off

    def abandon_prefix_build(self, job):
        """Release a build's acquired prefix (a ship's fallback, a
        failover, a raising chunk).  Idempotent; a no-op for a job whose
        engine was rebuilt (its tree went with it)."""
        if job.nodes and self.prefix_cache is not None \
                and job.engine is self:
            try:
                self.prefix_cache.release(job.nodes)
            except RuntimeError:
                pass
        job.nodes = []

    def export_prefix_image(self, job):
        """The source half of a ship: donate the finished row's blocks
        into this engine's tree (the next request for this prefix exports
        without a recompute) and pack the narrow host image (the
        ``serve.kv_ship`` fault site).  Under pool pressure the donation
        is skipped (counted) and the image ships from the row.  Returns
        ``(image, resident)``, ``resident`` whether this tree now holds
        the prefix.  Releases the job's references in every case."""
        self._require_ship_support()
        if job.engine is not self:
            raise RuntimeError(
                "stale prefix build: the engine was rebuilt under it; "
                "restart the build")
        arena, cache = self.paged_arena, self.prefix_cache
        n = job.n_goal
        try:
            if job.hit:
                return arena.export_image([nd.block for nd in job.nodes],
                                          n), True
            k = len(job.nodes)
            new = arena.alloc(n - k)
            if new is None:
                cache.on_donate_skipped(n - k)
                return arena.export_row_image(job.kc_row, job.vc_row,
                                              n), False
            try:
                arena.scatter_row(job.kc_row, job.vc_row,
                                  {k + j: b for j, b in enumerate(new)})
                blockmap = [nd.block for nd in job.nodes] + new
                path = cache.adopt_blocks(job.tokens, blockmap, n)
            except Exception:
                arena.free(new)
                raise
            adopted = {nd.block for nd in path}
            arena.free([b for b in new if b not in adopted])
            return arena.export_image([nd.block for nd in path], n), True
        finally:
            self.abandon_prefix_build(job)

    def admit_prefix_image(self, tokens, image):
        """The destination half of a ship: validate the image (a typed
        :class:`~singa_tpu_torch.serve.kvimage.KVImageError` before
        anything scatters), land its lanes in this pool and adopt them
        into the tree, so the next admission of ``tokens`` is a local
        warm hit.  Returns the acquired node path (the caller releases
        it once the shipped request resolves), or None when the pool has
        no room for the missing blocks (a cold fallback)."""
        self._require_ship_support()
        arena, cache = self.paged_arena, self.prefix_cache
        toks = np.asarray(tokens, np.int32).reshape(-1)
        n = int(image.n_data)
        existing = cache.lookup(toks)[:n]
        k = len(existing)
        if k == n:
            image.validate(arena.block_size, arena.quant,
                           pool_k=arena.pool_k)
            cache.touch(existing)
            cache.acquire(existing)
            return existing
        # pinned across the allocation: its eviction must not take the
        # prefix being extended
        cache.acquire(existing)
        new = arena.alloc(n - k)
        if new is None:
            cache.release(existing)
            return None
        try:
            arena.import_image(image, {k + j: b for j, b in enumerate(new)})
            path = cache.adopt_blocks(
                toks, [nd.block for nd in existing] + new, n)
        except Exception:
            arena.free(new)
            cache.release(existing)
            raise
        adopted = {nd.block for nd in path}
        arena.free([b for b in new if b not in adopted])
        cache.release(existing)
        cache.acquire(path)
        return path
