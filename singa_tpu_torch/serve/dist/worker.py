"""Replica worker: one supervised serve engine behind the framed RPC
loop (counterpart of ``singa_tpu/serve/dist/worker.py``).

A worker is ONE replica of a :class:`~singa_tpu_torch.serve.dist.DistFleet`
living in its own process (``multiprocessing`` spawn for tests/CI —
or, degenerately, a thread: same sockets, same framing, same
serialization, minus process isolation, which is what keeps the tier-1
tests fast).  It dials back to the fleet's listener, handshakes, then
serves a strictly serial command loop: every fleet-side
``RemoteSupervisor`` call is one ``CALL`` frame here, dispatched to
the REAL :class:`~singa_tpu_torch.serve.supervisor.EngineSupervisor` the
worker hosts.  Exceptions cross the wire as typed descriptions —
``EngineFailedError.started`` survives serialization, because the
fleet's requeue-safety decision hangs on it.

The worker builds its model from a :class:`ModelSpec` shipped in the
INIT call: an importable factory plus the fleet's weight state dict
(numpy), so worker weights are BYTE-IDENTICAL to the fleet's and token
streams match the single-process fleet exactly (two independently
initialized models would not — parameter init is random).  The spec
names the device too: a worker builds on the card unless the spec says
``"cpu"``, and raises when it names the card and the worker has none.
In its own process a worker keeps its own kernel launch counts and
captured decode steps; ``telemetry`` pulls return the counts.

Streamed KV shipping: a ship build advancing here returns, with each
``build_advance`` reply, the newly completed lanes of the canonical
chunk row sliced PER LAYER (``(leaf, layer, lane_lo, lane_hi,
bytes)``).  Canonical prefill KV is append-only and invariant — the
warm==cold pin's foundation — so lanes copied out mid-build are
byte-equal to the final exported image's slices, and the destination
can stage them while the source is still prefilling later chunks.
The destination half (``ship_begin``/``ship_frame`` one-ways, then a
``ship_commit`` call) assembles the staged slices, seals them into a
:class:`~singa_tpu_torch.serve.kvimage.KVImage` with the source's pack-time
header and crc32, and admits through the same typed validation as any
other image: a missing or corrupted frame is a checksum mismatch —
cold fallback, never a wrong token.
"""

from __future__ import annotations

import itertools
import os
import random
import threading
import time

import numpy as np
import torch

from .transport import (PeerGoneError, StaleEpochError, TransportError,
                        _full_jitter, connect_worker, resume_worker)
from .transport import MSG_CALL, MSG_ONEWAY, MSG_REPLY
from ...models.gpt2_decode import _leaves as leaf_list
from ..kvimage import (_FROM_WIRE, _WIRE_DTYPES, KVIMAGE_VERSION, KVImage,
                       KVImageError)
from ..request import (DeadlineExceededError, EngineFailedError,
                       FleetDownError, GenerationRequest, LoadShedError,
                       QueueFullError, RestartBudgetExceededError)

__all__ = ["ModelSpec", "gpt2_factory", "gpt2_spec", "worker_main"]


# -- error / request / result wire forms --------------------------------
#: typed errors that reconstruct to their own class on the fleet side;
#: anything else degrades to RuntimeError with the original repr
_ERR_TYPES = {
    c.__name__: c for c in (
        QueueFullError, DeadlineExceededError, EngineFailedError,
        RestartBudgetExceededError, FleetDownError, LoadShedError,
        KVImageError, StaleEpochError, ValueError, RuntimeError)}


def dump_exc(e) -> dict:
    return {"type": type(e).__name__, "msg": str(e),
            "request_id": getattr(e, "request_id", None),
            "started": getattr(e, "started", None),
            "engine_step": getattr(e, "engine_step", None)}


def load_exc(d):
    cls = _ERR_TYPES.get(d["type"])
    if cls is None:
        return RuntimeError(f"[worker {d['type']}] {d['msg']}")
    if issubclass(cls, EngineFailedError):
        return cls(d["msg"], request_id=d.get("request_id"),
                   started=d.get("started"),
                   engine_step=d.get("engine_step"))
    return cls(d["msg"])


def dump_request(req, clock) -> dict:
    """Request fields a worker rebuilds a GenerationRequest from.
    ``deadline`` is absolute on the SENDER's clock — it crosses the
    wire as a remaining-time delta and re-anchors on the worker's
    clock (the two processes share no clock base)."""
    return {
        "prompt_ids": np.asarray(req.prompt_ids, np.int32),
        "max_new_tokens": req.max_new_tokens,
        "temperature": req.temperature, "seed": req.seed,
        "deadline_rel": (None if req.deadline is None
                         else req.deadline - clock()),
        "priority": req.priority, "pin_session": req.pin_session,
        "stop_token": req.stop_token, "request_id": req.request_id,
        "stream": req.on_token is not None,
    }


def load_request(d, on_token=None, clock=time.monotonic):
    return GenerationRequest(
        prompt_ids=d["prompt_ids"],
        max_new_tokens=d["max_new_tokens"],
        temperature=d["temperature"], seed=d["seed"],
        deadline=(None if d["deadline_rel"] is None
                  else clock() + d["deadline_rel"]),
        on_token=on_token, priority=d["priority"],
        pin_session=d["pin_session"], stop_token=d["stop_token"],
        request_id=d["request_id"])


class ModelSpec:
    """Picklable recipe for the worker's model: an importable
    ``factory(**factory_kw)`` returning an UNcompiled model, the
    compile probe length, the weight state dict (numpy) captured
    from the fleet-side model — shipping states is what makes worker
    weights byte-identical to the fleet's — and the ``device`` it runs
    on (``"cuda"``, ``"cuda:<i>"`` or ``"cpu"``).  The factory must be
    one the wire decodes (``serve/dist/transport.py`` ``_WIRE_GLOBALS``:
    :func:`gpt2_factory`)."""

    def __init__(self, factory, factory_kw=None, states=None,
                 compile_len=16, device="cuda"):
        self.factory = factory
        self.factory_kw = dict(factory_kw or {})
        self.states = states
        self.compile_len = int(compile_len)
        self.device = str(device)

    def build(self):
        """The compiled model with the spec's weights on the spec's
        device; a spec that names the card raises where there is none."""
        from ... import tensor

        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"ModelSpec names {self.device!r} but this worker has no "
                f"CUDA device: build the spec with device='cpu' to serve "
                f"on the CPU")
        m = self.factory(**self.factory_kw)
        m.compile([tensor.from_numpy(
            np.zeros((1, self.compile_len), np.int32), dev)],
            is_train=False)
        if self.states:
            m.set_states(self.states)
        return m


def gpt2_factory(cfg):
    from ...models.gpt2 import GPT2LMHead

    return GPT2LMHead(cfg)


def gpt2_spec(model, compile_len=16) -> ModelSpec:
    """Spec for a compiled fleet-side GPT2LMHead: same config, same
    weights, same device."""
    from ... import tensor

    states = {n: tensor.to_numpy(t)
              for n, t in model.get_states().items()}
    return ModelSpec(gpt2_factory, {"cfg": model.cfg}, states,
                     compile_len=compile_len,
                     device=model.transformer.wte.W.device)


def _raw(t) -> bytes:
    """The raw bytes of a (possibly device) tensor slice, host side."""
    return t.contiguous().cpu().reshape(-1).view(torch.uint8).numpy() \
        .tobytes()


#: one worker op at a time in a process: the worker threads of a
#: thread-mode fleet share the process's CUDA context, the kernel launch
#: counts a capture records (graphs.py) and torch.cuda.graph's default
#: capture stream, so a decode step captured in one thread must not see
#: another thread's launches.  A worker process holds it alone.
_OPS = threading.Lock()


# -- the worker loop -----------------------------------------------------
class _Worker:
    def __init__(self, conn, clock=time.monotonic, redial=None):
        self.conn = conn
        self.sup = None
        self._clock = clock
        self._handles = {}     # rid -> (handle, request)
        self._tokens = []      # (rid, token) streamed since last step
        self._jobs = {}        # job_id -> [PrefixJob, lanes_sent]
        self._paths = {}       # path_id -> acquired radix node path
        self._sessions = {}    # sid -> SessionHandle
        self._staged = {}      # ship_id -> (meta, leaf buffers)
        self._ids = itertools.count(1)
        self._stop = False
        self._led = None       # this process's RequestLedger (federate)
        # -- controller-survivability state --------------------------
        #: (host, port, token, idx) to redial on socket loss; None
        #: disables reconnect (legacy / test harness direct conns)
        self._redial = redial
        #: fencing epoch last obeyed — frames stamped with an OLDER
        #: epoch come from a deposed controller and are refused typed
        self._epoch = 0
        #: single-entry reply cache: the strictly serial protocol
        #: means at most ONE reply can be in flight, so caching the
        #: last (seq, reply) gives exactly-once call semantics across
        #: a reconnect — a replayed seq answers from memory without
        #: re-executing
        self._last_seq = 0
        self._last_reply = None
        #: (reply_seq, [rids]) whose terminal results rode the reply
        #: — deleted from the journal once a STRICTLY NEWER call
        #: proves the controller received it (piggybacked ack)
        self._unacked = None
        #: rid -> {state, req, cursor, order, out, t} — the request
        #: journal an adopting controller reconciles against.  States:
        #: live (queued or decoding), resolved (handle done, result
        #: still on the handle), done (result drained into ``out``,
        #: awaiting ack), expired (TTL tombstone)
        self._journal = {}
        self._arrival = itertools.count(1)
        self._park_ttl = 60.0
        self._journal_cap = 256
        self._reconnect_attempts = 20
        self._backoff_base = 0.1
        self._backoff_cap = 2.0
        self._redial_timeout = 5.0
        self._rng = random.Random()

    # engine-side streaming callback: tokens ride the next step reply
    def _on_token(self, req, tok):
        self._tokens.append((req.request_id, int(tok)))
        ent = self._journal.get(req.request_id)
        if ent is not None:
            # the emitted-token cursor: how far this request's stream
            # has progressed — an adopting controller reads it to tell
            # started work (cursor > 0: not safely re-runnable) from
            # never-started
            ent["cursor"] += 1

    @property
    def _eng(self):
        return self.sup.engine

    def _view(self) -> dict:
        eng = self._eng
        if eng._closed or eng._failed:
            return {"queue_depth": 0, "live_slots": 0,
                    "tpot_ewma": None, "blocks_used": None,
                    "cached_blocks": None,
                    "live_rids": [], "restarts": self.sup.restarts}
        arena = eng.paged_arena
        cache = eng.prefix_cache
        return {
            "queue_depth": eng.scheduler.queue_depth,
            "live_slots": eng.live_slots,
            "tpot_ewma": eng.stats.tpot_ewma,
            "blocks_used": (arena.blocks_used
                            if arena is not None else None),
            "cached_blocks": (cache.cached_blocks
                              if cache is not None else None),
            "live_rids": sorted(eng.live_request_ids),
            "restarts": self.sup.restarts,
        }

    def _dump_result(self, res) -> dict:
        d = {"request_id": res.request_id,
             "tokens": np.asarray(res.tokens),
             "finish_reason": res.finish_reason, "ttft": res.ttft,
             "tpot": res.tpot, "queue_time": res.queue_time,
             "admitted_step": res.admitted_step,
             "finished_step": res.finished_step, "session": None}
        if res.session is not None:
            sid = f"s{next(self._ids)}"
            self._sessions[sid] = res.session
            d["session"] = {"sid": sid,
                            "tokens": np.asarray(res.session.tokens)}
        return d

    def _drain_resolved(self) -> dict:
        out = {}
        for rid in list(self._handles):
            h, _req = self._handles[rid]
            if not h.done():
                continue
            del self._handles[rid]
            if h._error is not None:
                out[rid] = {"err": dump_exc(h._error)}
            else:
                out[rid] = {"result": self._dump_result(h._result)}
            ent = self._journal.get(rid)
            if ent is not None:
                # drained into a reply: journal the terminal result
                # until a newer call acks the reply (or the TTL fires)
                ent["state"] = "done"
                ent["out"] = out[rid]
                ent["t"] = self._clock()
        return out

    # -- journal maintenance ---------------------------------------------
    def _stamp_resolved(self):
        """Mark journal entries whose handle finished as ``resolved``.
        The result deliberately STAYS on the handle: if the same
        controller resumes, the next ``op_step``'s normal drain
        delivers it; only an adopting controller claims it out of the
        journal."""
        for rid, (h, _req) in list(self._handles.items()):
            if not h.done():
                continue
            ent = self._journal.get(rid)
            if ent is not None and ent["state"] == "live":
                ent["state"] = "resolved"
                ent["t"] = self._clock()

    def _sweep_journal(self):
        """Expire parked results past their TTL: the result is dropped
        (nobody came back for it) and a tombstone remains so a late
        adopter gets a typed ``expired`` verdict instead of silence."""
        now = self._clock()
        for rid in list(self._journal):
            ent = self._journal[rid]
            if ent["state"] in ("resolved", "done") \
                    and now - ent["t"] > self._park_ttl:
                self._handles.pop(rid, None)
                self._journal[rid] = {
                    "state": "expired", "req": None, "out": None,
                    "cursor": ent["cursor"], "order": ent["order"],
                    "t": now}

    def _trim_journal(self):
        """Bound the journal: evict the oldest non-live entries past
        the cap (live entries are already bounded by the engine's own
        admission control, so eviction always terminates)."""
        while len(self._journal) > self._journal_cap:
            victim = next((rid for rid, ent in self._journal.items()
                           if ent["state"] != "live"), None)
            if victim is None:
                break
            del self._journal[victim]

    # -- op handlers -----------------------------------------------------
    def op_init(self, p):
        from ..supervisor import EngineSupervisor

        model = p["spec"].build()
        self.sup = EngineSupervisor(model, **p["sup_kw"],
                                    **p["engine_kw"])
        # federation flags arrive ONLY in process mode: this process's
        # observe globals are private, so enabling the ledger/trace
        # here cannot clobber the fleet's own (in thread mode they are
        # the SAME globals — the fleet never sends the flags there)
        fed = p.get("federate") or {}
        if fed.get("ledger"):
            from ...observe import requests as _w_reqs
            self._led = _w_reqs.enable(
                capacity=int(fed.get("capacity", 4096)))
        if fed.get("trace"):
            from ...observe import trace as _w_trace
            # align the trace clock with the ledger/probe clock so one
            # per-host offset corrects every shipped timestamp
            _w_trace.enable(clock=self._clock)
        if fed.get("stepprof"):
            from ...observe import stepprof as _w_stepprof
            # per-step host/device anatomy: the profiler's trace
            # records (cat step.host/step.device) ride the trace
            # shipping above, so the controller's merged Chrome trace
            # grows dual per-host step lanes for free; the probe clock
            # keeps them on the same correctable time base
            _w_stepprof.enable(clock=self._clock)
        if "epoch" in p:
            self._epoch = int(p["epoch"])
        rec = p.get("recover") or {}
        self._park_ttl = float(rec.get("park_ttl", self._park_ttl))
        self._journal_cap = int(rec.get("journal_cap",
                                        self._journal_cap))
        self._reconnect_attempts = int(rec.get(
            "attempts", self._reconnect_attempts))
        self._backoff_base = float(rec.get("base",
                                           self._backoff_base))
        self._backoff_cap = float(rec.get("cap", self._backoff_cap))
        return self._ack()

    def _ack(self) -> dict:
        """The engine-description dict the controller sizes its
        RemoteSupervisor from — returned by INIT at first build and by
        ``describe`` when an adopting controller attaches to an
        already-built worker."""
        eng = self.sup.engine
        arena = eng.paged_arena
        return {
            "max_slots": eng.max_slots, "max_len": eng.max_len,
            "budget": eng._budget,
            "engine_label": eng.stats.engine_label,
            "max_queue_depth": int(getattr(
                eng.scheduler, "max_queue_depth", 64) or 64),
            "has_arena": arena is not None,
            "has_cache": eng.prefix_cache is not None,
            "block_size": (arena.block_size
                           if arena is not None else None),
            "num_blocks": (arena.num_blocks
                           if arena is not None else None),
            "quant": arena.quant if arena is not None else None,
            "pid": os.getpid(),
        }

    def op_describe(self, p):
        """Adoption probe: re-describe the live engine to a controller
        that did not build it (and therefore never saw the INIT ack)."""
        return self._ack()

    def op_submit(self, p):
        d = p["request"]
        req = load_request(
            d, on_token=self._on_token if d["stream"] else None,
            clock=self._clock)
        h = self.sup.submit(req)
        self._handles[req.request_id] = (h, req)
        self._journal[req.request_id] = {
            "state": "live", "req": d, "cursor": 0,
            "order": next(self._arrival), "out": None,
            "t": self._clock()}
        self._trim_journal()
        return {"view": self._view()}

    def op_validate(self, p):
        req = load_request(p["request"], clock=self._clock)
        self._eng.validate_request(req)
        return {}

    def op_step(self, p):
        budget = None
        try:
            if self.sup.pending:
                self.sup.step()
        except RestartBudgetExceededError as e:
            budget = dump_exc(e)
        toks, self._tokens = self._tokens, []
        return {"resolved": self._drain_resolved(), "tokens": toks,
                "view": self._view(), "budget": budget}

    def op_abandon(self, p):
        try:
            self.sup.abandon(p.get("reason", "fleet failover"))
        except RestartBudgetExceededError:
            pass
        toks, self._tokens = self._tokens, []
        return {"resolved": self._drain_resolved(), "tokens": toks}

    def op_build_start(self, p):
        job = self.sup.start_prefix_build(p["prompt_ids"])
        if job is None:
            return {"job_id": None}
        jid = f"j{next(self._ids)}"
        self._jobs[jid] = [job, 0]
        meta = None
        if p.get("stream") and not job.hit:
            B = self._eng.paged_arena.block_size
            w = job.n_goal * B
            leaves = leaf_list(job.kc_row) + leaf_list(job.vc_row)
            meta = {
                "k_leaves": len(leaf_list(job.kc_row)),
                "n_data": job.n_goal, "block_size": B,
                "quant": self._eng.paged_arena.quant,
                # narrow staging shapes: lane axis cut to the shipped
                # width (the exported image's exact geometry)
                "leaves": [(tuple(a.shape[:3]) + (w,)
                            + tuple(a.shape[4:]), _WIRE_DTYPES[a.dtype])
                           for a in leaves],
            }
        return {"job_id": jid, "hit": job.hit, "n_goal": job.n_goal,
                "stream_meta": meta}

    def _slice_frames(self, job, lo, hi):
        """Per-(leaf, layer) lane slices [lo, hi) of the build row —
        the streamed ship's wire granularity.  Canonical chunk KV is
        append-only, so these bytes equal the final image's."""
        frames = []
        leaves = leaf_list(job.kc_row) + leaf_list(job.vc_row)
        for li, leaf in enumerate(leaves):
            L = leaf.shape[0]
            for layer in range(L):
                arr = _raw(leaf[layer:layer + 1, :, :, lo:hi])
                frames.append((li, layer, lo, hi, arr))
        return frames

    def op_build_advance(self, p):
        ent = self._jobs.get(p["job_id"])
        if ent is None:
            return {"status": "rebuilt", "frames": []}
        job, sent = ent
        done = self.sup.advance_prefix_build(job, p["budget"],
                                             rid=p.get("rid"))
        if done is None:
            # the engine died mid-chunk and the supervisor rebuilt it:
            # the job's rows belong to the dead engine — drop it
            del self._jobs[p["job_id"]]
            return {"status": "rebuilt", "frames": []}
        frames = []
        if p.get("stream") and not job.hit:
            B = self._eng.paged_arena.block_size
            hi = min(job.off, job.n_goal * B)
            if hi > sent:
                frames = self._slice_frames(job, sent, hi)
                ent[1] = hi
        return {"status": "done" if done else "more",
                "frames": frames}

    def op_build_export(self, p):
        job, _ = self._jobs.pop(p["job_id"])
        image, resident = self.sup.export_prefix_image(job)
        return {"image": image.to_bytes(), "resident": resident}

    def op_build_export_meta(self, p):
        """Streamed-ship export: the lanes already crossed the wire as
        frames; only the image's identity (header + crc + geometry)
        and the source-residency verdict travel here."""
        job, _ = self._jobs.pop(p["job_id"])
        image, resident = self.sup.export_prefix_image(job)
        return {"meta": {
                    "header": image.header, "checksum": image.checksum,
                    "n_data": image.n_data,
                    "block_size": image.block_size,
                    "quant": image.quant, "nbytes": image.nbytes,
                    "k_leaves": len(leaf_list(image.kc))},
                "resident": resident}

    def op_build_abandon(self, p):
        ent = self._jobs.pop(p["job_id"], None)
        if ent is not None:
            self.sup.abandon_prefix_build(ent[0])
        return {}

    def op_admit_image(self, p):
        image = KVImage.from_bytes(p["image"])
        path = self.sup.admit_prefix_image(p["tokens"], image)
        if path is None:
            return {"path": None}
        pid = f"p{next(self._ids)}"
        self._paths[pid] = path
        return {"path": pid}

    def op_ship_begin(self, p):
        bufs = [torch.zeros(shape, dtype=_FROM_WIRE[dtype])
                for shape, dtype in p["meta"]["leaves"]]
        self._staged[p["ship_id"]] = (p["meta"], bufs)

    def op_ship_frame(self, p):
        ent = self._staged.get(p["ship_id"])
        if ent is None:
            return  # aborted or unknown: drop (commit will fail typed)
        _meta, bufs = ent
        li, layer, lo, hi = p["leaf"], p["layer"], p["lo"], p["hi"]
        dst = bufs[li][layer:layer + 1, :, :, lo:hi]
        dst.copy_(torch.frombuffer(bytearray(p["bytes"]), dtype=torch.uint8)
                  .view(dst.dtype).reshape(dst.shape))

    def op_ship_abort(self, p):
        self._staged.pop(p["ship_id"], None)

    def op_ship_commit(self, p):
        ent = self._staged.pop(p["ship_id"], None)
        if ent is None:
            return {"path": None, "reason": "no_staging"}
        meta, bufs = ent
        k = p["k_leaves"]

        def tree(ls):
            return ls[0] if len(ls) == 1 else tuple(ls)

        image = KVImage(KVIMAGE_VERSION, p["block_size"], p["n_data"],
                        p["quant"], p["header"], tree(bufs[:k]),
                        tree(bufs[k:]), checksum=p["checksum"])
        # admit runs the full typed validation (geometry + header +
        # crc32): a half-shipped or bit-flipped staging fails HERE and
        # the fleet replays the request cold — never a wrong token
        path = self.sup.admit_prefix_image(p["tokens"], image)
        if path is None:
            return {"path": None, "reason": "capacity"}
        pid = f"p{next(self._ids)}"
        self._paths[pid] = path
        return {"path": pid}

    def op_prefix_lookup(self, p):
        eng = self._eng
        if (eng._closed or eng._failed
                or eng.prefix_cache is None):
            return {"n": 0}
        return {"n": len(eng.prefix_cache.lookup(p["tokens"]))}

    def op_cache_release(self, p):
        path = self._paths.pop(p["path"], None)
        if path is not None:
            try:
                self._eng.prefix_cache.release(path)
            except (RuntimeError, AttributeError):
                pass  # engine rebuilt under the pin: stale path
        return {}

    def op_session_release(self, p):
        sess = self._sessions.pop(p["sid"], None)
        if sess is not None:
            try:
                sess.release()
            except RuntimeError:
                pass
        return {}

    def op_snapshot(self, p):
        return {"stats": self._eng.stats.snapshot()}

    def op_ping(self, p):
        return {}

    def op_clock(self, p):
        """NTP-style probe target: the worker's monotonic now.  The
        fleet brackets this reply with its own clock reads to estimate
        the peer offset (error bounded by RTT/2)."""
        return {"t": self._clock()}

    def op_telemetry(self, p):
        """Telemetry pull: registry dump, sealed ledger entries and
        (optionally drained) trace events, each gated by a request
        flag.  Read-only over observe state — never touches the
        engine, so a pull can never wedge serving."""
        out = {"clock": self._clock(), "pid": os.getpid()}
        if p.get("registry"):
            from ...observe.registry import registry as _w_registry
            out["registry"] = _w_registry().dump()
        if p.get("ledger") and self._led is not None:
            out["ledger"] = self._led.entries()
        if p.get("trace"):
            from ...observe import trace as _w_trace
            if _w_trace.is_enabled():
                out["trace"] = (_w_trace.drain() if p.get("drain")
                                else _w_trace.events())
        if p.get("jit"):
            from ..jitpin import jit_cache_size
            out["jit_cache"] = jit_cache_size()
        if p.get("kernels"):
            # this process's kernel launch counts: captured replays
            # credit theirs (graphs.py), so they count every launch
            from ...graphs import launch_counters
            out["kernels"] = {f"{fn.__name__}.{attr}": getattr(fn, attr)
                              for fn, attr in launch_counters()}
        return out

    def op_reconcile(self, p):
        """Adoption inventory: per journaled request, its state (live
        / parked / expired), token cursor, arrival order, and — for
        live work — the original wire request (so the adopter can
        rebuild its fleet-side handle or requeue).  Parked = a
        terminal result is being held for exactly-once claim."""
        self._stamp_resolved()
        self._sweep_journal()
        out = {}
        for rid, ent in self._journal.items():
            st = ent["state"]
            if st in ("resolved", "done"):
                st = "parked"
            out[rid] = {"state": st, "cursor": ent["cursor"],
                        "order": ent["order"],
                        "req": ent["req"] if st == "live" else None}
        return {"requests": out, "epoch": self._epoch}

    def op_claim(self, p):
        """Hand a PARKED terminal result to an adopting controller and
        forget it — exactly-once: the journal entry is deleted on
        claim, and a lost reply is covered by the seq-dedupe cache
        (the resend answers from memory, never re-executes)."""
        rid = p["rid"]
        self._stamp_resolved()
        ent = self._journal.get(rid)
        if ent is None:
            return {"status": "gone"}
        if ent["state"] == "expired":
            return {"status": "expired", "cursor": ent["cursor"]}
        if ent["state"] == "live":
            return {"status": "live"}
        out = ent["out"]
        if out is None:
            h, _req = self._handles.pop(rid)
            if h._error is not None:
                out = {"err": dump_exc(h._error)}
            else:
                out = {"result": self._dump_result(h._result)}
        else:
            self._handles.pop(rid, None)
        del self._journal[rid]
        # the claimed result carries the FULL token array; drop any
        # streamed-token backlog for this rid so it cannot ride a
        # later step reply into a controller that never submitted it
        self._tokens = [(r, t) for r, t in self._tokens if r != rid]
        return {"status": "parked", "out": out, "req": ent["req"],
                "cursor": ent["cursor"], "order": ent["order"]}

    def op_die(self, p):
        """Chaos/kill hook (one-way): stop WITHOUT redialing — a
        deliberately killed worker must stay dead, so thread-mode
        ``kill_worker`` sends this before closing its socket end
        (TCP ordering lands it ahead of the FIN)."""
        self._stop = True
        try:
            self.conn.close()
        except Exception:
            pass

    def op_shutdown(self, p):
        self._stop = True
        if self.sup is not None:
            try:
                self.sup.close(force=p.get("force", True))
            except Exception:
                pass
        return {}

    # -- disconnected mode ----------------------------------------------
    def _park_pass(self):
        """One disconnected-mode pass: keep stepping live work (a
        controller blip must never wedge decode mid-request), stamp
        newly finished handles ``resolved`` (results stay ON the
        handle so a same-controller resume drains them through the
        normal step reply), and sweep the park TTL."""
        if self.sup is not None:
            try:
                with _OPS:
                    if self.sup.pending:
                        self.sup.step()
            except Exception:
                pass  # budget exhaustion resolves handles typed
        self._stamp_resolved()
        self._sweep_journal()

    def _reconnect(self) -> bool:
        """Bounded reconnect window: redial the controller address
        with full-jitter backoff, offering to RESUME this session
        (epoch + last executed seq).  Between attempts the engine
        keeps stepping (``_park_pass``).  Returns True with
        ``self.conn`` swapped on success; False when the budget is
        spent or the controller refuses (worker then dies and the
        fleet's failover owns the requests)."""
        host, port, token, idx = self._redial
        try:
            self.conn.close()
        except Exception:
            pass
        for attempt in range(self._reconnect_attempts):
            self._park_pass()
            try:
                conn, ack = resume_worker(
                    host, port, token, idx, self._epoch,
                    self._last_seq, timeout=self._redial_timeout)
            except (OSError, PeerGoneError, TransportError):
                time.sleep(_full_jitter(
                    self._rng, self._backoff_base, attempt,
                    self._backoff_cap))
                continue
            if not ack.get("ok") \
                    or ack.get("epoch", -1) < self._epoch:
                # an explicit refusal, or a controller offering an
                # OLDER epoch (the stale side of a split brain —
                # never downgrade the fence)
                conn.close()
                return False
            self._epoch = int(ack["epoch"])
            self.conn = conn
            return True
        return False

    def _lost_controller(self) -> bool:
        """Socket loss: True means give up (stop requested, reconnect
        disabled, or the redial budget spent)."""
        return (self._stop or self._redial is None
                or not self._reconnect())

    # -- loop ------------------------------------------------------------
    def run(self):
        while not self._stop:
            try:
                kind, msg = self.conn.recv(timeout=None)
            except (PeerGoneError, TransportError):
                if self._lost_controller():
                    break
                continue
            op = msg.get("op", "")
            # fencing: frames stamped with an epoch OLDER than the one
            # this worker last obeyed come from a deposed controller.
            # CALLs are refused typed (StaleEpochError crosses the
            # wire); one-ways are dropped — checked BEFORE dispatch so
            # every op is fenced by construction.
            ep = msg.get("epoch")
            if ep is not None and ep < self._epoch:
                if kind == MSG_CALL:
                    reply = {"seq": msg.get("seq"), "ok": False,
                             "err": dump_exc(StaleEpochError(
                                 f"epoch {ep} < fleet epoch "
                                 f"{self._epoch}: controller is "
                                 f"stale; op {op!r} refused"))}
                    try:
                        self.conn.send(MSG_REPLY, reply)
                    except PeerGoneError:
                        if self._lost_controller():
                            break
                continue
            handler = getattr(self, f"op_{op}", None)
            if kind == MSG_ONEWAY:
                if handler is not None:
                    try:
                        with _OPS:
                            handler(msg.get("payload") or {})
                    except Exception:
                        pass  # one-ways are best-effort by contract
                continue
            if kind != MSG_CALL:
                continue
            seq = msg.get("seq")
            if seq == self._last_seq and self._last_reply is not None:
                # replayed seq after a resume: the call already ran,
                # only the reply was lost — answer from the cache
                # without re-executing (exactly-once)
                reply = self._last_reply
            else:
                if self._unacked is not None and seq is not None \
                        and seq > self._unacked[0]:
                    # a strictly newer call proves the reply carrying
                    # these terminal results landed: ack the journal
                    for rid in self._unacked[1]:
                        ent = self._journal.get(rid)
                        if ent is not None and ent["state"] == "done":
                            del self._journal[rid]
                    self._unacked = None
                if handler is None:
                    reply = {"seq": seq, "ok": False,
                             "err": dump_exc(
                                 RuntimeError(f"unknown op {op!r}"))}
                else:
                    try:
                        with _OPS:
                            value = handler(msg.get("payload") or {})
                        reply = {"seq": seq, "ok": True, "value": value}
                    except Exception as e:
                        reply = {"seq": seq, "ok": False,
                                 "err": dump_exc(e)}
                if seq is not None:
                    self._last_seq = seq
                    self._last_reply = reply
                if reply.get("ok") and isinstance(
                        reply.get("value"), dict):
                    rids = list((reply["value"].get("resolved")
                                 or {}).keys())
                    if rids:
                        self._unacked = (seq, rids)
            try:
                self.conn.send(MSG_REPLY, reply)
            except PeerGoneError:
                if self._lost_controller():
                    break
        # fleet gone or shutdown: release engine state (idempotent)
        if self.sup is not None and not self.sup.engine._closed:
            try:
                with _OPS:
                    self.sup.close(force=True)
            except Exception:
                pass
        self.conn.close()


def worker_main(host, port, token, idx):
    """Process (or thread) entry point: dial the fleet, serve the
    command loop until shutdown or fleet loss — transient loss enters
    the bounded reconnect window instead of dying."""
    conn = connect_worker(host, port, token, idx)
    _Worker(conn, redial=(host, port, token, idx)).run()
