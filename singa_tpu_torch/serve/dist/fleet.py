"""Multi-host serve fleet: replicas across the process boundary
(counterpart of ``singa_tpu/serve/dist/fleet.py``).

:class:`DistFleet` IS a :class:`~singa_tpu_torch.serve.fleet.ServeFleet` —
it subclasses it and overrides exactly the seams where "replica" stops
meaning "an object in this process": construction
(``_new_supervisor`` spawns a worker process and returns an RPC
proxy), the step loop (``_step_replicas`` issues every replica's step
RPC before collecting any reply, so remote engines decode
concurrently), the watchdog (idle peers get pinged instead of
heartbeat-latched), and the KV ship path (images cross the wire;
streamed ships relay per-layer frames while the source is still
prefilling).  Everything else — the Router, failover/requeue, hedging,
sessions, disaggregated roles, the Autoscaler, the soak harness — runs
UNMODIFIED on top, which is the point: the fleet surface is the same,
only the replicas moved out.

The proxy layer:

* :class:`RemoteSupervisor` duck-types
  :class:`~singa_tpu_torch.serve.supervisor.EngineSupervisor`: ``submit``
  returns a real parent-side :class:`RequestHandle` that resolves from
  step-reply deltas; the ship API (start/advance/export/admit/abandon)
  maps 1:1 onto worker RPCs.  Typed errors cross the wire and
  reconstruct to their own classes, ``started`` included — the fleet's
  requeue-safety decision depends on it;
* :class:`_RemoteEngineView` shims the handful of ``sup.engine.*``
  attributes the base fleet reads (scheduler depth, occupancy, stats,
  arena pressure, prefix-cache lookup) from cached step-reply views,
  so routing costs no extra round trips.  ``prefix_cache.lookup`` IS
  the residency directory's verify hook: it asks the remote tree over
  RPC, and a dead or partitioned host answers "no blocks" — the fleet
  prunes the stale hint and serves cold-but-correct, never a wrong
  token;
* a partitioned peer surfaces as
  :class:`~singa_tpu_torch.serve.dist.transport.PeerGoneError`, which
  subclasses ``RestartBudgetExceededError`` — every existing fleet
  failover path handles it with zero dist-specific code.  Requests
  lost to a partition are requeued iff no token was DELIVERED to the
  caller (``started=False``): same seed → same chain → the replay is
  byte-identical.

Streamed shipping (vLLM-style layer-wise KV streaming, fleet-level):
each ``build_advance`` reply carries the newly prefilled lanes sliced
per (leaf, layer); the fleet relays them to the chosen destination as
fire-and-forget ``ship_frame`` messages while the source prefills the
NEXT chunk — ship latency hides behind prefill compute, which is what
cuts the warm-TTFT floor for long documents.  The destination stages
frames in host buffers and only at ``ship_commit`` seals them into a
:class:`~singa_tpu_torch.serve.kvimage.KVImage` carrying the source's
pack-time crc32: a half-shipped or bit-flipped stream fails typed at
admit and the request replays cold.  The ``serve.dist.frame`` fault
site fires mid-relay to model exactly that.

``spawn="process"`` runs each worker under multiprocessing spawn (real
isolation — the deployment shape): each worker process opens its own
CUDA context, builds its own KV pool, captures its own decode steps and
keeps its own kernel launch counts, which come back on telemetry pulls.
``spawn="thread"`` runs the same worker loop, same sockets, same wire
format in threads of this process (fast enough for tier-1 tests, and
in-process fault sites reach the worker engines); on the card its
worker engines capture their decode steps thread-locally, so threads
that capture at once do not break each other's capture.
"""

from __future__ import annotations

import itertools
import os
import threading
import time

import numpy as np

from ...observe import federate as _federate
from ...observe import requests as _reqs
from ...observe import trace as _trace
from ...observe.federate import ClockSync, FleetTelemetry
from ...observe.timeseries import WindowRing
from ...resilience import faults as _faults
from ..fleet import ServeFleet, _Route
from ..kvimage import KVImage, KVImageError
from ..prefix import SessionHandle
from ..request import (EngineFailedError, RequestHandle,
                       RestartBudgetExceededError)
from .transport import (MSG_RESUME, Listener, PeerGoneError,
                        PeerTimeoutError, StaleEpochError,
                        TransportError)
from .worker import (ModelSpec, dump_request, load_exc, load_request,
                     worker_main)
from ..request import GenerationResult

__all__ = ["DistFleet", "RemoteSupervisor"]

_ship_ids = itertools.count(1)


class DistSession(SessionHandle):
    """Parent-side handle for a session pinned in a WORKER's radix
    tree.  Owns the host tokens (continuations build valid requests
    against any replica — cold elsewhere, warm on the sticky one);
    ``release`` unpins on the worker, best-effort (a dead worker's
    pins died with its tree)."""

    def __init__(self, tokens, sup, sid):
        super().__init__(tokens)
        self._sup = sup
        self._sid = sid

    def release(self):
        sid, self._sid = self._sid, None
        if sid is not None:
            self._sup.session_release(sid)


class _ViewSched:
    __slots__ = ("queue_depth", "max_queue_depth")

    def __init__(self, max_queue_depth):
        self.queue_depth = 0
        self.max_queue_depth = max_queue_depth


class _ViewStats:
    __slots__ = ("engine_label", "tpot_ewma", "_sup")

    def __init__(self, sup, engine_label):
        self._sup = sup
        self.engine_label = engine_label
        self.tpot_ewma = None

    def snapshot(self) -> dict:
        return self._sup._snapshot()


class _ViewArena:
    __slots__ = ("block_size", "num_blocks", "quant", "blocks_used")

    def __init__(self, block_size, num_blocks, quant):
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.quant = quant
        self.blocks_used = 0


class _ViewCache:
    """The remote radix tree, seen through its two fleet-facing verbs.
    ``lookup`` is the residency directory's verify hook: a partitioned
    or dead peer answers as if it held NOTHING, so the fleet prunes
    the stale hint and degrades cold-but-correct."""

    __slots__ = ("_sup", "cached_blocks")

    def __init__(self, sup):
        self._sup = sup
        self.cached_blocks = 0

    def lookup(self, tokens):
        return [True] * self._sup._prefix_lookup(tokens)

    def release(self, path_id):
        self._sup._cache_release(path_id)


class _RemoteEngineView:
    """The ``sup.engine`` surface the base fleet reads, backed by
    init-ack statics and cached step-reply load samples — routing
    never pays a round trip."""

    def __init__(self, sup, ack):
        self._sup = sup
        self.max_slots = ack["max_slots"]
        self.max_len = ack["max_len"]
        self._budget = ack["budget"]
        self.scheduler = _ViewSched(ack["max_queue_depth"])
        self.stats = _ViewStats(sup, f"r{sup._idx}:"
                                     f"{ack['engine_label']}")
        self.paged_arena = (_ViewArena(ack["block_size"],
                                       ack["num_blocks"],
                                       ack["quant"])
                            if ack["has_arena"] else None)
        self.prefix_cache = _ViewCache(sup) if ack["has_cache"] \
            else None
        self.live_request_ids = set()
        self.live_slots = 0
        self._closed = False
        self._failed = False

    def validate_request(self, request):
        self._sup._validate(request)

    def __exit__(self, exc_type, *a):
        self._sup.close(force=True)
        return False


class _RemoteJob:
    """Parent-side proxy of a worker's prefix-build job.  ``engine``
    is the owning supervisor's engine VIEW — the base fleet's
    ``job.engine is not rep.sup.engine`` staleness check works
    verbatim (a revived replica's new view never matches an old
    job's)."""

    __slots__ = ("job_id", "hit", "n_goal", "stream_meta", "engine")

    def __init__(self, job_id, hit, n_goal, stream_meta, engine):
        self.job_id = job_id
        self.hit = hit
        self.n_goal = n_goal
        self.stream_meta = stream_meta
        self.engine = engine


class RemoteSupervisor:
    """RPC proxy presenting the :class:`EngineSupervisor` surface for
    one worker replica.  Single-threaded like everything fleet-side;
    all state deltas arrive on RPC replies."""

    def __init__(self, fleet, idx, conn, proc, ack):
        self._fleet = fleet
        self._idx = idx
        self._conn = conn
        self._proc = proc
        self._clock = fleet._clock
        self.engine = _RemoteEngineView(self, ack)
        self.restarts = 0
        self._inner = {}     # rid -> parent-side RequestHandle
        self._order = []
        self._streamed = set()  # rids with tokens DELIVERED here
        self.pid = ack.get("pid")
        lbl = dict(fleet=fleet.fleet_label, replica=str(idx))
        reg = fleet._reg
        self._c_rpcs = reg.counter(
            "serve.dist.rpcs",
            help="control RPCs issued to this worker peer", **lbl)
        self._c_rpc_errors = reg.counter(
            "serve.dist.rpc_errors",
            help="RPCs lost to peer failure (partition, timeout, "
                 "broken framing)", **lbl)
        self._c_frames = reg.counter(
            "serve.dist.frames",
            help="streamed KV ship frames relayed TO this peer", **lbl)
        self._c_frame_bytes = reg.counter(
            "serve.dist.frame_bytes",
            help="host bytes of streamed KV frames relayed TO this "
                 "peer", **lbl)
        fleet._dist_registered += [self._c_rpcs, self._c_rpc_errors,
                                   self._c_frames, self._c_frame_bytes]

    # -- plumbing --------------------------------------------------------
    def _rpc(self, op, payload=None, timeout=None, retries=0):
        if self.engine._closed:
            raise PeerGoneError(
                f"worker r{self._idx} is closed", started=None)
        self._c_rpcs.inc()
        try:
            msg = self._conn.call(
                op, payload,
                timeout=(timeout if timeout is not None
                         else self._fleet._rpc_timeout),
                retries=retries)
        except TransportError as e:
            # framing lost: the stream cannot be trusted — peer loss
            # unless the worker redials inside the reconnect window
            self._c_rpc_errors.inc()
            cause = PeerGoneError(
                f"worker r{self._idx} framing lost: {e}",
                started=None)
            cause.__cause__ = e
            msg = self._resume_and_replay(cause, timeout)
        except PeerGoneError as e:
            self._c_rpc_errors.inc()
            msg = self._resume_and_replay(e, timeout)
        if not msg["ok"]:
            raise load_exc(msg["err"])
        return msg["value"]

    def _resume_and_replay(self, cause, timeout=None):
        """A socket-level loss mid-RPC: hold the replica inside its
        reconnect window instead of condemning it.  If the worker
        redials in time, replay the unacked CALL (exactly-once — the
        worker's reply cache dedupes by seq) and return its reply;
        otherwise re-raise ``cause`` into the existing PeerGone
        failover path.  Injected partition faults carry ``no_resume``
        and always escalate — the peer's socket never actually broke,
        so no redial is coming."""
        if getattr(cause, "no_resume", False) or self.engine._closed:
            raise cause
        frame = self._fleet._resume_peer(self)
        if frame is None:
            raise cause
        try:
            msg = self._conn.finish_pending(
                int(frame["last_seq"]),
                timeout=(timeout if timeout is not None
                         else self._fleet._rpc_timeout))
        except TransportError as e:
            raise PeerGoneError(
                f"worker r{self._idx} framing lost during replay: "
                f"{e}", started=None) from e
        if msg is None:
            raise cause
        self._fleet._c_resumed.inc()
        return msg

    def _apply_view(self, v):
        eng = self.engine
        eng.scheduler.queue_depth = v["queue_depth"]
        eng.live_slots = v["live_slots"]
        eng.stats.tpot_ewma = v["tpot_ewma"]
        eng.live_request_ids = set(v["live_rids"])
        self.restarts = v.get("restarts", self.restarts)
        if eng.paged_arena is not None \
                and v["blocks_used"] is not None:
            eng.paged_arena.blocks_used = v["blocks_used"]
        if eng.prefix_cache is not None \
                and v.get("cached_blocks") is not None:
            eng.prefix_cache.cached_blocks = v["cached_blocks"]

    def _apply_tokens(self, tokens):
        for rid, tok in tokens:
            h = self._inner.get(rid)
            if h is None or h.request.on_token is None:
                continue
            self._streamed.add(rid)
            try:
                h.request.on_token(h.request, tok)
            except Exception:
                # a raising CLIENT callback: the worker engine cannot
                # see it (delivery happens here); drop the token
                # stream rather than wedge the whole fleet step
                pass

    def _apply_resolved(self, resolved):
        for rid, out in resolved.items():
            h = self._inner.pop(rid, None)
            if h is None or h.done():
                continue
            if "err" in out:
                h._reject(load_exc(out["err"]))
                if self._fleet._spawn_mode == "process":
                    # thread mode: the worker engine's own reject site
                    # already emitted the instant into the SHARED trace
                    _trace.event(
                        "serve/request_rejected", cat="serve",
                        request=rid, reason=type(h._error).__name__,
                        replica=self._idx)
                if _reqs._active \
                        and self._fleet._spawn_mode == "process":
                    _reqs._ledger.on_reject(
                        rid, t=self._clock(),
                        reason=type(h._error).__name__,
                        engine=self.engine.stats.engine_label,
                        started=getattr(h._error, "started", None))
            else:
                h._finish(self._load_result(out["result"]))
                if _reqs._active \
                        and self._fleet._spawn_mode == "process":
                    r = h._result
                    _reqs._ledger.on_retire(
                        rid, engine=self.engine.stats.engine_label,
                        t=self._clock(),
                        finish_reason=r.finish_reason,
                        tokens=len(r.tokens))
        live = set(self._inner)
        self._order = [r for r in self._order if r in live]

    def _load_result(self, d):
        sess = None
        if d["session"] is not None:
            sess = DistSession(d["session"]["tokens"], self,
                               d["session"]["sid"])
        return GenerationResult(
            request_id=d["request_id"],
            tokens=np.asarray(d["tokens"]),
            finish_reason=d["finish_reason"], ttft=d["ttft"],
            tpot=d["tpot"], queue_time=d["queue_time"],
            admitted_step=d["admitted_step"],
            finished_step=d["finished_step"], session=sess)

    # -- EngineSupervisor surface ---------------------------------------
    @property
    def pending(self) -> bool:
        return bool(self._inner)

    def submit(self, request) -> RequestHandle:
        d = dump_request(request, self._clock)
        reply = self._rpc("submit", {"request": d})
        handle = RequestHandle(request)
        rid = request.request_id
        self._inner[rid] = handle
        self._order.append(rid)
        self._apply_view(reply["view"])
        if _reqs._active and self._fleet._spawn_mode == "process":
            # the worker's engine opened the hop in ITS process;
            # mirror a minimal hop here so the parent ledger sees the
            # request at all (thread mode shares the ledger — the
            # worker's own hop is already visible, skip the mirror)
            _reqs._ledger.on_submit(
                rid, engine=self.engine.stats.engine_label,
                t=self._clock(),
                prompt_len=len(request.prompt_ids),
                max_new_tokens=request.max_new_tokens)
        return handle

    def step_begin(self) -> int:
        """Send this replica's step CALL without waiting for the
        reply — DistFleet._step_replicas overlaps every peer's step.
        Checks the ``serve.dist.rpc`` partition fault exactly like a
        synchronous call would.  A send-side socket loss tries the
        reconnect window and re-sends the SAME seq on the new
        socket."""
        if self.engine._closed:
            raise PeerGoneError(
                f"worker r{self._idx} is closed", started=None)
        if _faults._armed:
            try:
                _faults.check("serve.dist.rpc")
            except Exception as e:
                self._c_rpc_errors.inc()
                err = PeerGoneError(
                    f"partition injected on step RPC to worker "
                    f"r{self._idx} ({e!r})", started=None)
                err.no_resume = True
                raise err from e
        self._c_rpcs.inc()
        try:
            return self._conn.send_call("step")
        except PeerGoneError as e:
            self._c_rpc_errors.inc()
            if getattr(e, "no_resume", False):
                raise
            frame = self._fleet._resume_peer(self)
            if frame is None:
                raise
            self._fleet._c_resumed.inc()
            return self._conn.resend_pending()

    def step_finish(self, seq):
        """Collect the reply for :meth:`step_begin` and apply its
        deltas (streamed tokens, resolved handles, the load view).
        A recv-side socket loss tries the reconnect window and
        replays the step call (the worker's reply cache dedupes)."""
        try:
            msg = self._conn.wait_reply(seq, self._fleet._rpc_timeout)
        except TransportError as e:
            self._c_rpc_errors.inc()
            cause = PeerGoneError(
                f"worker r{self._idx} framing lost: {e}",
                started=None)
            cause.__cause__ = e
            msg = self._resume_and_replay(cause)
        except PeerGoneError as e:
            self._c_rpc_errors.inc()
            msg = self._resume_and_replay(e)
        if not msg["ok"]:
            raise load_exc(msg["err"])
        reply = msg["value"]
        self._apply_tokens(reply["tokens"])
        self._apply_resolved(reply["resolved"])
        self._apply_view(reply["view"])
        if reply["budget"] is not None:
            # the worker's supervisor spent its restart budget: its
            # outstanding handles were rejected typed in `resolved`;
            # surface the replica-level death to the fleet
            raise load_exc(reply["budget"])
        return self.pending

    def step(self) -> bool:
        return self.step_finish(self.step_begin())

    def abandon(self, reason="fleet failover"):
        """Failover entry point.  Worker reachable: the REAL
        supervisor abandons (engine-truth ``started`` semantics) and
        the typed rejections apply here.  Worker unreachable (the
        partition case): resolve locally — ``started`` is True iff a
        token was DELIVERED to the caller, because delivery is the
        only thing the caller can observe; an undelivered request
        replays byte-identically (same seed, same chain)."""
        try:
            reply = self._rpc("abandon", {"reason": str(reason)},
                              timeout=10.0)
            self._apply_tokens(reply["tokens"])
            self._apply_resolved(reply["resolved"])
        except (PeerGoneError, RestartBudgetExceededError):
            self._local_abandon(reason)

    def _local_abandon(self, reason):
        for rid in list(self._order):
            h = self._inner.pop(rid, None)
            if h is None or h.done():
                continue
            started = rid in self._streamed
            h._reject(EngineFailedError(
                f"{rid}: worker r{self._idx} lost ({reason})",
                request_id=rid, started=started))
            # the worker is UNREACHABLE: nothing on its side can
            # record this rejection — the controller is the authority
            # on the delivery-started verdict, so it lands here
            _trace.event("serve/request_rejected", cat="serve",
                         request=rid, reason="peer_lost",
                         replica=self._idx, started=started)
            if _reqs._active:
                _reqs._ledger.on_reject(
                    rid, t=self._clock(), reason="peer_lost",
                    engine=self.engine.stats.engine_label,
                    started=started)
        self._order = []

    # -- ship API (the fleet's _drive_ships speaks this) -----------------
    def start_prefix_build(self, prompt_ids):
        reply = self._rpc("build_start", {
            "prompt_ids": np.asarray(prompt_ids, np.int32),
            "stream": self._fleet.stream_ships})
        if reply["job_id"] is None:
            return None
        return _RemoteJob(reply["job_id"], reply["hit"],
                          reply["n_goal"], reply["stream_meta"],
                          self.engine)

    def advance_prefix_build(self, job, max_tokens=None, rid=None):
        stream = self._fleet._ship_streams.get(rid)
        reply = self._rpc("build_advance", {
            "job_id": job.job_id, "budget": max_tokens, "rid": rid,
            "stream": stream is not None})
        if reply["status"] == "rebuilt":
            return None
        if stream is not None and reply["frames"]:
            self._relay_frames(rid, stream, reply["frames"])
        return reply["status"] == "done"

    def _relay_frames(self, rid, stream, frames):
        """Forward the source's newly built lanes to the streamed
        ship's destination, fire-and-forget — overlapped with the
        source's NEXT prefill chunk.  The ``serve.dist.frame`` fault
        fires here: a half-shipped image.  A destination lost
        mid-relay is marked down and the failure surfaces as a plain
        RuntimeError so the drive loop requeues the request cold
        WITHOUT condemning the healthy source."""
        dst_sup, ship_id = stream
        t0 = self._clock()
        try:
            for (li, layer, lo, hi, data) in frames:
                if _faults._armed:
                    _faults.check("serve.dist.frame")
                dst_sup._conn.send_oneway("ship_frame", {
                    "ship_id": ship_id, "leaf": li, "layer": layer,
                    "lo": lo, "hi": hi, "bytes": data})
                dst_sup._c_frames.inc()
                dst_sup._c_frame_bytes.inc(len(data))
            # wire time spent HERE is overlapped with the source's
            # next prefill chunk — the hidden half of the ship
            fleet = self._fleet
            fleet._ship_hidden[rid] = (
                fleet._ship_hidden.get(rid, 0.0)
                + (self._clock() - t0))
        except PeerGoneError as e:
            dst_sup._c_rpc_errors.inc()
            fleet = self._fleet
            fleet._ship_streams.pop(rid, None)
            fleet._mark_down(fleet._replicas[dst_sup._idx], e)
            raise RuntimeError(
                f"streamed ship destination r{dst_sup._idx} lost "
                f"mid-relay: {e}") from e

    def export_prefix_image(self, job):
        reply = self._rpc("build_export", {"job_id": job.job_id})
        return KVImage.from_bytes(reply["image"]), reply["resident"]

    def export_ship_meta(self, job):
        """Streamed-path export: the lanes already crossed as frames;
        fetch only the image identity (header/crc/geometry) and the
        residency verdict."""
        reply = self._rpc("build_export_meta", {"job_id": job.job_id})
        return reply["meta"], reply["resident"]

    def admit_prefix_image(self, tokens, image):
        reply = self._rpc("admit_image", {
            "tokens": np.asarray(tokens, np.int32),
            "image": image.to_bytes()})
        return reply["path"]

    def abandon_prefix_build(self, job):
        try:
            self._rpc("build_abandon", {"job_id": job.job_id},
                      timeout=10.0)
        except (PeerGoneError, RestartBudgetExceededError):
            pass  # best-effort cleanup on a dying peer

    def ship_begin(self, ship_id, meta):
        self._conn.send_oneway("ship_begin", {"ship_id": ship_id,
                                              "meta": meta})

    def ship_abort(self, ship_id):
        try:
            self._conn.send_oneway("ship_abort",
                                   {"ship_id": ship_id})
        except PeerGoneError:
            pass  # its staging died with it

    def ship_commit(self, ship_id, tokens, meta):
        reply = self._rpc("ship_commit", {
            "ship_id": ship_id,
            "tokens": np.asarray(tokens, np.int32),
            "header": meta["header"], "checksum": meta["checksum"],
            "n_data": meta["n_data"],
            "block_size": meta["block_size"], "quant": meta["quant"],
            "k_leaves": meta["k_leaves"]})
        return reply["path"]

    # -- view-shim backends ----------------------------------------------
    def _prefix_lookup(self, tokens) -> int:
        try:
            return self._rpc("prefix_lookup", {
                "tokens": np.asarray(tokens, np.int32)})["n"]
        except (PeerGoneError, RestartBudgetExceededError):
            return 0  # unreachable == holds nothing: hint gets pruned

    def _cache_release(self, path_id):
        self._rpc("cache_release", {"path": path_id}, timeout=10.0)

    def _validate(self, request):
        self._rpc("validate",
                  {"request": dump_request(request, self._clock)})

    def session_release(self, sid):
        try:
            self._rpc("session_release", {"sid": sid}, timeout=10.0)
        except (PeerGoneError, RestartBudgetExceededError):
            pass  # a dead worker's pins died with its tree

    def _snapshot(self) -> dict:
        try:
            return self._rpc("snapshot", timeout=10.0)["stats"]
        except (PeerGoneError, RestartBudgetExceededError):
            return {"engine_label": self.engine.stats.engine_label,
                    "unreachable": True}

    def ping(self):
        self._rpc("ping", timeout=5.0)

    # -- lifecycle -------------------------------------------------------
    def close(self, force=False):
        if self.engine._closed:
            return
        self.engine._closed = True
        try:
            self._conn.call("shutdown", {"force": force},
                            timeout=10.0)
        except (PeerGoneError, TransportError):
            pass
        self._conn.close()
        if self._proc is not None:
            # adopted workers have no spawn handle to reap — they were
            # spawned by the controller this one replaced
            self._fleet._graveyard.append(self._proc)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        self.close(force=True)
        return False


class DistFleet(ServeFleet):
    """A :class:`ServeFleet` whose replicas are worker processes.

    >>> spec = gpt2_spec(model)          # serve/dist/worker.py
    >>> fleet = DistFleet(spec, replicas=2, spawn="process",
    ...                   max_slots=4)
    >>> h = fleet.submit(GenerationRequest(prompt, max_new_tokens=8))
    >>> fleet.run_until_complete()

    ``spec`` is a :class:`~singa_tpu_torch.serve.dist.worker.ModelSpec`
    (factory + weight states): every worker builds the SAME model, so
    token streams are byte-identical to a single-process fleet over
    the same replica count.  ``spawn`` picks ``"process"``
    (multiprocessing spawn — real isolation) or ``"thread"`` (same
    wire protocol over loopback, worker loops in threads — the
    tier-1-test configuration).  ``stream_ships`` enables layer-wise
    streamed KV shipping (on by default); bulk single-image shipping
    is the fallback and the resident-hit path either way."""

    def __init__(self, spec, replicas=2, spawn="thread",
                 stream_ships=True, rpc_timeout=60.0,
                 heartbeat_timeout=30.0, federate=True,
                 telemetry_interval_s=2.0, reconnect_window_s=2.0,
                 reconnect_grace_s=4.0, park_ttl_s=60.0,
                 journal_cap=256, _adopt=None, **kw):
        if not isinstance(spec, ModelSpec):
            raise TypeError(
                f"DistFleet needs a ModelSpec (the worker's model "
                f"recipe — serve/dist/worker.py gpt2_spec), got "
                f"{type(spec).__name__}: a live model object cannot "
                f"cross the process boundary")
        if spawn not in ("thread", "process"):
            raise ValueError(
                f"spawn must be 'thread' or 'process', got {spawn!r}")
        for k in ("tp", "ep", "pp"):
            if kw.get(k) not in (None, False):
                raise ValueError(
                    f"{k}= is not supported across the process "
                    f"boundary yet: sharded replicas pin local device "
                    f"groups (run those under ServeFleet)")
        self._spec = spec
        self._spawn_mode = spawn
        self.stream_ships = bool(stream_ships)
        self._rpc_timeout = float(rpc_timeout)
        self._hb_timeout = float(heartbeat_timeout)
        # -- controller survivability ---------------------------------
        self._reconnect_window = float(reconnect_window_s)
        self._reconnect_grace = float(reconnect_grace_s)
        self._park_ttl = float(park_ttl_s)
        self._journal_cap = int(journal_cap)
        self._resume_pool = {}    # idx -> (RESUME frame, Conn) parked
        self._pending_clock_resync = set()
        self._adopt_src = _adopt
        self._adopting = _adopt is not None
        self.adoption = None      # reconciliation report (adopt only)
        if _adopt is None:
            self._token = os.urandom(16)
            self._listener = Listener(token=self._token)
            #: fencing epoch every frame to the workers is stamped
            #: with; an adopting successor bumps it and the workers
            #: refuse this controller's frames typed from then on
            self._epoch = 1
        else:
            a_host, a_port, a_token = _adopt
            self._token = a_token
            self._listener = Listener(host=a_host, port=a_port,
                                      token=a_token)
            self._epoch = None    # negotiated from the workers' offers
        self._graveyard = []
        self._dist_registered = []
        self._ship_streams = {}   # rid -> (dst RemoteSupervisor, ship_id)
        #: completed-ship wall seconds, windowed (the warm-TTFT
        #: evidence surface: snapshot()["dist"]["ship_s_*"])
        self.ship_window = WindowRing(
            kind="event", clock=kw.get("clock", time.monotonic))
        # -- federation state (must exist BEFORE super().__init__:
        # supervisors spawn in there and register their hosts) -------
        self._federate = bool(federate)
        self._telemetry_interval = float(telemetry_interval_s)
        self._t_last_pull = None
        self._ship_hidden = {}    # rid -> wire s overlapped w/ prefill
        self._peer_metrics = {}   # idx -> [Conn transport metrics]
        #: controller-side merge of every worker's telemetry: clocks,
        #: registries, ledgers, traces (observe.federate)
        self.telemetry = FleetTelemetry(
            clock=kw.get("clock", time.monotonic))
        if self._federate:
            # hop records gain a host id so cross-host why_slow and
            # flow arrows can name hosts; module-level install makes
            # health_report()["serve"]["dist"] see THIS fleet
            _reqs.set_host_namer(lambda i: f"w{i}")
            _federate.install(self.telemetry)
        super().__init__(spec, replicas=replicas, **kw)
        self.telemetry.fleet = self.fleet_label
        lblf = dict(fleet=self.fleet_label)
        self._c_ship_hidden = self._reg.counter(
            "serve.dist.ship_wire_hidden_s",
            help="streamed-ship wire seconds overlapped with source "
                 "prefill compute (the hidden half)", **lblf)
        self._c_ship_exposed = self._reg.counter(
            "serve.dist.ship_wire_exposed_s",
            help="ship completion wall seconds on the request's "
                 "critical path (export+commit+land)", **lblf)
        self._c_reconnects = self._reg.counter(
            "serve.dist.reconnects",
            help="worker sessions resumed after a socket loss "
                 "(reconnect window hits — each one is a failover "
                 "plus respawn that did NOT happen)", **lblf)
        self._c_resumed = self._reg.counter(
            "serve.dist.resumed_calls",
            help="unacked CALLs replayed across a resumed session "
                 "(exactly-once: the worker's reply cache dedupes)",
            **lblf)
        self._c_parked = self._reg.counter(
            "serve.dist.parked_results",
            help="journaled terminal results claimed from workers at "
                 "adoption and re-delivered exactly once", **lblf)
        self._g_epoch = self._reg.gauge(
            "serve.dist.epoch",
            help="this controller's fencing epoch (workers refuse "
                 "frames from any lower epoch typed)", **lblf)
        self._g_epoch.set(self._epoch)
        self._dist_registered += [self._c_ship_hidden,
                                  self._c_ship_exposed,
                                  self._c_reconnects, self._c_resumed,
                                  self._c_parked, self._g_epoch]
        if self._adopting:
            self._adopting = False
            self.adoption = self._reconcile_adoption()

    # -- replica construction / teardown ---------------------------------
    def _new_supervisor(self, idx):
        if self._adopting:
            # adoption path: the worker is already alive and built —
            # attach to its redial instead of spawning
            return self._adopt_supervisor(idx)
        proc = self._spawn_worker(idx)
        widx, conn = self._listener.accept_worker(
            timeout=self._init_timeout())
        if widx != idx:
            conn.close()
            raise TransportError(
                f"worker handshake says replica {widx}, expected "
                f"{idx}")
        conn.epoch = self._epoch
        sup_kw = {k: v for k, v in self._sup_kw.items()
                  if k != "clock"}  # callables don't ship; the worker
        #                             keeps its own monotonic clock
        init = {"spec": self._spec, "sup_kw": sup_kw,
                "engine_kw": self._replica_kw(idx),
                "epoch": self._epoch,
                "recover": {"park_ttl": self._park_ttl,
                            "journal_cap": self._journal_cap}}
        if self._federate and self._spawn_mode == "process":
            # the worker process records its OWN ledger + trace and
            # ships them on telemetry pulls; thread mode must NOT —
            # its observe globals are the controller's (shared)
            init["federate"] = {"ledger": True, "trace": True,
                                "stepprof": True, "capacity": 4096}
        ack = conn.call("init", init, timeout=self._init_timeout())
        if not ack["ok"]:
            conn.close()
            raise load_exc(ack["err"])
        sup = RemoteSupervisor(self, idx, conn, proc, ack["value"])
        self._register_host(idx, sup)
        return sup

    def _adopt_supervisor(self, idx):
        """Attach to a LIVE worker orphaned by a dead controller: wait
        for its redial, negotiate the fencing epoch one past the
        highest offer (the dead controller — and anything replaying
        its frames — is refused typed from this moment), and size the
        proxy from a ``describe`` probe instead of an INIT build.
        No capture follows from this: the worker's engine and its
        captured decode steps are never touched."""
        deadline = time.monotonic() + self._init_timeout()
        got = self._accept_resume(idx, deadline)
        if got is None:
            raise PeerTimeoutError(
                f"no RESUME redial from worker r{idx} within the "
                f"adoption window", started=None)
        frame, conn = got
        offered = int(frame.get("epoch", 0))
        if self._epoch is None or offered >= self._epoch:
            self._epoch = offered + 1
        conn.send(MSG_RESUME, {"ok": True, "epoch": self._epoch})
        conn.epoch = self._epoch
        # continue the worker's seq space: its reply cache and journal
        # acks are keyed by it
        conn._seq = int(frame.get("last_seq", 0))
        ack = conn.call("describe", timeout=self._init_timeout())
        if not ack["ok"]:
            conn.close()
            raise load_exc(ack["err"])
        sup = RemoteSupervisor(self, idx, conn, None, ack["value"])
        self._register_host(idx, sup)
        return sup

    def _register_host(self, idx, sup):
        """Federation side of a (re)spawned worker: fresh per-peer
        transport metrics (a replaced peer's series leave the registry
        first — replace_dead must not resurrect the dead conn's
        counts), a fresh NTP-style clock estimate (process mode: new
        process, new clock base), and a fresh telemetry host slot."""
        old = self._peer_metrics.pop(idx, None)
        if old:
            self._reg.remove(*old)
            self._dist_registered = [
                m for m in self._dist_registered if m not in old]
        ms = sup._conn.attach_metrics(self._reg, peer=f"w{idx}")
        self._peer_metrics[idx] = ms
        self._dist_registered += ms
        if not self._federate:
            return
        cs = None
        if self._spawn_mode == "process":
            cs = ClockSync(clock=self._clock)
            try:
                cs.sample(lambda: sup._conn.call(
                    "clock", timeout=10.0,
                    fault_site="serve.dist.telemetry")["value"]["t"])
            except Exception:
                cs = None  # clock probe lost: merge uncorrected
        self.telemetry.host_online(
            f"w{idx}", clock_sync=cs,
            thread=(f"dist-worker-{idx}"
                    if self._spawn_mode == "thread" else None),
            pid=sup.pid)

    def _init_timeout(self) -> float:
        # a spawned process imports torch, opens a CUDA context and
        # loads the kernels; a thread shares this process's
        return 300.0 if self._spawn_mode == "process" else 120.0

    def _spawn_worker(self, idx):
        args = (self._listener.host, self._listener.port,
                self._token, idx)
        if self._spawn_mode == "process":
            import multiprocessing as mp

            ctx = mp.get_context("spawn")
            proc = ctx.Process(target=worker_main, args=args,
                               daemon=True, name=f"dist-worker-{idx}")
            proc.start()
            return proc
        t = threading.Thread(target=worker_main, args=args,
                             daemon=True, name=f"dist-worker-{idx}")
        t.start()
        return t

    def kill_worker(self, idx):
        """Chaos/test hook: make replica ``idx``'s worker DIE without
        telling the fleet — process mode kills the process, thread
        mode tells the worker loop to stop (a one-way ``die``) before
        severing the socket, so the worker does NOT redial: a killed
        worker must stay dead (contrast :meth:`blip_worker`).  The
        next RPC to it raises :class:`PeerGoneError` and the normal
        failover path takes over once the reconnect window drains."""
        sup = self._replicas[idx].sup
        proc = sup._proc
        if self._spawn_mode == "process" \
                and hasattr(proc, "terminate"):
            proc.terminate()
            proc.join(timeout=10.0)
        else:
            try:
                # TCP ordering lands the die ahead of the FIN, so the
                # worker stops instead of entering its redial loop
                sup._conn.send_oneway("die")
            except PeerGoneError:
                pass
            sup._conn.close()

    def blip_worker(self, idx):
        """Chaos/test hook: sever the controller-side socket WITHOUT
        telling the worker anything — a modeled transient network
        blip.  The worker's recv fails, it redials with full-jitter
        backoff, and the session resumes inside the reconnect window:
        no failover, no respawn, no cold KV arena."""
        self._replicas[idx].sup._conn.close()

    def crash(self):
        """Chaos/test hook: die the way a crashed controller process
        dies — no shutdown RPCs, no engine closes, no drains.  Workers
        keep stepping live work, journal finished results, and redial;
        a successor attaches to them with :meth:`adopt`.  This fleet
        object is unusable afterwards (its registry entries and
        federation hooks are released so the successor can install
        its own)."""
        self._listener.close()
        for rep in self._replicas:
            rep.sup.engine._closed = True
            try:
                rep.sup._conn.close()
            except Exception:
                pass
        self._closed = True
        self._reg.remove(*self._registered)
        self._reg.remove(*self._dist_registered)
        self._dist_registered = []
        self._peer_metrics = {}
        self._teardown_federation()

    # -- reconnect-with-resume -------------------------------------------
    def _accept_resume(self, idx, deadline):
        """Accept redials until worker ``idx``'s RESUME arrives (or
        the deadline does).  Other workers' resumes landing first are
        parked in the resume pool — with several replicas blipped at
        once, whichever redials first must not be dropped on the
        floor while we wait for a specific one."""
        got = self._resume_pool.pop(idx, None)
        if got is not None:
            return got
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            try:
                kind, frame, conn = self._listener.accept_any(
                    timeout=remaining)
            except PeerTimeoutError:
                return None
            except (TransportError, PeerGoneError):
                continue  # a refused handshake does not end the window
            if kind != MSG_RESUME:
                conn.close()  # a fresh HELLO here is a stray spawn
                continue
            widx = int(frame["idx"])
            if widx == idx:
                return frame, conn
            old = self._resume_pool.pop(widx, None)
            if old is not None:
                old[1].close()
            self._resume_pool[widx] = (frame, conn)

    def _resume_peer(self, sup):
        """Controller half of reconnect-with-resume: hold replica
        ``sup._idx`` inside its reconnect window, accept the worker's
        redial, verify the fence, and swap the session onto the new
        socket (seq space and the pending CALL carry over).  Returns
        the worker's RESUME frame, or None when the window closes
        (callers then escalate to the normal PeerGone failover).
        While the window — and the grace period after it — runs, the
        replica's ``reconnect_deadline`` gates the autoscaler's
        ``_replace_dead`` so a blipped worker is never concurrently
        respawned."""
        idx = sup._idx
        rep = (self._replicas[idx]
               if idx < len(self._replicas) else None)
        now = time.monotonic()
        if rep is not None:
            rep.reconnect_deadline = now + max(
                self._reconnect_window, self._reconnect_grace)
        got = self._accept_resume(idx, now + self._reconnect_window)
        if got is None:
            _trace.event("serve/dist_resume", cat="serve", replica=idx,
                         resumed=False, seconds=time.monotonic() - now)
            return None
        frame, conn = got
        if int(frame.get("epoch", 0)) > self._epoch:
            # the worker is fenced HIGHER than us: a successor already
            # adopted the fleet and THIS controller is the stale side
            # of the split brain — refuse the session and fail typed
            conn.close()
            raise StaleEpochError(
                f"worker r{idx} is fenced at epoch {frame['epoch']}, "
                f"this controller at {self._epoch}: a successor "
                f"adopted the fleet; this controller is stale")
        conn.send(MSG_RESUME, {"ok": True, "epoch": self._epoch})
        old = sup._conn
        conn.label = old.label or f"r{idx}"
        conn.epoch = self._epoch
        # carry the session: the seq space continues (the worker's
        # reply cache and journal acks key off it) and the unacked
        # pending CALL crosses to the new socket for replay
        conn._seq = max(old._seq, int(frame.get("last_seq", 0)))
        conn._pending = old._pending
        sup._conn = conn
        try:
            old.close()
        except Exception:
            pass
        self._c_reconnects.inc()
        self._after_resume(sup)
        if rep is not None:
            rep.reconnect_deadline = None
        _trace.event("serve/dist_resume", cat="serve", replica=idx,
                     resumed=True, seconds=time.monotonic() - now)
        return frame

    def _after_resume(self, sup):
        """Federation bookkeeping for a resumed session: the old
        socket's transport series are retired for fresh ones (same
        retire-unregisters contract as replace_dead), and process-mode
        clock sync re-estimates — deferred to the watchdog while a
        replay is still pending, because an interleaved clock RPC
        would corrupt the replayed call's seq space."""
        idx = sup._idx
        old = self._peer_metrics.pop(idx, None)
        if old:
            self._reg.remove(*old)
            self._dist_registered = [
                m for m in self._dist_registered if m not in old]
        ms = sup._conn.attach_metrics(self._reg, peer=f"w{idx}")
        self._peer_metrics[idx] = ms
        self._dist_registered += ms
        if not self._federate or self._spawn_mode != "process":
            return
        if sup._conn._pending is None:
            self._clock_resync(sup)
        else:
            self._pending_clock_resync.add(idx)

    def _clock_resync(self, sup):
        """Fresh NTP-style offset estimate after a reconnect: the
        worker process kept its clock base, but the blip may have been
        a host stall — re-measuring keeps federated timestamps
        honest."""
        cs = ClockSync(clock=self._clock)
        try:
            cs.sample(lambda: sup._conn.call(
                "clock", timeout=10.0,
                fault_site="serve.dist.telemetry")["value"]["t"])
        except Exception:
            cs = None
        h = self.telemetry.hosts.get(f"w{sup._idx}")
        if h is not None:
            h.clock = cs

    # -- fenced adoption --------------------------------------------------
    @classmethod
    def adopt(cls, spec, port, token, host="127.0.0.1", replicas=2,
              **kw):
        """Attach a NEW controller to live workers orphaned by a dead
        one.  Binds the dead controller's listener address, accepts
        each worker's RESUME redial, bumps the fencing epoch (the dead
        controller — or anything replaying its frames — is refused
        typed on EVERY op from that moment: split-brain routing is
        impossible by construction), reconciles the workers' request
        journals, and resumes routing against engines that were never
        rebuilt — their captured decode steps kept, none captured anew.

        The reconciliation report lands on ``fleet.adoption``::

            {"resumed":   {rid: RequestHandle},  # still decoding
             "delivered": {rid: RequestHandle},  # parked result,
                                                 #  re-delivered once
             "requeued":  {rid: RequestHandle},  # never started,
                                                 #  resubmitted in
                                                 #  arrival order
             "rejected":  {rid: error}}          # started-and-dead /
                                                 #  TTL-expired: typed
        """
        return cls(spec, replicas=replicas,
                   _adopt=(host, port, token), **kw)

    def _note_adopt_hop(self, rid, req, idx, kind):
        """Ledger: adoption is a routing hop (``via=adopt``).  Process
        mode opens a minimal entry first — the successor's ledger
        never saw the original submit (it happened in a dead
        process); thread mode shares the predecessor's globals, so
        the original entry is already there."""
        if not _reqs._active:
            return
        if self._spawn_mode == "process":
            _reqs._ledger.on_submit(
                rid,
                engine=self._replicas[idx].sup.engine.stats
                .engine_label,
                t=self._clock(), prompt_len=len(req.prompt_ids),
                max_new_tokens=req.max_new_tokens)
        _reqs._ledger.annotate_hop(rid, replica=idx, via="adopt",
                                   adopt=kind)

    def _reconcile_adoption(self) -> dict:
        """Merge every worker's journal into one fleet-wide verdict,
        processed in original arrival order: live work re-attaches
        (the worker kept decoding the whole time), parked terminal
        results are claimed and re-delivered exactly once, work that
        never started is resubmitted through normal admission, and
        anything unrecoverable (TTL-expired, started on a dead
        engine) is refused typed — never silently re-run, because a
        replay after delivered tokens could duplicate them."""
        report = {"resumed": {}, "delivered": {}, "requeued": {},
                  "rejected": {}}
        entries = []
        for rep in self._replicas:
            inv = rep.sup._rpc("reconcile")
            for rid, ent in inv["requests"].items():
                entries.append((int(ent["order"]), rep.idx, rid, ent))
        entries.sort(key=lambda t: (t[0], t[1]))
        for _order, idx, rid, ent in entries:
            sup = self._replicas[idx].sup
            st = ent["state"]
            if st == "live":
                req = load_request(ent["req"], clock=self._clock)
                inner = RequestHandle(req)
                sup._inner[rid] = inner
                sup._order.append(rid)
                if ent.get("cursor", 0) > 0:
                    # tokens already streamed (to the dead
                    # controller): NOT safely re-runnable — pin the
                    # delivery-started verdict for any later failover
                    sup._streamed.add(rid)
                handle = RequestHandle(req)
                route = _Route(handle, self.step_count)
                route.attempts.append((idx, inner))
                self._routes[rid] = route
                self._order.append(rid)
                self._note_adopt_hop(rid, req, idx, "resumed")
                report["resumed"][rid] = handle
                continue
            if st == "parked":
                out = sup._rpc("claim", {"rid": rid})
                if out.get("status") == "parked":
                    self._c_parked.inc()
                    payload = out["out"]
                    req_d = out.get("req")
                    if "result" in payload:
                        req = load_request(req_d, clock=self._clock)
                        handle = RequestHandle(req)
                        handle._finish(
                            sup._load_result(payload["result"]))
                        self._note_adopt_hop(rid, req, idx,
                                             "delivered")
                        report["delivered"][rid] = handle
                        continue
                    err = load_exc(payload["err"])
                    if getattr(err, "started", None) is False \
                            and req_d is not None:
                        # rejected without ever occupying a slot
                        # (e.g. the engine died while it sat queued):
                        # same seed -> same chain -> safe to requeue
                        req = load_request(req_d, clock=self._clock)
                        try:
                            handle = self.submit(req)
                        except Exception as e:
                            report["rejected"][rid] = e
                            continue
                        if _reqs._active:
                            _reqs._ledger.annotate_hop(
                                rid, via="adopt", adopt="requeued")
                        report["requeued"][rid] = handle
                        continue
                    report["rejected"][rid] = err
                    if _reqs._active:
                        _reqs._ledger.on_reject(
                            rid, t=self._clock(),
                            reason="adopt_dead",
                            started=getattr(err, "started", None))
                    continue
                st = out.get("status") or "gone"
            # expired / gone: the terminal result is unrecoverable and
            # the cursor says whether tokens ever streamed — refuse
            # typed rather than risk duplicating delivered tokens
            cursor = int(ent.get("cursor", 0))
            err = EngineFailedError(
                f"{rid}: unrecoverable across controller adoption "
                f"({st}, cursor={cursor})", request_id=rid,
                started=(True if cursor > 0 else None))
            report["rejected"][rid] = err
            if _reqs._active:
                _reqs._ledger.on_reject(
                    rid, t=self._clock(), reason=f"adopt_{st}",
                    started=err.started)
        self._g_epoch.set(self._epoch)
        return report

    def _reap(self):
        """Join/terminate every worker handed to the graveyard (and
        any still attached)."""
        procs, self._graveyard = self._graveyard, []
        for p in procs:
            if hasattr(p, "terminate"):   # a process
                p.join(timeout=5.0)
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=5.0)
                    if p.is_alive():
                        p.kill()
                        p.join(timeout=5.0)
            else:                          # a thread
                p.join(timeout=5.0)

    def retire_replica(self, idx):
        """Scale-down retire, federation side: the worker's per-peer
        transport series and its telemetry host slot leave with it —
        a retired host must not freeze into the federated exposition
        (the dist analogue of ``EngineStats.unregister``)."""
        super().retire_replica(idx)
        self._unregister_host(idx)

    def _unregister_host(self, idx):
        ms = self._peer_metrics.pop(idx, None)
        if ms:
            self._reg.remove(*ms)
            self._dist_registered = [
                m for m in self._dist_registered if m not in ms]
        if self._federate:
            self.telemetry.remove_host(f"w{idx}")

    def _teardown_federation(self):
        if self._federate:
            _reqs.set_host_namer(None)
            _federate.uninstall(self.telemetry)

    def close(self):
        was_closed = self._closed
        super().close()
        if not was_closed:
            self._listener.close()
            self._reap()
            self._reg.remove(*self._dist_registered)
            self._dist_registered = []
            self._peer_metrics = {}
            self._teardown_federation()

    def __exit__(self, exc_type, *a):
        closed_before = self._closed
        r = super().__exit__(exc_type, *a)
        if not closed_before and exc_type is not None:
            self._listener.close()
            self._reap()
            self._reg.remove(*self._dist_registered)
            self._dist_registered = []
            self._peer_metrics = {}
            self._teardown_federation()
        return r

    # -- drive: overlapped stepping, ping-based watchdog -----------------
    def _step_replicas(self):
        """Issue EVERY healthy replica's step RPC, then collect: the
        workers decode concurrently and the fleet pays one round-trip
        latency per step, not one per replica."""
        started = []
        for rep in self._replicas:
            if not rep.healthy or not rep.sup.pending:
                continue
            try:
                started.append((rep, rep.sup.step_begin()))
            except RestartBudgetExceededError as e:
                self._mark_down(rep, e)
        for rep, seq in started:
            try:
                rep.sup.step_finish(seq)
            except RestartBudgetExceededError as e:
                self._mark_down(rep, e)

    def _check_watchdog(self):
        """Per-peer liveness: heartbeats are piggybacked on every
        received frame, so only QUIET peers are pinged — a peer that
        answers nothing within the heartbeat window is gone."""
        for rep in self._replicas:
            if not rep.healthy:
                continue
            sup = rep.sup
            if sup._conn.age() < self._hb_timeout:
                continue
            try:
                sup.ping()
            except RestartBudgetExceededError as e:
                self._mark_down(rep, e)
        # deferred post-resume clock re-estimates: safe now if the
        # replayed CALL has been answered (no pending seq to corrupt)
        for idx in list(self._pending_clock_resync):
            rep = self._replicas[idx]
            if rep.healthy and rep.sup._conn._pending is None:
                self._pending_clock_resync.discard(idx)
                self._clock_resync(rep.sup)
        self._maybe_pull_telemetry()

    def kernel_launches(self) -> dict:
        """Each healthy worker's kernel launch counts, pulled over the
        wire: ``{replica: {"paged_attn.launches": n, ...}}``.  A worker
        process counts its own launches, captured replays included
        (graphs.py); the workers of a thread-mode fleet share this
        process's counts."""
        return {rep.idx: rep.sup._rpc("telemetry", {"kernels": True},
                                      timeout=10.0)["kernels"]
                for rep in self._replicas
                if rep.healthy and not rep.retired}

    def _maybe_pull_telemetry(self, force=False):
        """Periodic (or forced on-demand) telemetry pull from every
        healthy worker.  Rides its OWN fault site
        (``serve.dist.telemetry``) so chaos tests partitioning the
        control plane never have their injected fault consumed by a
        background pull.  ANY failure degrades that host to a typed
        ``stale`` marker — telemetry loss never raises into the step
        loop and never blocks serving."""
        if not self._federate:
            return
        now = self._clock()
        if not force and self._t_last_pull is not None \
                and now - self._t_last_pull < self._telemetry_interval:
            return
        self._t_last_pull = now
        process = self._spawn_mode == "process"
        for rep in self._replicas:
            host = f"w{rep.idx}"
            if rep.retired or host not in self.telemetry.hosts:
                continue
            if not rep.healthy:
                self.telemetry.mark_stale(host, "replica down")
                continue
            try:
                # thread mode shares this process's observe globals —
                # pull nothing but liveness (registry/ledger/trace are
                # already visible locally); process mode drains the
                # worker's private copies across the wire
                msg = rep.sup._conn.call(
                    "telemetry",
                    {"registry": process, "ledger": process,
                     "trace": process, "drain": process},
                    timeout=10.0, fault_site="serve.dist.telemetry")
                if not msg["ok"]:
                    raise load_exc(msg["err"])
                self.telemetry.ingest(host, msg["value"], t=now)
            except Exception as e:
                self.telemetry.mark_stale(host, repr(e))

    # -- streamed KV shipping --------------------------------------------
    def _before_build_advance(self, sjob):
        """Open the streamed ship on a build's first advance: pick the
        destination NOW (the same prefix-hash-sticky candidate order
        the bulk path uses), start its staging, and register the frame
        sink — every lane the coming chunks complete ships while the
        source still prefills."""
        if not self.stream_ships or sjob.rid in self._ship_streams:
            return
        job = sjob.job
        if getattr(job, "stream_meta", None) is None:
            return  # resident hit or non-remote job: bulk path
        for idx in self._ship_dsts(sjob.request):
            dst_sup = self._replicas[idx].sup
            ship_id = f"s{next(_ship_ids)}-{sjob.rid}"
            try:
                dst_sup.ship_begin(ship_id, job.stream_meta)
            except PeerGoneError as e:
                self._mark_down(self._replicas[idx], e)
                continue
            self._ship_streams[sjob.rid] = (dst_sup, ship_id)
            return

    def _complete_ship(self, sjob, src_rep):
        stream = self._ship_streams.get(sjob.rid)
        if stream is None:
            return super()._complete_ship(sjob, src_rep)
        dst_sup, ship_id = stream
        req = sjob.request
        t0 = self._clock()
        try:
            meta, resident = src_rep.sup.export_ship_meta(sjob.job)
        finally:
            sjob.job = None
        n = meta["n_data"]
        if resident:
            self._prefix_index.register(req.prompt_ids, n,
                                        src_rep.idx)
        dst_rep = self._replicas[dst_sup._idx]
        if not dst_rep.healthy or dst_rep.sup is not dst_sup:
            self._ship_fallback(sjob, "stream_dst_lost")
            return
        try:
            path = dst_sup.ship_commit(ship_id, req.prompt_ids, meta)
        except RestartBudgetExceededError as e:
            self._mark_down(dst_rep, e)
            self._ship_fallback(sjob, "stream_dst_lost")
            return
        except KVImageError as e:
            # half-shipped or corrupted staging failed the typed
            # validation at admit: recompute cold, never a wrong token
            self._log.warning(
                "streamed ship for %s rejected at commit (%r); "
                "serving cold", sjob.rid, e)
            self._ship_fallback(sjob, "half_shipped")
            return
        self._ship_streams.pop(sjob.rid, None)
        if path is None:
            self._ship_fallback(sjob, "dst_capacity")
            return
        self._land_shipped(sjob, src_rep, dst_rep, path, n,
                           meta["nbytes"], t0)

    def _land_shipped(self, sjob, src_rep, dst_rep, path, n, nbytes,
                      t0):
        exposed = self._clock() - t0
        self.ship_window.append(exposed)
        hidden = self._ship_hidden.pop(sjob.rid, 0.0)
        self._c_ship_hidden.inc(hidden)
        self._c_ship_exposed.inc(exposed)
        return super()._land_shipped(sjob, src_rep, dst_rep, path, n,
                                     nbytes, t0)

    def _abandon_build(self, sjob):
        stream = self._ship_streams.pop(sjob.rid, None)
        self._ship_hidden.pop(sjob.rid, None)
        if stream is not None:
            dst_sup, ship_id = stream
            dst_sup.ship_abort(ship_id)  # frees the staging buffers
        super()._abandon_build(sjob)

    def snapshot(self) -> dict:
        snap = super().snapshot()
        snap["dist"] = {
            "spawn": self._spawn_mode,
            "stream_ships": self.stream_ships,
            "rpcs": sum(c.value for c in self._dist_registered
                        if c.name == "serve.dist.rpcs"),
            "rpc_errors": sum(c.value for c in self._dist_registered
                              if c.name == "serve.dist.rpc_errors"),
            "frames": sum(c.value for c in self._dist_registered
                          if c.name == "serve.dist.frames"),
            "frame_bytes": sum(
                c.value for c in self._dist_registered
                if c.name == "serve.dist.frame_bytes"),
            "ship_s_mean": self.ship_window.mean(300.0),
            "ship_s_p95": self.ship_window.quantile(0.95, 300.0),
            "retries": sum(c.value for c in self._dist_registered
                           if c.name == "serve.dist.retries"),
            "reconnects": self._c_reconnects.value,
            "resumed_calls": self._c_resumed.value,
            "parked_results": self._c_parked.value,
            "epoch": self._epoch,
            "ship_wire_hidden_s": self._c_ship_hidden.value,
            "ship_wire_exposed_s": self._c_ship_exposed.value,
            "ship_overlap_efficiency": self._ship_overlap(),
            "telemetry": {
                h.host: {"stale": h.stale,
                         "stale_reason": h.stale_reason,
                         "pulls": h.pulls}
                for h in self.telemetry.hosts.values()
            } if self._federate else None,
        }
        return snap

    def _ship_overlap(self):
        """Fraction of streamed-ship wire time hidden behind source
        prefill: hidden / (hidden + exposed).  None until a streamed
        ship lands."""
        hidden = self._c_ship_hidden.value
        exposed = self._c_ship_exposed.value
        total = hidden + exposed
        return (hidden / total) if total > 0 else None
