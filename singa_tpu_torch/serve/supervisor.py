"""Supervised serve-engine recovery (counterpart of
``singa_tpu/serve/supervisor.py``).

The engine's failure contract (engine.py) is "fail typed, never
wedge": a raising decode/prefill rejects every in-flight and queued
request with :class:`EngineFailedError` and marks the engine dead.
This module is the layer that turns that clean death into continuity:

* **rebuild** — the supervisor constructs a fresh engine with the SAME
  constructor arguments and a fresh KV arena.  The port's captured
  decode steps belong to each engine (their graphs read the engine's
  own buffers), so a rebuilt engine runs each width's first step
  eagerly and captures it again: a restart costs an arena allocation
  and one capture a width the traffic reaches (the JAX engine's jit
  cache is process-wide, so its restart compiles nothing).  Paged engines
  (``paged=`` forwarded verbatim) rebuild with a fresh BLOCK POOL and
  an empty radix tree: no block of the failed pool is ever carried,
  so a corrupting copy fault cannot survive a restart.  Swapped-out
  requests count as STARTED (tokens streamed before the preemption) —
  they are rejected typed, never requeued;
* **requeue** — requests the failed engine had NOT started (rejected
  with ``started=False``) are resubmitted to the new engine in their
  original arrival order; their caller-facing handles resolve as if
  the failure never happened, and their token streams are identical to
  an uninterrupted run (same seed → same private sampling chain).
  Requests that WERE in flight stay failed — tokens may already have
  streamed through ``on_token``, so silently re-running them would
  emit duplicates; the caller sees the typed error and decides;
* **restart budget** — ``restart_budget`` consecutive-lifetime
  restarts; past it, remaining work is rejected with
  :class:`RestartBudgetExceededError` (an engine that keeps dying is a
  bug, not bad luck) and the supervisor refuses further submissions.
  ``budget_reset_after_s`` (default None = consecutive-lifetime, the
  original behavior) forgives spent restarts after that much HEALTHY
  uptime since the last one: a long-lived fleet replica is then only
  condemned by crash-LOOPING (failures closer together than the
  window), never by ancient restarts accumulated over weeks;
* **SLO-pressure load shedding** — with ``shed_on_slo_pressure=True``
  and an :class:`~singa_tpu_torch.observe.health.SLO` carrying
  ``queue_depth_max``, admission beyond that depth sheds the
  lowest-priority queued request (typed :class:`LoadShedError`,
  ``serve.shed_requests{reason=slo_pressure}``) in favor of a
  higher-priority arrival, or refuses the arrival itself when IT is
  the lowest (``reason=slo_admission``) — degrade the cheapest work
  first, before latency collapses for everyone.

Every restart increments ``resilience.engine_restarts`` (the counter
the CI chaos gate matches against injected faults) and shows up under
``health_report()["resilience"]``.
"""

from __future__ import annotations

import time

from ..observe import requests as _reqs
from ..observe import trace as _trace
from ..observe.registry import registry as _registry
from ..utils.logging import get_channel
from .engine import InferenceEngine
from .request import (EngineFailedError, GenerationRequest,
                      LoadShedError, RequestHandle,
                      RestartBudgetExceededError)

__all__ = ["EngineSupervisor"]


class EngineSupervisor:
    """Own and supervise one :class:`InferenceEngine`.

    >>> sup = EngineSupervisor(model, max_slots=4, restart_budget=2)
    >>> h = sup.submit(GenerationRequest(prompt, max_new_tokens=32))
    >>> sup.run_until_complete()
    >>> h.result().tokens        # survives an engine death in between

    ``engine_kw`` is forwarded verbatim to every engine build
    (``max_slots``, ``max_len``, ``slo``, ``top_k`` ...).  Handles
    returned by :meth:`submit` are supervisor-owned: they resolve with
    the final outcome across restarts, not the first engine's."""

    def __init__(self, model, restart_budget=2,
                 budget_reset_after_s=None,
                 shed_on_slo_pressure=False, clock=time.monotonic,
                 **engine_kw):
        if restart_budget < 0:
            raise ValueError(
                f"restart_budget must be >= 0, got {restart_budget}")
        if budget_reset_after_s is not None and budget_reset_after_s <= 0:
            raise ValueError(
                f"budget_reset_after_s must be > 0 or None, got "
                f"{budget_reset_after_s}")
        self._model = model
        self._clock = clock
        self._engine_kw = dict(engine_kw, clock=clock)
        self.restart_budget = int(restart_budget)
        self.budget_reset_after_s = budget_reset_after_s
        self.restarts = 0
        self._last_restart_t = None
        self._shed = bool(shed_on_slo_pressure)
        self._slo = engine_kw.get("slo")
        self._dead = False
        # supervisor-owned completion routing: outer handles resolve
        # across engine generations (outer.request doubles as the
        # requeue source — no separate request map to keep in step)
        self._outer = {}     # request_id -> caller-facing handle
        self._inner = {}     # request_id -> current engine's handle
        self._order = []     # submission order (requeue preserves it)
        self._log = get_channel("serve")
        self._c_restarts = _registry().counter(
            "resilience.engine_restarts",
            help="supervised engine rebuilds after a typed failure")
        self.engine = InferenceEngine(model, **self._engine_kw)

    # -- submission ------------------------------------------------------
    def submit(self, request) -> RequestHandle:
        """Queue a request through the supervisor.  Raises
        :class:`LoadShedError` when SLO-pressure admission sheds the
        arrival itself, and whatever ``engine.submit`` raises
        (``QueueFullError``, ``ValueError``) otherwise."""
        if self._dead:
            raise RestartBudgetExceededError(
                f"supervisor is dead: restart budget "
                f"({self.restart_budget}) exhausted")
        if not isinstance(request, GenerationRequest):
            request = GenerationRequest(request)
        if self.engine._failed:
            # failure surfaced between steps (e.g. caller drove the
            # engine directly): recover before admitting new work
            self._recover()
        self._maybe_shed(request)
        outer = RequestHandle(request)
        inner = self.engine.submit(request)
        rid = request.request_id
        self._outer[rid] = outer
        self._inner[rid] = inner
        self._order.append(rid)
        return outer

    def _maybe_shed(self, incoming):
        """SLO-pressure admission: beyond ``queue_depth_max``, shed the
        lowest-priority queued request if it ranks strictly below the
        arrival, else refuse the arrival itself (both typed
        LoadShedError, both counted in serve.shed_requests)."""
        if not self._shed or self._slo is None \
                or self._slo.queue_depth_max is None:
            return
        if self.engine.scheduler.queue_depth < self._slo.queue_depth_max:
            return
        victim = self.engine.shed(reason="slo_pressure",
                                  below_priority=incoming.priority)
        if victim is not None:
            # the shed victim's handles are supervisor-owned too
            rid = victim.request_id
            inner = self._inner.pop(rid, None)
            outer = self._outer.pop(rid, None)
            if outer is not None and not outer.done():
                err = (inner._error if inner is not None
                       and inner._error is not None
                       else LoadShedError(f"{rid} shed (slo_pressure)"))
                outer._reject(err)
            return
        _registry().counter(
            "serve.shed_requests",
            help="queued requests shed by load-shedding admission",
            reason="slo_admission").inc()
        _trace.event("serve/shed", cat="serve", reason="slo_admission",
                     request=incoming.request_id,
                     priority=incoming.priority)
        _trace.event("serve/request_rejected", cat="serve",
                     request=incoming.request_id,
                     reason="shed:slo_admission")
        if _reqs._active:
            # refused BEFORE any engine accepted it: the ledger still
            # gets a (minimal, terminal) entry so the request log
            # shows the refusal instead of nothing
            _reqs._ledger.on_reject(
                incoming.request_id, t=self._clock(),
                reason="shed:slo_admission", started=False,
                prompt_len=len(incoming.prompt_ids),
                max_new_tokens=incoming.max_new_tokens)
        raise LoadShedError(
            f"{incoming.request_id} refused: queue at SLO pressure "
            f"(depth {self.engine.scheduler.queue_depth} >= "
            f"{self._slo.queue_depth_max}) and no queued request ranks "
            f"below priority {incoming.priority}")

    # -- drive -----------------------------------------------------------
    @property
    def pending(self) -> bool:
        return (not self._dead) and (self.engine.pending
                                     or bool(self._inner))

    def step(self) -> bool:
        """One supervised iteration: drive the engine; on a typed
        engine failure, rebuild it and requeue the never-started
        requests.  Returns ``pending``."""
        if self._dead:
            raise RestartBudgetExceededError(
                f"supervisor is dead: restart budget "
                f"({self.restart_budget}) exhausted")
        try:
            self.engine.step()
        except EngineFailedError:
            self._recover()
        self._sync()
        return self.pending

    def run_until_complete(self, max_steps=None):
        """Drive :meth:`step` until every submitted request resolves
        (normally, or typed).  Raises
        :class:`RestartBudgetExceededError` once the budget is spent —
        by then every outstanding handle is already rejected typed."""
        steps = 0
        while self.pending:
            self.step()
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(
                    f"supervisor did not drain within {max_steps} "
                    f"steps (queue={self.engine.scheduler.queue_depth},"
                    f" live={self.engine.live_slots})")

    def _sync(self):
        """Propagate resolved inner handles to the caller-facing outer
        ones and drop the routing entries."""
        done = [rid for rid, h in self._inner.items() if h.done()]
        for rid in done:
            inner = self._inner.pop(rid)
            outer = self._outer.pop(rid)
            if inner._error is not None:
                outer._reject(inner._error)
            else:
                outer._finish(inner._result)
        if done:
            live = set(self._inner)
            self._order = [r for r in self._order if r in live]

    def _recover(self):
        """Rebuild the failed engine and requeue never-started work;
        enforce the restart budget."""
        failed = self.engine
        step = failed.step_count
        # never-started requests (typed started=False by the engine)
        # are safe to requeue: no tokens streamed, same seed → same
        # chain → identical output to an uninterrupted run
        requeue = [rid for rid in self._order
                   if rid in self._inner
                   and isinstance(self._inner[rid]._error,
                                  EngineFailedError)
                   and self._inner[rid]._error.started is False]
        for rid in requeue:
            self._inner.pop(rid)
        failed.close()  # release registry entries + arena (drained:
        #                 _fail cleared every slot and the queue)
        now = self._clock()
        if (self.budget_reset_after_s is not None and self.restarts > 0
                and self._last_restart_t is not None
                and now - self._last_restart_t
                >= self.budget_reset_after_s):
            # healthy-uptime window elapsed since the last restart:
            # this failure is bad luck, not a crash loop — forgive the
            # spent budget (fleet replicas live for weeks; without
            # this, ancient restarts eventually condemn them)
            self._log.info(
                "restart budget reset after %.1fs healthy uptime "
                "(%d prior restarts forgiven)",
                now - self._last_restart_t, self.restarts)
            self.restarts = 0
        self._last_restart_t = now
        self.restarts += 1
        self._c_restarts.inc()
        _trace.event("serve/engine_restart", cat="serve",
                     restart=self.restarts, failed_step=step,
                     requeued=len(requeue))
        if self.restarts > self.restart_budget:
            self._dead = True
            err = RestartBudgetExceededError(
                f"restart budget exhausted ({self.restarts - 1} "
                f"restarts allowed); engine keeps failing")
            self._log.error("%s — rejecting %d remaining requests",
                            err, len(requeue))
            t_rej = self._clock()
            for rid in requeue:
                outer = self._outer.pop(rid, None)
                if outer is not None and not outer.done():
                    _trace.event("serve/request_rejected", cat="serve",
                                 request=rid,
                                 reason="restart_budget_exceeded")
                    if _reqs._active:
                        # the engine already sealed this timeline as a
                        # requeue-safe failure; this marks the
                        # supervisor's TERMINAL verdict on it
                        _reqs._ledger.on_reject(
                            rid, t=t_rej,
                            reason="restart_budget_exceeded",
                            started=False)
                    outer._reject(RestartBudgetExceededError(
                        f"{rid}: {err}", request_id=rid,
                        started=False))
            self._sync()
            raise err
        self._log.warning(
            "engine failed at step %d; restart %d/%d (requeueing %d "
            "never-started requests)", step, self.restarts,
            self.restart_budget, len(requeue))
        self.engine = InferenceEngine(self._model, **self._engine_kw)
        for rid in requeue:
            self._inner[rid] = self.engine.submit(
                self._outer[rid].request)
            if _reqs._active:
                # engine.submit reopened the timeline with a hop on
                # the REBUILT engine; say why the hop exists
                _reqs._ledger.annotate_hop(rid, via="supervisor_restart",
                                           restart=self.restarts)

    # -- disaggregated prefill / KV shipping (fleet-driven) --------------
    # Thin supervised wrappers over the engine's ship APIs: the fleet
    # never reaches a dead or failed engine through them.  A chunk
    # fault mid-build fails the ENGINE typed (the engine's contract);
    # the wrapper rebuilds it — restart budget enforced — and reports
    # the build dead by returning None, so the fleet restarts it from
    # scratch (nothing streamed: a replayed build is byte-identical).

    def _ship_guard(self):
        if self._dead:
            raise RestartBudgetExceededError(
                f"supervisor is dead: restart budget "
                f"({self.restart_budget}) exhausted")
        if self.engine._failed:
            self._recover()

    def start_prefix_build(self, prompt_ids):
        self._ship_guard()
        return self.engine.start_prefix_build(prompt_ids)

    def advance_prefix_build(self, job, max_tokens=None, rid=None):
        """True when complete, False when budget ran out first, None
        when the engine died mid-chunk and was rebuilt (the job is
        invalid — restart the build).  Raises
        :class:`RestartBudgetExceededError` once the budget is
        spent."""
        self._ship_guard()
        try:
            return self.engine.advance_prefix_build(
                job, max_tokens, rid=rid)
        except EngineFailedError:
            self._recover()
            self._sync()
            return None

    def export_prefix_image(self, job):
        self._ship_guard()
        return self.engine.export_prefix_image(job)

    def admit_prefix_image(self, tokens, image):
        self._ship_guard()
        return self.engine.admit_prefix_image(tokens, image)

    def abandon_prefix_build(self, job):
        if not self.engine._closed:
            self.engine.abandon_prefix_build(job)

    def abandon(self, reason="fleet failover"):
        """Fleet failover entry point: mark this supervisor dead WITHOUT
        driving the (possibly wedged) engine, and reject every
        outstanding handle typed — ``started=True`` for requests
        occupying a slot (tokens may already have streamed),
        ``started=False`` for queued/admitting ones (safe for the
        fleet to requeue on a sibling — it re-derives the requeue set
        from the rejected handles' ``started`` flags, so there is ONE
        mechanism deciding re-runnability, not two).  Idempotent: a
        supervisor that already died (budget exhausted) is a no-op —
        its handles are already rejected typed with the same started
        semantics, so the fleet's requeue scan works identically
        either way."""
        if self._dead:
            return
        self._dead = True
        started_ids = self.engine.live_request_ids
        step = self.engine.step_count
        t_ab = self._clock()
        n_requeueable = 0
        for rid in list(self._order):
            inner = self._inner.pop(rid, None)
            outer = self._outer.pop(rid, None)
            if outer is None or outer.done():
                continue
            if inner is not None and inner.done():
                # resolved in the engine but not yet synced: propagate
                # the real outcome, don't overwrite it with an abandon
                if inner._error is not None:
                    outer._reject(inner._error)
                else:
                    outer._finish(inner._result)
                continue
            started = rid in started_ids
            _trace.event("serve/request_rejected", cat="serve",
                         request=rid, reason="abandoned",
                         started=started)
            if _reqs._active:
                # the engine never drove this rejection (abandon does
                # not touch a possibly-wedged engine), so the ledger
                # seal happens here; started=False entries reopen when
                # the fleet requeues them on a sibling
                _reqs._ledger.on_reject(rid, t=t_ab,
                                        reason=f"abandoned:{reason}",
                                        started=started)
            outer._reject(EngineFailedError(
                f"{rid}: supervisor abandoned at step {step} ({reason})",
                request_id=rid, started=started, engine_step=step))
            if not started:
                n_requeueable += 1
        self._order = []
        self._inner.clear()
        self._outer.clear()
        self._log.warning(
            "supervisor abandoned (%s): %d never-started requests "
            "rejected requeue-safe", reason, n_requeueable)
        _trace.event("serve/supervisor_abandon", cat="serve",
                     reason=str(reason), requeue=n_requeueable)

    def close(self, force=False):
        if not self.engine._closed:
            self.engine.close(force=force)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        if self.engine._closed:
            return False
        return self.engine.__exit__(exc_type, *a)
