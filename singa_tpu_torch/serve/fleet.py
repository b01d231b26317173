"""Replicated serve fleet: N engine replicas behind a health-checked
router (counterpart of ``singa_tpu/serve/fleet.py``).

One continuous-batching engine is one failure domain: a wedged decode,
an exhausted restart budget or one slow replica takes every caller down
with it.  This module routes around replica loss for the in-process
engine:

* **fleet**: :class:`ServeFleet` owns N
  :class:`~singa_tpu_torch.serve.supervisor.EngineSupervisor`-wrapped
  engine replicas.  Replicas share the MODEL (one copy of the weights on
  the device) but own their KV arena, prefix cache and captured decode
  steps: a port engine's CUDA graphs read its own buffers, so each
  replica captures its decode widths once, at its warm-up, and a revived
  or added replica captures them anew (the JAX fleet shares one jit
  cache and compiles once).  No graph is captured after a replica's
  warm-up; the fleet logs the count each replica captures;
* **router**: :class:`Router` scores every healthy replica on queue
  depth, slot occupancy and the TPOT EWMA of ``EngineStats`` (a degrading
  replica prices itself out of new admissions), replicas past the SLO's
  ``queue_depth_max`` behind those with headroom; ties go to the
  least-recently-routed replica.  ``pin_session`` continuations route
  STICKY to the replica whose radix tree holds the pinned blocks (any
  other serves them cold but correct);
* **failover**: a replica whose heartbeat source latched a hang (the
  watchdog of ``observe.monitor``) or whose supervisor exhausted its
  restart budget is marked unhealthy; its never-started requests
  (``started=False``: no token streamed, and the same seed gives the
  same threefry chain) are REQUEUED onto healthy siblings in arrival
  order with streams equal to an uninterrupted run, and its started
  requests fail typed.  ``revive()`` rebuilds a failed replica;
* **degradation**: an arrival refused by one replica's SLO-pressure
  admission tries the next, so a request is shed only when no healthy
  replica holds lower-priority work (``LoadShedError``), and with every
  replica gone submission fails typed
  (:class:`~singa_tpu_torch.serve.request.FleetDownError`);
* **hedging** (``hedge_after_steps``): a request stuck un-started behind
  a slow replica's admission for that many fleet steps is re-dispatched
  to the least-loaded sibling; the first completion wins (identical
  tokens either way: same seed, same key chain).  Streaming
  (``on_token``) and session requests never hedge;
* **disaggregated prefill/decode** (``roles=``): a long admission routes
  to a **prefill specialist**, which builds the prompt's canonical-KV
  block prefix with the chunk passes, then SHIPS the blocks to a
  **decode specialist** as a versioned host image
  (``serve/kvimage.py``): gather on the source, a validated image,
  scatter and radix-tree adoption on the destination, whose admission
  is then a local warm hit.  A host-side residency index
  (:class:`~singa_tpu_torch.serve.prefix.FleetPrefixIndex`, verified
  against live trees at use) lets a prefix resident on ANY replica seed
  an export instead of a re-prefill, and prefix-hash sticky destinations
  keep each hot prefix on few replicas.  Degenerate fleets fall back to
  mixed roles, and every mid-ship failure (the ``serve.kv_ship`` fault,
  destination capacity, a dying specialist) requeues the request cold
  but correct: nothing streams during a ship.

Metrics ride the observe registry as ``serve.fleet.{replicas_healthy,
replicas_routable,failovers,requeues,routed,hedges,ships,ship_bytes,
shared_prefix_hits,ship_fallbacks}`` labeled ``{fleet=,replica=}`` (the
ship family fleet-wide) and surface in
``health_report()["serve"]["fleet"]``; the ``serve.route`` fault site
covers admission routing and ``serve.kv_ship`` both halves of a ship.

Sharded replicas (``tp=``, ``ep=``, ``pp=``): each replica is a rank
group of its own (``fleet_tp_configs`` / ``fleet_ep_configs`` /
``fleet_pp_configs``, ``serve/shard.py``): rank 0 runs every replica's
engine and holds its first shard, the replica's other shards are mirror
ranks of its own.  It runs over gloo on the CPU or on one card (a typed
``FleetLayoutError`` otherwise).  A sharded fleet cannot
``add_replica``.
"""

from __future__ import annotations

import itertools
import time
import weakref
import zlib

import numpy as np

from ..observe import monitor as _monitor
from ..observe import requests as _reqs
from ..observe import trace as _trace
from ..observe.registry import registry as _registry
from ..resilience import faults as _faults
from ..utils.logging import get_channel
from .paged import PagedConfig
from .prefix import FleetPrefixIndex
from .request import (EngineFailedError, FleetDownError,
                      GenerationRequest, LoadShedError, QueueFullError,
                      RequestHandle, RestartBudgetExceededError)
from .supervisor import EngineSupervisor

__all__ = ["Router", "ServeFleet"]

_fleet_ids = itertools.count()

#: score penalty for a replica past its SLO queue-depth headroom: large
#: enough to rank every pressured replica behind every unpressured one
#: (real scores are O(queue_depth)), small enough to still order the
#: pressured ones among themselves.
_PRESSURE_PENALTY = 1e6


class Router:
    """Least-loaded / SLO-headroom scoring over replica views.

    A view is the host-side load sample the fleet takes per candidate:
    ``{"replica": idx, "queue_depth": int, "occupancy": float,
    "tpot_ewma": float | None, "queue_headroom": int | None,
    "blocks_used_frac": float | None}`` (the last only on paged
    replicas — KV-pool pressure).
    ``score`` is a weighted sum — queue depth (requests ahead of this
    one), occupancy (live slots / max_slots), and the TPOT EWMA
    normalized by the fleet-wide best (a replica decoding 3x slower
    than its healthiest sibling carries a 3x term; with no samples the
    term is 0) — plus a large penalty when the replica sits at/past
    ``SLO.queue_depth_max``.  ``rank`` returns candidate indices
    best-first; ties break on LEAST-RECENTLY-ROUTED (the logical
    route tick the fleet feeds through :meth:`note_routed`), then
    replica index — deterministic, and cold traffic after a
    fleet-wide drain spreads across equal-scored replicas instead of
    piling onto replica 0.  Role-typed fleets price prefill
    specialists SEPARATELY (:meth:`score_prefill`: build-queue depth
    only — specialists hold no decode lanes, so TPOT and block
    pressure never enter their score).  Subclass and override
    ``score`` for custom policies."""

    def __init__(self, w_queue=1.0, w_occupancy=1.0, w_tpot=1.0,
                 w_blocks=1.0, w_prefill=1.0):
        self.w_queue = float(w_queue)
        self.w_occupancy = float(w_occupancy)
        self.w_tpot = float(w_tpot)
        self.w_blocks = float(w_blocks)
        self.w_prefill = float(w_prefill)
        # least-recently-routed tie-break state: replica -> logical
        # tick of its last admission (never wall time — deterministic)
        self._routed_tick = {}
        self._route_ticks = itertools.count(1)

    def note_routed(self, idx):
        """Record an admission to replica ``idx`` (the fleet calls
        this on every successful route / ship destination): the
        tie-break currency of :meth:`rank`."""
        self._routed_tick[idx] = next(self._route_ticks)

    def score(self, view, tpot_base) -> float:
        s = (self.w_queue * view["queue_depth"]
             + self.w_occupancy * view["occupancy"])
        ewma = view.get("tpot_ewma")
        if ewma is not None and tpot_base:
            s += self.w_tpot * (ewma / tpot_base)
        # paged replicas: KV-pool pressure (new admissions on a nearly
        # full pool preempt/swap — route around it before the thrash)
        blocks = view.get("blocks_used_frac")
        if blocks is not None:
            s += self.w_blocks * blocks
        headroom = view.get("queue_headroom")
        if headroom is not None and headroom <= 0:
            s += _PRESSURE_PENALTY
        return s

    def rank(self, views) -> list:
        """Replica indices best-first (ties: least-recently-routed,
        then index — see the class docstring)."""
        ewmas = [v["tpot_ewma"] for v in views
                 if v.get("tpot_ewma")]
        base = min(ewmas) if ewmas else None
        scored = sorted(
            ((self.score(v, base),
              self._routed_tick.get(v["replica"], 0),
              v["replica"]) for v in views))
        return [t[-1] for t in scored]

    def score_prefill(self, view) -> float:
        """Prefill-specialist score: the depth of ship builds queued
        on the replica — the only load a specialist carries."""
        return self.w_prefill * view.get("prefill_depth", 0)

    def rank_prefill(self, views) -> list:
        """Prefill-specialist indices best-first, same tie-break
        discipline as :meth:`rank`."""
        scored = sorted(
            ((self.score_prefill(v),
              self._routed_tick.get(v["replica"], 0),
              v["replica"]) for v in views))
        return [t[-1] for t in scored]


class _Replica:
    """Fleet-side bookkeeping for one supervised engine replica.

    ``draining``: excluded from NEW routing but still driven every
    step (it finishes its live work — the scale-down half-state).
    ``retired``: drained and closed by ``retire_replica`` — its
    engine's ``serve.*{engine=n}`` metrics are unregistered (the
    frozen-gauge fix) and it is skipped by health/snapshot until
    ``revive()`` reuses the slot."""

    __slots__ = ("idx", "sup", "healthy", "needs_failover",
                 "down_error", "draining", "retired",
                 "reconnect_deadline")

    def __init__(self, idx, sup):
        self.idx = idx
        self.sup = sup
        self.healthy = True
        self.needs_failover = False
        self.down_error = None
        self.draining = False
        self.retired = False
        # monotonic deadline while the replica's transport is inside
        # its reconnect(+grace) window (serve/dist): the autoscaler's
        # _replace_dead must not respawn a peer about to resume
        self.reconnect_deadline = None


class _Route:
    """One fleet request's routing state: the caller-facing handle and
    every dispatch attempt ``(replica_idx, supervisor_handle)`` made
    for it (one normally; two when hedged or requeued).  A route with
    NO attempts is mid-ship (queued or building on a prefill
    specialist — the decode submission happens once the KV lands).
    ``ship_release`` pins the shipped prefix in the destination's
    radix tree until the request resolves."""

    __slots__ = ("handle", "attempts", "submit_step", "hedged",
                 "ship_release")

    def __init__(self, handle, step):
        self.handle = handle
        self.attempts = []
        self.submit_step = step
        self.hedged = False
        self.ship_release = None


class _ShipJob:
    """One disaggregated admission's prefill-and-ship state: which
    specialist is (re)building the prefix, the engine-side build, and
    whether the prefix was already RESIDENT somewhere (the
    shared-prefix-hit path — exported, never recomputed)."""

    __slots__ = ("rid", "route", "request", "src", "job", "hit")


class ServeFleet:
    """N data-parallel engine replicas behind a health-checked router.

    >>> fleet = model.serve_fleet(replicas=2, max_slots=4)
    >>> h = fleet.submit(GenerationRequest(prompt, max_new_tokens=32))
    >>> fleet.run_until_complete()
    >>> h.result().tokens     # survives a replica death in between

    ``engine_kw`` is forwarded verbatim to every replica's engine
    (``max_slots``, ``max_len``, ``slo``, ``prefix_cache``, ...);
    ``restart_budget``/``budget_reset_after_s``/``shed_on_slo_pressure``
    go to every supervisor.  Handles are fleet-owned: they resolve with
    the final outcome across restarts AND failovers.

    ``roles``: one of ``"prefill"`` / ``"decode"`` / ``"mixed"`` per
    replica (default: all mixed — the classic symmetric fleet).  Any
    role-typed fleet requires ``paged=`` and ``prefix_cache=`` in the
    engine kwargs (the ship format is the paged host image and
    cross-replica residency lives in the radix tree); disaggregated
    shipping activates when both a prefill and a decode-capable side
    exist and falls back to classic routing otherwise:

    >>> fleet = model.serve_fleet(
    ...     replicas=4, roles=("prefill", "prefill", "decode",
    ...                        "decode"),
    ...     paged=PagedConfig(block_size=16, num_blocks=96),
    ...     prefix_cache=PrefixCacheConfig(block_size=16))"""

    def __init__(self, model, replicas=2, router=None, restart_budget=2,
                 budget_reset_after_s=None, shed_on_slo_pressure=False,
                 hedge_after_steps=None, clock=time.monotonic,
                 roles=None, **engine_kw):
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        self.roles = self._parse_roles(roles, replicas)
        self._disagg = ("prefill" in self.roles
                        and any(r != "prefill" for r in self.roles))
        self._block_size = None
        self._prefix_index = None
        self._ship_jobs = []
        if any(r != "mixed" for r in self.roles):
            pc = engine_kw.get("paged")
            cache_cfg = engine_kw.get("prefix_cache")
            if pc is None or pc is False or cache_cfg is None \
                    or cache_cfg is False:
                raise ValueError(
                    "role-typed fleets (roles=) require paged= AND "
                    "prefix_cache= in the engine kwargs: the KV ship "
                    "format is the paged host image and cross-replica "
                    "residency lives in the radix tree")
            if pc is True:
                pc = PagedConfig()
            elif isinstance(pc, dict):
                pc = PagedConfig(**pc)
            self._block_size = pc.block_size
            self._prefix_index = FleetPrefixIndex(pc.block_size)
        if hedge_after_steps is not None and hedge_after_steps < 1:
            raise ValueError(
                f"hedge_after_steps must be >= 1 or None, got "
                f"{hedge_after_steps}")
        if budget_reset_after_s is not None and budget_reset_after_s <= 0:
            # the supervisor would reject this too, but only after the
            # fleet registered its metrics — validate before any side
            # effect
            raise ValueError(
                f"budget_reset_after_s must be > 0 or None, got "
                f"{budget_reset_after_s}")
        self._model = model
        self._clock = clock
        self._engine_kw = dict(engine_kw)
        # sharded replicas (serve/tp.py, ep.py, pp.py): a fleet of
        # sharded engines partitions the ranks — replica i is a rank
        # group of its own (serve/shard.py: rank 0 holds every
        # replica's first shard), sharding inside each
        # replica and data parallelism across them.  Validated here
        # (the process group must hold them) and pinned per replica so
        # a supervisor rebuild or revive() lands on the SAME group.
        self._tp_cfgs = None
        self._par_key = "tp"
        cuda = getattr(getattr(model, "transformer", None), "wte", None)
        cuda = cuda is not None and cuda.W.device.type == "cuda"
        if engine_kw.get("tp") not in (None, False):
            from .tp import fleet_tp_configs

            self._tp_cfgs = fleet_tp_configs(engine_kw["tp"], replicas,
                                             cuda)
        elif engine_kw.get("ep") not in (None, False):
            from .ep import fleet_ep_configs

            self._par_key = "ep"
            self._tp_cfgs = fleet_ep_configs(engine_kw["ep"], replicas,
                                             cuda)
        elif engine_kw.get("pp") not in (None, False):
            from .pp import fleet_pp_configs

            self._par_key = "pp"
            self._tp_cfgs = fleet_pp_configs(engine_kw["pp"], replicas,
                                             cuda)
        self._sup_kw = dict(
            restart_budget=restart_budget,
            budget_reset_after_s=budget_reset_after_s,
            shed_on_slo_pressure=shed_on_slo_pressure, clock=clock)
        self.router = router if router is not None else Router()
        self._slo = engine_kw.get("slo")
        self.hedge_after_steps = hedge_after_steps
        self.fleet_label = str(next(_fleet_ids))
        self._log = get_channel("serve")
        reg = _registry()
        self._reg = reg
        lbl = dict(fleet=self.fleet_label)
        self._g_healthy = reg.gauge(
            "serve.fleet.replicas_healthy",
            help="replicas currently healthy (draining included — "
                 "they still serve their live work)", **lbl)
        self._g_routable = reg.gauge(
            "serve.fleet.replicas_routable",
            help="replicas the router currently admits NEW work to "
                 "(healthy minus draining/retired)", **lbl)
        self._c_routed, self._c_failovers = [], []
        self._c_requeues, self._c_hedges = [], []
        for i in range(replicas):
            rl = dict(lbl, replica=str(i))
            self._c_routed.append(reg.counter(
                "serve.fleet.routed",
                help="requests admitted to this replica", **rl))
            self._c_failovers.append(reg.counter(
                "serve.fleet.failovers",
                help="times this replica was failed out of the "
                     "routing set", **rl))
            self._c_requeues.append(reg.counter(
                "serve.fleet.requeues",
                help="never-started requests moved OFF this replica "
                     "onto healthy siblings", **rl))
            self._c_hedges.append(reg.counter(
                "serve.fleet.hedges",
                help="hedged re-dispatches admitted TO this replica",
                **rl))
        self._c_ships = reg.counter(
            "serve.fleet.ships",
            help="completed KV ships: a prefix built (or resident) on "
                 "one replica landed warm in another replica's pool",
            **lbl)
        self._c_ship_bytes = reg.counter(
            "serve.fleet.ship_bytes",
            help="host bytes moved by completed KV ships", **lbl)
        self._c_shared_hits = reg.counter(
            "serve.fleet.shared_prefix_hits",
            help="admissions served warm through the FLEET prefix "
                 "index — a resident prefix exported without "
                 "recompute, or routed to its resident decode replica "
                 "— instead of a cold re-prefill", **lbl)
        self._c_ship_fallbacks = reg.counter(
            "serve.fleet.ship_fallbacks",
            help="ships abandoned mid-flight (fault, capacity, "
                 "failover): the request was requeued cold-but-"
                 "correct, never lost", **lbl)
        self._registered = ([self._g_healthy, self._g_routable]
                            + self._c_routed
                            + self._c_failovers + self._c_requeues
                            + self._c_hedges
                            + [self._c_ships, self._c_ship_bytes,
                               self._c_shared_hits,
                               self._c_ship_fallbacks])
        self._captures = {}      # replica -> (engine, graphs seen)
        try:
            self._replicas = [_Replica(i, self._new_supervisor(i))
                              for i in range(replicas)]
        except BaseException:
            self._leave_groups()
            raise
        self._refresh_gauges()
        # fleet-owned completion routing (the supervisor pattern, one
        # level up: routes resolve across restarts AND failovers)
        self._routes = {}        # request_id -> _Route
        self._order = []         # fleet arrival order (requeue order)
        # SessionHandle -> replica idx (weak: a dropped session must
        # not pin the mapping, and identity is the only safe key)
        self._sessions = weakref.WeakKeyDictionary()
        self.step_count = 0
        self._closed = False
        self._log.info(
            "fleet up: %d replicas x (slots=%d) roles=%s [fleet=%s]",
            replicas, self._replicas[0].sup.engine.max_slots,
            ",".join(self.roles), self.fleet_label)

    @staticmethod
    def _parse_roles(roles, replicas):
        if roles is None:
            return ("mixed",) * replicas
        roles = tuple(roles)
        if len(roles) != replicas:
            raise ValueError(
                f"roles has {len(roles)} entries for {replicas} "
                f"replicas — one role per replica")
        bad = sorted({r for r in roles
                      if r not in ("prefill", "decode", "mixed")})
        if bad:
            raise ValueError(
                f"unknown role(s) {bad!r}: each replica is 'prefill',"
                f" 'decode', or 'mixed'")
        return roles

    def _new_supervisor(self, idx) -> EngineSupervisor:
        """Build replica ``idx``'s supervisor: the one construction seam
        of every path that creates replica capacity (``__init__``,
        ``revive()``, ``add_replica()``); ``serve/dist/fleet.py``
        overrides it to spawn a worker and return an RPC proxy."""
        return EngineSupervisor(self._model, **self._sup_kw,
                                **self._replica_kw(idx))

    def _replica_kw(self, idx):
        """Engine kwargs for replica ``idx``: the shared engine_kw, with
        the sharded knob (``tp``/``ep``/``pp``) swapped for the
        replica's pinned rank-group config, so a supervisor rebuild or
        ``revive()`` lands on the SAME group."""
        if self._tp_cfgs is None:
            return self._engine_kw
        kw = dict(self._engine_kw)
        kw[self._par_key] = self._tp_cfgs[idx]
        return kw

    def _note_captures(self, rep):
        """Log the decode graphs replica ``rep``'s engine has captured
        since the last look: a replica captures each width it reaches
        once, at its warm-up (a revived or added replica anew)."""
        eng = rep.sup.engine
        n = len(getattr(eng, "_steps", ()))
        seen = self._captures.get(rep.idx)
        if seen is None or seen[0] is not eng:
            seen = (eng, 0)
        if n > seen[1]:
            self._log.info("replica %d captured %d decode graph(s) "
                           "(%d in all)", rep.idx, n - seen[1], n)
            _trace.event("serve/fleet_captures", cat="serve",
                         replica=rep.idx, new=n - seen[1], total=n)
        self._captures[rep.idx] = (eng, n)

    # -- introspection ---------------------------------------------------
    @property
    def replicas(self) -> int:
        """Replica slots (retired ones included — a retired slot can
        be revived, so it still counts as capacity)."""
        return len(self._replicas)

    @property
    def healthy_replicas(self) -> int:
        return sum(r.healthy for r in self._replicas)

    @staticmethod
    def _routable(rep) -> bool:
        """True when the router may send NEW work here: healthy, not
        retired, not draining toward a scale-down."""
        return rep.healthy and not rep.draining and not rep.retired

    @property
    def routable_replicas(self) -> int:
        return sum(self._routable(r) for r in self._replicas)

    def _refresh_gauges(self):
        self._g_healthy.set(self.healthy_replicas)
        self._g_routable.set(self.routable_replicas)

    @property
    def pending(self) -> bool:
        """True while any fleet-submitted request is unresolved."""
        return bool(self._routes)

    def supervisor(self, idx) -> EngineSupervisor:
        """The replica's current supervisor (tests, debuggers)."""
        return self._replicas[idx].sup

    def health(self) -> dict:
        """Per-replica health view: the router's input plus status.
        Retired replicas are DROPPED (their engines are closed and
        their metrics unregistered — a scale-down must not leave a
        frozen per-replica row behind)."""
        out = {}
        for rep in self._replicas:
            if rep.retired:
                continue
            eng = rep.sup.engine
            out[rep.idx] = {
                "healthy": rep.healthy,
                "draining": rep.draining,
                "restarts": rep.sup.restarts,
                "queue_depth": (eng.scheduler.queue_depth
                                if not eng._closed else 0),
                "live_slots": eng.live_slots if not eng._closed else 0,
                "tpot_ewma_s": eng.stats.tpot_ewma,
            }
        return out

    def load_views(self) -> list:
        """The router-signal views the fleet itself routes on (queue
        depth, occupancy, tpot_ewma, blocks_used_frac, draining flag),
        one per non-retired healthy replica — the autoscaler's input
        surface (serve/autoscale.py)."""
        return [self._view(r) for r in self._replicas
                if r.healthy and not r.retired]

    def snapshot(self) -> dict:
        """Fleet-level stats.
        Retired replicas keep their lifetime ``routed`` counts (the
        fleet-labeled counters are fleet-lifetime) but contribute no
        ``engines`` entry — their engine metrics are unregistered."""
        return {
            "replicas": sum(not r.retired for r in self._replicas),
            "replicas_healthy": self.healthy_replicas,
            # add-only (autoscale round): scale-state visibility
            "replicas_routable": self.routable_replicas,
            "replicas_draining": sum(r.draining
                                     for r in self._replicas),
            "replicas_retired": sum(r.retired for r in self._replicas),
            "roles": list(self.roles),
            "failovers": sum(c.value for c in self._c_failovers),
            "requeues": sum(c.value for c in self._c_requeues),
            "hedges": sum(c.value for c in self._c_hedges),
            "routed": {str(i): c.value
                       for i, c in enumerate(self._c_routed)},
            "ships": self._c_ships.value,
            "ship_bytes": self._c_ship_bytes.value,
            "shared_prefix_hits": self._c_shared_hits.value,
            "ship_fallbacks": self._c_ship_fallbacks.value,
            "engines": [rep.sup.engine.stats.snapshot()
                        for rep in self._replicas if not rep.retired],
        }

    # -- admission -------------------------------------------------------
    def submit(self, request) -> RequestHandle:
        """Route a request to the best healthy replica.  Raises
        :class:`FleetDownError` when none is healthy,
        :class:`QueueFullError` when every healthy replica is at
        back-pressure, and :class:`LoadShedError` when SLO-pressure
        admission refuses it fleet-wide (no healthy replica holds
        lower-priority work to shed)."""
        if self._closed:
            raise RuntimeError(
                "fleet is closed; build a new one with "
                "model.serve_fleet()")
        if not isinstance(request, GenerationRequest):
            request = GenerationRequest(np.asarray(request))
        rid = request.request_id
        if rid in self._routes:
            raise ValueError(
                f"request_id {rid!r} is already in flight fleet-wide")
        if _faults._armed:
            # chaos hook: a raising router admission is a SYNCHRONOUS
            # typed failure for the caller — nothing was accepted
            _faults.check("serve.route")
        handle = RequestHandle(request)
        route = _Route(handle, self.step_count)
        prefer = None
        if self._ship_eligible(request):
            # ONE warm-target scan decides the path: resident on a
            # decode replica -> route there warm (no ship), else park
            # a ship job (the scan walks live radix trees — never pay
            # it twice on the admission hot path)
            prefer = self._warm_decode_target(request)
            if prefer is None:
                # an infeasible request (position space, worst-case
                # blocks) must fail the CALLER synchronously, exactly
                # as a direct submit would — parking it on a ship job
                # would wedge the fleet on a request no engine can
                # ever accept.  Replicas share statics, so any
                # healthy engine's feasibility check speaks for all
                idx0 = next(r.idx for r in self._replicas
                            if r.healthy)
                self._replicas[idx0].sup.engine.validate_request(
                    request)
                # disaggregated admission: the request parks on a
                # ship job (queued -> built on a prefill specialist
                # -> KV shipped) and the decode submission happens in
                # _drive_ships once the blocks land — nothing streams
                # until then, so every ship failure mode replays cold
                # with byte-identical output
                self._routes[rid] = route
                self._order.append(rid)
                self._enqueue_ship(request, route)
                return handle
        elif self._disagg:
            # not ship-eligible (short, sticky, queue-full, a side
            # down) but the fleet cache may still warm-route it
            prefer = self._warm_decode_target(request)
        try:
            idx, inner = self._route(request, prefer=prefer)
        except FleetDownError:
            _trace.event("serve/request_rejected", cat="serve",
                         request=rid, reason="fleet_down")
            if _reqs._active:
                # no replica ever accepted it: give the request log a
                # terminal entry anyway (requests refused by a downed
                # fleet must not vanish from observability)
                _reqs._ledger.on_reject(
                    rid, t=self._clock(), reason="fleet_down",
                    started=False,
                    prompt_len=len(request.prompt_ids),
                    max_new_tokens=request.max_new_tokens)
            raise
        if _reqs._active:
            # engine.submit (inside the supervisor) opened the hop;
            # stamp WHICH replica the router chose on it
            _reqs._ledger.annotate_hop(rid, replica=idx)
        if prefer is not None and idx == prefer:
            # fleet-index warm routing: the replica's live tree holds
            # the whole shippable prefix, so this admission lands
            # warm WITHOUT a ship or a re-prefill
            self._c_shared_hits.inc()
            if _reqs._active:
                _reqs._ledger.annotate_hop(rid, shared_prefix=True)
        route.attempts.append((idx, inner))
        self._routes[rid] = route
        self._order.append(rid)
        # a replica may have died during routing (budget exhausted
        # surfacing in submit): move its work before returning
        self._drain_failovers()
        return handle

    def _route(self, request, exclude=(), prefer=None):
        """Admit ``request`` to the first candidate that takes it.
        Tries sticky, then the ``prefer`` hint (fleet-index warm
        routing), then router-ranked healthy decode-capable replicas;
        QueueFull / LoadShed at one replica falls through to the next
        (which is what makes shedding and back-pressure FLEET-wide
        decisions)."""
        last_refusal = None   # QueueFull/LoadShed from a live replica
        last_death = None     # budget exhaustion surfacing at admission
        tried = 0
        for idx in self._candidates(request, exclude, prefer):
            rep = self._replicas[idx]
            tried += 1
            try:
                inner = rep.sup.submit(request)
            except (QueueFullError, LoadShedError) as e:
                last_refusal = e
                continue
            except RestartBudgetExceededError as e:
                # the replica died between steps (failure surfaced at
                # admission): mark it down, keep routing — its
                # outstanding work moves in _drain_failovers
                self._mark_down(rep, e)
                last_death = e
                continue
            self._c_routed[idx].inc()
            nr = getattr(self.router, "note_routed", None)
            if nr is not None:
                # least-recently-routed tie-break currency (custom
                # routers without the hook simply keep index ties)
                nr(idx)
            return idx, inner
        if tried == 0 or self.healthy_replicas == 0:
            raise FleetDownError(
                f"no healthy replica ({self.healthy_replicas} of "
                f"{len(self._replicas)}); revive() one or build a new "
                f"fleet", started=False)
        if last_refusal is not None:
            # a replica dying at admission must not mask a healthy
            # sibling's back-pressure: the caller's typed error is the
            # one that describes the replicas still serving
            raise last_refusal
        raise last_death

    def _candidates(self, request, exclude=(), prefer=None):
        """Candidate replica indices, best-first: the sticky session
        target, then the warm-prefix ``prefer`` hint, then the
        router's ranking of the decode-capable pool."""
        out = []
        sess = getattr(request, "session_of", None)
        if sess is not None:
            idx = self._sessions.get(sess)
            if (idx is not None and idx not in exclude
                    and self._routable(self._replicas[idx])):
                out.append(idx)
        if (prefer is not None and prefer not in exclude
                and prefer not in out
                and self._routable(self._replicas[prefer])):
            out.append(prefer)
        views = [self._view(self._replicas[i])
                 for i in self._decode_pool(exclude)
                 if i not in out]
        out.extend(self.router.rank(views))
        return out

    def _decode_pool(self, exclude=()):
        """Replica indices decode traffic may land on: healthy
        non-prefill replicas — falling back to EVERY healthy replica
        when none exists (the degenerate-fleet mixed-role fallback: a
        1-replica, all-prefill, or dead-decode-side fleet still
        serves every request, cold but correct)."""
        out = [r.idx for r in self._replicas
               if self._routable(r) and r.idx not in exclude
               and self.roles[r.idx] != "prefill"]
        if not out:
            # degenerate-fleet fallback: a draining replica still
            # beats refusing traffic (drain is a preference, not a
            # correctness rule), but a retired one is CLOSED — never
            # a candidate
            out = [r.idx for r in self._replicas
                   if r.healthy and not r.retired
                   and r.idx not in exclude]
        return out

    def _view(self, rep) -> dict:
        eng = rep.sup.engine
        depth = eng.scheduler.queue_depth
        headroom = None
        if self._slo is not None \
                and self._slo.queue_depth_max is not None:
            headroom = self._slo.queue_depth_max - depth
        arena = eng.paged_arena
        return {
            "replica": rep.idx,
            "role": self.roles[rep.idx],
            # scale-down half-state: still serving its live work but
            # closed to new routing (the autoscaler reads this)
            "draining": rep.draining,
            "queue_depth": depth,
            "occupancy": eng.live_slots / eng.max_slots,
            "tpot_ewma": eng.stats.tpot_ewma,
            "queue_headroom": headroom,
            # role-typed fleets: ship builds queued on this replica —
            # the prefill side's load signal, priced separately from
            # every decode signal above (Router.score_prefill)
            "prefill_depth": sum(1 for s in self._ship_jobs
                                 if s.src == rep.idx),
            # paged replicas: fraction of the KV pool in use (live
            # slots + cached blocks; swapped requests hold none but
            # will re-allocate on resume) — a replica whose pool is
            # nearly full will preempt/swap new admissions, so it
            # prices itself up before the thrash starts
            "blocks_used_frac": (eng.paged_arena.blocks_used
                                 / eng.paged_arena.num_blocks
                                 if arena is not None else None),
        }

    # -- drive -----------------------------------------------------------
    def step(self) -> bool:
        """One fleet iteration: drive every healthy replica one engine
        step, fail over replicas that died (budget exhausted) or hung
        (watchdog), requeue their never-started work onto healthy
        siblings, and hedge stuck admissions.  Returns ``pending``."""
        if self._closed:
            raise RuntimeError(
                "fleet is closed; build a new one with "
                "model.serve_fleet()")
        self._step_replicas()
        self._check_watchdog()
        self._drain_failovers()
        self._drive_ships()
        if self.hedge_after_steps is not None:
            self._maybe_hedge()
        self._sync()
        self.step_count += 1
        return self.pending

    def run_until_complete(self, max_steps=None):
        """Drive :meth:`step` until every fleet-submitted request
        resolves (normally, or typed — a fleet with dead replicas
        still terminates: work that cannot be placed is rejected, never
        parked)."""
        steps = 0
        while self.pending:
            self.step()
            steps += 1
            if max_steps is not None and steps > max_steps:
                raise RuntimeError(
                    f"fleet did not drain within {max_steps} steps "
                    f"(routes={len(self._routes)}, healthy="
                    f"{self.healthy_replicas}/{len(self._replicas)})")

    def _step_replicas(self):
        """Drive every healthy pending replica one engine step,
        marking down those whose restart budget surfaced."""
        for rep in self._replicas:
            if not rep.healthy or not rep.sup.pending:
                continue
            try:
                rep.sup.step()
            except RestartBudgetExceededError as e:
                self._mark_down(rep, e)
            self._note_captures(rep)

    # -- health / failover -----------------------------------------------
    def _check_watchdog(self):
        """Fail over replicas whose heartbeat source latched a hang:
        the watchdog (observe.monitor) sees a wedged engine that never
        raises — typed failures alone would miss it."""
        if not _monitor.active():
            return
        wd = _monitor.watchdog()
        if wd is None:
            return
        for rep in self._replicas:
            if not rep.healthy:
                continue
            if wd.hang_latched(rep.sup.engine._hb_source):
                self._mark_down(rep, EngineFailedError(
                    f"replica {rep.idx} hang-latched by the watchdog",
                    started=None))

    def _mark_down(self, rep, error):
        """Take a replica out of the routing set (idempotent); the
        requeue scan runs in ``_drain_failovers``."""
        if not rep.healthy:
            return
        rep.healthy = False
        rep.needs_failover = True
        rep.down_error = error
        rep.draining = False  # a dying drain is a failover, not a
        #                       scale-down — the autoscaler re-derives
        if self._prefix_index is not None:
            # the replica's tree dies with it: forget its residency
            # records (stale hints would only cost a failed verify,
            # but dropping them keeps holder scans tight)
            self._prefix_index.drop_replica(rep.idx)
        self._c_failovers[rep.idx].inc()
        self._refresh_gauges()
        self._log.error(
            "replica %d failed out of the fleet (%r); %d/%d healthy",
            rep.idx, error, self.healthy_replicas, len(self._replicas))
        _trace.event("serve/fleet_failover", cat="serve",
                     replica=rep.idx, error=repr(error),
                     healthy=self.healthy_replicas)

    def _drain_failovers(self):
        """Process every replica marked down since the last pass.  A
        requeue can itself mark another replica down (its budget
        surfaces at admission), so loop until quiescent — each replica
        fails over at most once, so this terminates."""
        progressed = True
        while progressed:
            progressed = False
            for rep in self._replicas:
                if rep.needs_failover:
                    rep.needs_failover = False
                    self._failover(rep)
                    progressed = True

    def _failover(self, rep):
        """Reject the downed replica's outstanding work typed and move
        the never-started part onto healthy siblings in arrival
        order."""
        rep.sup.abandon(repr(rep.down_error))  # no-op if already dead
        for rid in list(self._order):
            route = self._routes.get(rid)
            if route is None or route.handle.done():
                continue
            atts = [h for i, h in route.attempts if i == rep.idx]
            if not atts:
                continue
            inner = atts[-1]
            live_elsewhere = any(
                not h.done() and self._replicas[i].healthy
                for i, h in route.attempts if i != rep.idx)
            err = inner._error if inner.done() else None
            if inner.done() and err is None:
                continue  # resolved OK on this replica; _sync picks it up
            if err is None:
                # abandon() resolves every outstanding handle; an
                # unresolved one here is a routing-table bug — reject
                # typed rather than wedge the caller
                err = EngineFailedError(
                    f"{rid}: replica {rep.idx} failed over",
                    request_id=rid, started=None)
            requeue_safe = (isinstance(err, EngineFailedError)
                            and err.started is False)
            if live_elsewhere:
                continue  # a hedge is still running on a healthy sibling
            if not requeue_safe:
                _trace.event("serve/request_rejected", cat="serve",
                             request=rid, reason="failover_terminal",
                             replica=rep.idx)
                if _reqs._active:
                    _reqs._ledger.on_reject(
                        rid, t=self._clock(),
                        reason="failover_terminal",
                        started=getattr(err, "started", None))
                route.handle._reject(err)
                continue
            try:
                idx2, inner2 = self._route(route.handle.request)
            except (EngineFailedError, QueueFullError,
                    LoadShedError) as e2:
                # nowhere to put it: typed, never silently dropped.
                # EngineFailedError covers FleetDownError AND a
                # sibling's RestartBudgetExceededError surfacing at
                # admission — an escape here would leave this route
                # unresolved forever (needs_failover was already
                # cleared)
                _trace.event("serve/request_rejected", cat="serve",
                             request=rid,
                             reason="failover_unplaceable")
                if _reqs._active:
                    _reqs._ledger.on_reject(
                        rid, t=self._clock(),
                        reason=f"failover_unplaceable:"
                               f"{type(e2).__name__}",
                        started=False)
                route.handle._reject(e2)
                continue
            if _reqs._active:
                # engine.submit reopened the timeline on the sibling;
                # record the hop's cause and both replica indices
                _reqs._ledger.annotate_hop(rid, replica=idx2,
                                           via="failover",
                                           src_replica=rep.idx)
            route.attempts.append((idx2, inner2))
            self._c_requeues[rep.idx].inc()
            _trace.event("serve/fleet_requeue", cat="serve",
                         request=rid, src=rep.idx, dst=idx2)
        # the end of the failover: from serve/fleet_failover (the
        # replica down) to here is its requeue time
        _trace.event("serve/fleet_failover_done", cat="serve",
                     replica=rep.idx)
        self._log.warning(
            "replica %d drained: never-started work requeued onto "
            "healthy siblings", rep.idx)

    def revive(self, idx):
        """Bring a failed OR retired replica back: release the dead
        engine, build a fresh supervisor (fresh restart budget, empty
        prefix cache: cold but correct; an arena allocation, and one
        capture a decode width as its traffic reaches it), and
        re-enter the routing set.  The autoscaler's scale-up reuses
        retired slots through exactly this path."""
        rep = self._replicas[idx]
        if rep.healthy:
            raise ValueError(f"replica {idx} is healthy")
        if not rep.sup.engine._closed:
            rep.sup.close(force=True)
        rep.sup = self._new_supervisor(idx)
        rep.healthy = True
        rep.needs_failover = False
        rep.down_error = None
        rep.draining = False
        rep.retired = False
        rep.reconnect_deadline = None
        self._refresh_gauges()
        self._log.info("replica %d revived; %d/%d healthy", idx,
                       self.healthy_replicas, len(self._replicas))
        _trace.event("serve/fleet_revive", cat="serve", replica=idx,
                     healthy=self.healthy_replicas)

    # -- elastic capacity (serve/autoscale.py drives these) --------------
    def add_replica(self, role="mixed") -> int:
        """Scale-up: append a brand-new supervised replica and admit
        it to the routing set; returns its index.  The cost is an arena
        allocation and one capture a decode width as its traffic
        reaches it (logged).  Sharded fleets (tp/ep/pp) pin their rank
        groups at construction and cannot grow — scale those by reviving
        retired slots only."""
        if self._closed:
            raise RuntimeError("fleet is closed")
        if self._tp_cfgs is not None:
            raise ValueError(
                f"cannot add a replica to a {self._par_key}-sharded "
                f"fleet: rank groups were partitioned at construction; "
                f"size it max_replicas-wide up front and scale by "
                f"drain/revive")
        if role not in ("prefill", "decode", "mixed"):
            raise ValueError(
                f"unknown role {role!r}: 'prefill', 'decode' or "
                f"'mixed'")
        if role != "mixed" and not self._disagg \
                and all(r == "mixed" for r in self.roles):
            raise ValueError(
                f"role={role!r} on a symmetric fleet: role-typed "
                f"replicas need the fleet built with roles= (the ship "
                f"machinery is wired at construction)")
        idx = len(self._replicas)
        # build the supervisor BEFORE registering anything fleet-side:
        # a raising constructor must not leave half a replica behind
        # (the engine's own metrics unwind through its failure paths;
        # the fleet counters below are get-or-create and cannot raise)
        sup = self._new_supervisor(idx)
        reg = self._reg
        rl = dict(fleet=self.fleet_label, replica=str(idx))
        new_counters = [
            reg.counter("serve.fleet.routed",
                        help="requests admitted to this replica",
                        **rl),
            reg.counter("serve.fleet.failovers",
                        help="times this replica was failed out of "
                             "the routing set", **rl),
            reg.counter("serve.fleet.requeues",
                        help="never-started requests moved OFF this "
                             "replica onto healthy siblings", **rl),
            reg.counter("serve.fleet.hedges",
                        help="hedged re-dispatches admitted TO this "
                             "replica", **rl),
        ]
        self._c_routed.append(new_counters[0])
        self._c_failovers.append(new_counters[1])
        self._c_requeues.append(new_counters[2])
        self._c_hedges.append(new_counters[3])
        self._registered.extend(new_counters)
        self.roles = self.roles + (role,)
        self._replicas.append(_Replica(idx, sup))
        self._refresh_gauges()
        self._log.info("replica %d added (%s); %d/%d healthy", idx,
                       role, self.healthy_replicas,
                       len(self._replicas))
        _trace.event("serve/fleet_add_replica", cat="serve",
                     replica=idx, role=role,
                     healthy=self.healthy_replicas)
        return idx

    def start_drain(self, idx):
        """Scale-down, phase 1: stop routing NEW work to the replica.
        It keeps stepping until its live requests finish
        (:meth:`drained`), then :meth:`retire_replica` closes it.
        Sticky sessions fall back to normal routing (cold but
        correct)."""
        rep = self._replicas[idx]
        if not rep.healthy or rep.retired:
            raise ValueError(f"replica {idx} is not serving")
        if rep.draining:
            return
        rep.draining = True
        self._refresh_gauges()
        self._log.info("replica %d draining (routable %d/%d)", idx,
                       self.routable_replicas, len(self._replicas))
        _trace.event("serve/fleet_drain_begin", cat="serve",
                     replica=idx, routable=self.routable_replicas)

    def cancel_drain(self, idx):
        """Abort a drain (load came back before the replica emptied):
        the replica re-enters the routing set with its state intact —
        the cheapest possible scale-up."""
        rep = self._replicas[idx]
        if not rep.draining:
            raise ValueError(f"replica {idx} is not draining")
        rep.draining = False
        self._refresh_gauges()
        _trace.event("serve/fleet_drain_cancel", cat="serve",
                     replica=idx, routable=self.routable_replicas)

    def drained(self, idx) -> bool:
        """True when a draining replica holds no work: no queued or
        live requests, and no ship build sourcing from it."""
        rep = self._replicas[idx]
        return (not rep.sup.pending
                and all(s.src != idx for s in self._ship_jobs))

    def retire_replica(self, idx):
        """Scale-down, phase 2: close a drained replica.  The close
        routes through ``EngineStats.unregister()`` (engine.close →
        _release_everything), so every ``serve.*{engine=n}`` series —
        gauges included — leaves the registry with the replica instead
        of freezing at its last value, and the health report's
        per-replica sections drop it (the leaked-gauge audit in
        tests/test_autoscale.py pins this).  The slot stays in
        ``_replicas`` so a later scale-up can ``revive()`` it on the
        same pinned config."""
        rep = self._replicas[idx]
        if rep.retired:
            return
        if not rep.draining:
            raise ValueError(
                f"replica {idx} is not draining; start_drain() first "
                f"(retire without drain would abandon live requests)")
        if not self.drained(idx):
            raise RuntimeError(
                f"replica {idx} still holds work (queue="
                f"{rep.sup.engine.scheduler.queue_depth}, live="
                f"{rep.sup.engine.live_slots}); wait for drained()")
        rep.sup.close()  # drained: the non-force close asserts it
        rep.retired = True
        rep.healthy = False
        rep.draining = False
        if self._prefix_index is not None:
            self._prefix_index.drop_replica(idx)
        self._refresh_gauges()
        self._log.info("replica %d retired; %d/%d serving", idx,
                       self.routable_replicas, len(self._replicas))
        _trace.event("serve/fleet_retire", cat="serve", replica=idx,
                     routable=self.routable_replicas)

    # -- disaggregated prefill/decode: KV shipping -----------------------
    def _ship_eligible(self, request) -> bool:
        """True when this admission should run disaggregated: a
        role-typed fleet with both sides healthy, a prompt with at
        least one shippable full block, no sticky session target,
        ship-queue headroom, and no decode replica already holding
        the prefix (that routes warm directly — cheaper than any
        ship)."""
        if not self._disagg or self._prefix_index is None:
            return False
        sess = getattr(request, "session_of", None)
        if sess is not None and self._sessions.get(sess) is not None:
            return False
        if (len(request.prompt_ids) - 1) // self._block_size < 1:
            return False
        if len(self._ship_jobs) >= self._ship_queue_max():
            # the ship queue is NOT exempt from back-pressure: past
            # the scheduler-depth bound, long admissions fall through
            # to classic routing, where the decode replicas' own
            # queue bounds and SLO shedding apply (a burst gets typed
            # QueueFullError/LoadShedError, never unbounded host
            # growth behind the specialists)
            return False
        if not any(self._routable(r) and self.roles[r.idx] == "prefill"
                   for r in self._replicas):
            return False
        return any(self._routable(r) and self.roles[r.idx] != "prefill"
                   for r in self._replicas)

    def _ship_queue_max(self) -> int:
        """Depth bound for parked ship builds: the replicas' own
        scheduler back-pressure bound (they share engine_kw), so
        disaggregated admission refuses at the same depth a direct
        engine submit would."""
        sched = self._replicas[0].sup.engine.scheduler
        return int(getattr(sched, "max_queue_depth", 64) or 64)

    def _verified_holder(self, tokens, n_goal, decode_only=False):
        """First replica whose LIVE tree verifiably holds the first
        ``n_goal`` blocks of ``tokens`` (fleet-index hint, checked
        against the tree — the ONE place the verify/prune discipline
        lives): stale hints are unregistered so later lookups stop
        paying the verify.  ``decode_only`` restricts to
        decode-capable replicas (warm routing); otherwise any role
        qualifies (targeted export).  None when nothing verifies."""
        if self._prefix_index is None or n_goal < 1:
            return None
        for idx in self._prefix_index.holders(tokens, n_goal):
            rep = self._replicas[idx]
            if not rep.healthy or (decode_only
                                   and self.roles[idx] == "prefill"):
                continue
            eng = rep.sup.engine
            if (not eng._closed and not eng._failed
                    and eng.prefix_cache is not None
                    and len(eng.prefix_cache.lookup(tokens)[:n_goal])
                    == n_goal):
                return idx
            # the replica's LRU evicted it since registration: the
            # hint is dead — prune it
            self._prefix_index.unregister(tokens, n_goal, idx)
        return None

    def _warm_decode_target(self, request):
        """A healthy decode-capable replica whose LIVE tree already
        holds the request's whole shippable prefix: routing there
        serves warm locally with no ship and no re-prefill."""
        if self._prefix_index is None:
            return None
        n_goal = (len(request.prompt_ids) - 1) // self._block_size
        return self._verified_holder(request.prompt_ids, n_goal,
                                     decode_only=True)

    def _pick_ship_src(self, request) -> int:
        """The replica a ship sources from: any healthy replica whose
        live tree already holds the whole prefix (targeted export —
        zero recompute, whatever its role), else the prefill
        specialist with the shallowest build queue."""
        n_goal = (len(request.prompt_ids) - 1) // self._block_size
        idx = self._verified_holder(request.prompt_ids, n_goal)
        if idx is not None:
            return idx
        views = [self._view(r) for r in self._replicas
                 if self._routable(r)
                 and self.roles[r.idx] == "prefill"]
        return self.router.rank_prefill(views)[0]

    def _enqueue_ship(self, request, route):
        sjob = _ShipJob()
        sjob.rid = request.request_id
        sjob.route = route
        sjob.request = request
        sjob.src = self._pick_ship_src(request)
        sjob.job = None
        sjob.hit = False
        self._ship_jobs.append(sjob)
        if _reqs._active:
            # the request's timeline opens HERE with a hop on the
            # prefill specialist: no engine.submit happens there, but
            # exact ship/prefill attribution needs the hop (this one
            # via=prefill, then the decode hop via=kv_ship)
            eng = self._replicas[sjob.src].sup.engine
            _reqs._ledger.on_submit(
                sjob.rid, engine=eng.stats.engine_label,
                t=self._clock(),
                prompt_len=len(request.prompt_ids),
                max_new_tokens=request.max_new_tokens)
            _reqs._ledger.annotate_hop(sjob.rid, replica=sjob.src,
                                       via="prefill")
        _trace.event("serve/kv_ship_queued", cat="serve",
                     request=sjob.rid, src=sjob.src)

    def _drive_ships(self):
        """Advance every queued ship one scheduling quantum: per
        healthy source, chunk its HEAD build by the specialist's own
        ``prefill_token_budget`` (None = finish this step); completed
        builds export → validate → scatter + adopt on the chosen
        decode replica, and the request submits there (warm by
        construction).  Every failure mode — an injected
        ``serve.kv_ship`` fault, a malformed image, destination
        capacity, a dying specialist — falls back to a COLD route:
        later, never wrong (nothing streamed during the ship)."""
        if not self._ship_jobs:
            return
        busy = set()
        remaining = []
        for sjob in self._ship_jobs:
            if sjob.route.handle.done():
                self._abandon_build(sjob)
                continue
            rep = self._replicas[sjob.src]
            if not rep.healthy:
                self._reassign_or_fallback(sjob, remaining)
                continue
            if sjob.src in busy:
                remaining.append(sjob)
                continue
            busy.add(sjob.src)
            try:
                if sjob.job is None \
                        or sjob.job.engine is not rep.sup.engine:
                    sjob.job = rep.sup.start_prefix_build(
                        sjob.request.prompt_ids)
                    sjob.hit = bool(sjob.job is not None
                                    and sjob.job.hit)
                if sjob.job is None:
                    self._ship_fallback(sjob, "nothing_shippable")
                    continue
                self._before_build_advance(sjob)
                done = rep.sup.advance_prefix_build(
                    sjob.job, rep.sup.engine._budget, rid=sjob.rid)
                if done is None:
                    # the specialist died mid-chunk and was rebuilt:
                    # restart the build on the fresh engine next step
                    # (nothing streamed — the replay is identical)
                    sjob.job = None
                    remaining.append(sjob)
                    continue
                if not done:
                    remaining.append(sjob)
                    continue
                self._complete_ship(sjob, rep)
            except RestartBudgetExceededError as e:
                self._mark_down(rep, e)
                self._reassign_or_fallback(sjob, remaining)
            except Exception as e:
                # mid-ship failure (injected serve.kv_ship fault, a
                # malformed/truncated image, a raising copy): the
                # engine helpers already unwound their local state —
                # requeue the request cold-but-correct
                self._log.warning(
                    "ship for %s failed (%r); serving cold", sjob.rid,
                    e)
                self._ship_fallback(sjob, type(e).__name__)
        self._ship_jobs = remaining
        if any(r.needs_failover for r in self._replicas):
            self._drain_failovers()

    def _ship_dsts(self, request) -> list:
        """Ship destination candidates, best-first: the PREFIX-HASH
        STICKY target (a deterministic crc32 of the shipped block
        prefix over the healthy decode pool, so each hot prefix's
        blocks concentrate on as few replicas as possible), then the
        router's ranking of the rest."""
        pool = self._decode_pool()
        if not pool:
            return []
        n_goal = (len(request.prompt_ids) - 1) // self._block_size
        toks = np.asarray(request.prompt_ids, np.int32).reshape(-1)
        key = toks[:n_goal * self._block_size].tobytes()
        sticky = sorted(pool)[zlib.crc32(key) % len(pool)]
        out = [sticky]
        views = [self._view(self._replicas[i]) for i in pool
                 if i != sticky]
        out.extend(self.router.rank(views))
        return out

    def _before_build_advance(self, sjob):
        """Hook called just before each ship build's advance quantum.
        A no-op here; ``serve/dist/fleet.py`` uses it to open the
        layer-wise STREAMED ship (pick the destination, start its
        staging) so KV lanes ship while the source still prefills."""

    def _complete_ship(self, sjob, src_rep):
        """Transfer a finished build: export the image from the
        source, land it on the first destination with capacity, and
        submit the request there (the admission finds the prefix in
        its OWN radix tree — a local warm hit)."""
        req = sjob.request
        t0 = self._clock()
        image, src_resident = src_rep.sup.export_prefix_image(
            sjob.job)
        sjob.job = None
        n = image.n_data
        if src_resident:
            # only a REAL donation/residency is worth indexing — a
            # pool-pressure export-from-row never entered the tree
            self._prefix_index.register(req.prompt_ids, n,
                                        src_rep.idx)
        path = dst_rep = None
        for idx in self._ship_dsts(req):
            cand = self._replicas[idx]
            try:
                path = cand.sup.admit_prefix_image(req.prompt_ids,
                                                   image)
            except RestartBudgetExceededError as e:
                self._mark_down(cand, e)
                continue
            if path is not None:
                dst_rep = cand
                break
        if path is None:
            self._ship_fallback(sjob, "dst_capacity")
            return
        self._land_shipped(sjob, src_rep, dst_rep, path, n,
                           image.nbytes, t0)

    def _land_shipped(self, sjob, src_rep, dst_rep, path, n, nbytes,
                      t0):
        """Final leg of a completed ship: submit the request on the destination — where the
        admission is a local warm hit — pin the shipped prefix for the
        request's lifetime, and account the ship."""
        req = sjob.request
        t1 = self._clock()
        dst = dst_rep.idx
        cache = dst_rep.sup.engine.prefix_cache
        try:
            inner = dst_rep.sup.submit(req)
        except (QueueFullError, LoadShedError, ValueError,
                RestartBudgetExceededError) as e:
            # refused AFTER the blocks landed: they stay CACHED on
            # the destination (soft free space, not a leak) — unpin
            # and serve cold wherever the router finds room
            try:
                cache.release(path)
            except RuntimeError:
                pass
            if isinstance(e, RestartBudgetExceededError):
                self._mark_down(dst_rep, e)
            self._ship_fallback(sjob, "dst_refused")
            return
        sjob.route.ship_release = (cache, path)
        sjob.route.attempts.append((dst, inner))
        self._c_routed[dst].inc()
        nr = getattr(self.router, "note_routed", None)
        if nr is not None:
            nr(dst)
        self._c_ships.inc()
        self._c_ship_bytes.inc(nbytes)
        if sjob.hit:
            # the prefix was RESIDENT on the source (an earlier
            # build, another request's donation): this ship recomputed
            # nothing — the fleet-level cache did its job
            self._c_shared_hits.inc()
        self._prefix_index.register(req.prompt_ids, n, dst)
        if _reqs._active:
            _reqs._ledger.annotate_hop(
                sjob.rid, replica=dst, via="kv_ship",
                src_replica=src_rep.idx, ship_s=t1 - t0,
                ship_bytes=nbytes, ship_blocks=n)
        _trace.event("serve/kv_ship", cat="serve", request=sjob.rid,
                     src=src_rep.idx, dst=dst, blocks=n,
                     bytes=nbytes)
        self._log.info("shipped %d KV blocks for %s: replica %d -> %d"
                       " (%d bytes)", n, sjob.rid, src_rep.idx, dst,
                       nbytes)

    def _ship_fallback(self, sjob, reason):
        """Serve a failed ship COLD: nothing streamed during the
        ship, so a plain re-route is byte-identical — later, never
        wrong.  Unplaceable requests reject typed (the failover
        contract), never silently dropped."""
        self._abandon_build(sjob)
        self._c_ship_fallbacks.inc()
        rid = sjob.rid
        _trace.event("serve/kv_ship_fallback", cat="serve",
                     request=rid, reason=reason)
        try:
            idx, inner = self._route(sjob.request)
        except (EngineFailedError, QueueFullError, LoadShedError,
                ValueError) as e:
            # ValueError: submit-time infeasibility surfacing on the
            # cold path (belt and braces — ship eligibility already
            # pre-validated, but the route must NEVER let an escape
            # wedge the drive loop with the job gone)
            _trace.event("serve/request_rejected", cat="serve",
                         request=rid, reason="ship_unplaceable")
            if _reqs._active:
                _reqs._ledger.on_reject(
                    rid, t=self._clock(),
                    reason=f"ship_unplaceable:{type(e).__name__}",
                    started=False)
            sjob.route.handle._reject(e)
            return
        if _reqs._active:
            _reqs._ledger.annotate_hop(rid, replica=idx,
                                       via="ship_fallback",
                                       reason=reason)
        sjob.route.attempts.append((idx, inner))

    def _reassign_or_fallback(self, sjob, remaining):
        """The build's source replica died: restart it on another
        healthy prefill specialist (nothing streamed — a rebuilt
        prefix is byte-identical), else serve cold."""
        self._abandon_build(sjob)
        have_prefill = any(
            self._routable(r) and self.roles[r.idx] == "prefill"
            for r in self._replicas)
        have_decode = any(
            self._routable(r) and self.roles[r.idx] != "prefill"
            for r in self._replicas)
        if have_prefill and have_decode:
            sjob.src = self._pick_ship_src(sjob.request)
            sjob.job = None
            if _reqs._active:
                eng = self._replicas[sjob.src].sup.engine
                _reqs._ledger.on_submit(sjob.rid,
                                        engine=eng.stats.engine_label,
                                        t=self._clock())
                _reqs._ledger.annotate_hop(sjob.rid, replica=sjob.src,
                                           via="prefill")
            _trace.event("serve/kv_ship_requeued", cat="serve",
                         request=sjob.rid, src=sjob.src)
            remaining.append(sjob)
        else:
            self._ship_fallback(sjob, "specialist_lost")

    def _abandon_build(self, sjob):
        """Release a job's engine-side refs (idempotent; a rebuilt
        engine makes it a no-op — the old tree died with it)."""
        if sjob.job is not None:
            rep = self._replicas[sjob.src]
            if sjob.job.engine is rep.sup.engine:
                rep.sup.abandon_prefix_build(sjob.job)
            sjob.job = None

    def _release_ship_pin(self, route):
        if route.ship_release is not None:
            cache, path = route.ship_release
            route.ship_release = None
            try:
                cache.release(path)
            except RuntimeError:
                pass  # the destination engine was rebuilt: stale path

    # -- hedging ---------------------------------------------------------
    def _maybe_hedge(self):
        """Re-dispatch requests stuck un-started behind one replica's
        admission for ``hedge_after_steps`` fleet steps.  Only
        non-streaming, non-session requests hedge (a duplicate stream
        would double tokens at the client; a session belongs to its
        replica), and only once per request."""
        for rid in self._order:
            route = self._routes.get(rid)
            if (route is None or route.handle.done() or route.hedged
                    or len(route.attempts) != 1):
                continue
            req = route.handle.request
            if (req.on_token is not None or req.pin_session
                    or getattr(req, "session_of", None) is not None):
                continue
            if self.step_count - route.submit_step \
                    < self.hedge_after_steps:
                continue
            idx0, inner0 = route.attempts[0]
            rep0 = self._replicas[idx0]
            if inner0.done():
                continue
            if rid in rep0.sup.engine.live_request_ids:
                continue  # started: it is decoding, not stuck
            try:
                idx2, inner2 = self._route(req, exclude={idx0})
            except (EngineFailedError, QueueFullError, LoadShedError):
                continue  # nowhere better to run it; not an error
            if _reqs._active:
                # the hedge twin is a CONCURRENT hop on the same
                # timeline (engine labels disambiguate its events)
                _reqs._ledger.annotate_hop(rid, replica=idx2,
                                           via="hedge",
                                           src_replica=idx0)
            route.attempts.append((idx2, inner2))
            route.hedged = True
            self._c_hedges[idx2].inc()
            _trace.event("serve/fleet_hedge", cat="serve", request=rid,
                         src=idx0, dst=idx2,
                         waited_steps=self.step_count
                         - route.submit_step)
            self._log.info("hedged %s: replica %d -> %d after %d "
                           "steps un-started", rid, idx0, idx2,
                           self.step_count - route.submit_step)

    # -- completion routing ----------------------------------------------
    def _sync(self):
        """Propagate resolved attempts to the fleet handles.  First
        success wins (hedged twins produce identical tokens — same
        seed, same chain); a route rejects only once EVERY attempt has
        failed and no requeue replaced it."""
        done = []
        for rid, route in self._routes.items():
            h = route.handle
            if h.done():
                done.append(rid)
                continue
            finished = None
            err = None
            all_done = True
            for idx, inner in route.attempts:
                if not inner.done():
                    all_done = False
                    continue
                if inner._error is None:
                    finished = (idx, inner._result)
                    break
                err = inner._error
            if finished is not None:
                idx, result = finished
                if result.session is not None:
                    # sticky routing source: this session's blocks live
                    # in replica idx's radix tree
                    self._sessions[result.session] = idx
                h._finish(result)
                done.append(rid)
            elif all_done and err is not None:
                h._reject(err)
                done.append(rid)
        if done:
            for rid in done:
                route = self._routes.pop(rid, None)
                if route is not None:
                    # a shipped request's prefix pin lives exactly as
                    # long as the request: release it with the route
                    self._release_ship_pin(route)
            live = set(self._routes)
            self._order = [r for r in self._order if r in live]

    # -- lifecycle -------------------------------------------------------
    def close(self):
        """Retire the fleet: close every replica (force for abandoned
        ones and hedge losers — their fleet handles are resolved; the
        leftover supervisor-side work is nobody's) and unregister the
        fleet metrics.  Requires every FLEET handle resolved
        (``not pending``)."""
        if self._closed:
            return
        if self.pending:
            raise RuntimeError(
                f"close() with {len(self._routes)} requests in flight;"
                f" drain with run_until_complete() first")
        for rep in self._replicas:
            if not rep.sup.engine._closed:
                rep.sup.close(force=True)
        self._reg.remove(*self._registered)
        self._leave_groups()
        self._closed = True

    def _leave_groups(self):
        """Sharded replicas' rank groups: their worker ranks go back to
        serving the whole group (``serve/shard.py``)."""
        if self._tp_cfgs is not None \
                and getattr(self._tp_cfgs[0], "devices", None) is not None:
            from .shard import leave_fleet

            leave_fleet(self._tp_cfgs)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is None:
            self.close()
        elif not self._closed:
            # release registries + arenas without masking the in-flight
            # exception behind the drained-first check
            for rep in self._replicas:
                if not rep.sup.engine._closed:
                    rep.sup.engine.__exit__(exc_type, *a)
            self._reg.remove(*self._registered)
            self._leave_groups()
            self._closed = True
        return False
