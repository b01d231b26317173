"""Signal-driven fleet autoscaling (counterpart of
``singa_tpu/serve/autoscale.py``): the action half of the
telemetry→decision→action loop.

Everything below the autoscaler already exists: the fleet's Router
signals (queue depth, occupancy, ``tpot_ewma``, ``blocks_used_frac``
— ``ServeFleet.load_views``), the windowed burn-rate state
(``observe.slo.SLOPolicy``), and the elastic-capacity primitives
(``add_replica``/``revive``/``start_drain``/``retire_replica``).
This module is the policy that closes the loop:

* **scale-up** when the error budget is burning (any firing burn-rate
  rule) or the load signals clear their high-water marks — by
  CANCELLING an in-flight drain first (free capacity), then reviving
  a retired slot, then appending a brand-new replica (either captures
  its decode widths once as its traffic reaches them);
* **scale-down** when every signal sits below its low-water mark, no
  alert is firing, and the cooldowns have passed — by DRAINING the
  least-loaded replica (stop routing → wait for its live requests →
  ``retire_replica``, which routes through ``EngineStats.unregister``
  so no ``{engine=n}`` series freezes in the registry);
* **flap control** — separate up/down cooldowns, low/high hysteresis
  bands on every signal, one drain in flight at a time, and a
  scale-down embargo for ``scale_down_cooldown_s`` after any scale-up.

Every decision — acted on, retried, or abandoned — lands in the
structured :attr:`Autoscaler.scaling_events` ledger with the full
signal snapshot that justified it, so an autoscale is as explainable
after the fact as a slow request is through the request ledger.  The
``serve.autoscale`` fault site (singa_tpu_torch.resilience) is checked
BEFORE any replica construction or registration: an injected failure
mid-scale-up abandons the decision typed (ledger ``action:
"scale_up_failed"``), leaves no half-registered replica, and the
next :meth:`check` simply retries.

Threadless by design (the ``Watchdog.check()`` idiom): the owner
calls :meth:`check` from its drive loop with an injectable clock, so
the whole decision table is deterministic under test.
"""

from __future__ import annotations

import time
from dataclasses import asdict, dataclass

from ..observe import trace as _trace
from ..observe.registry import registry as _registry
from ..resilience import faults as _faults
from ..utils.logging import get_channel

__all__ = ["AutoscaleConfig", "Autoscaler"]


@dataclass(frozen=True)
class AutoscaleConfig:
    """Scaling policy knobs.  The high/low pairs are hysteresis
    bands: scale-up triggers ABOVE high, scale-down requires EVERY
    signal below its low — between the bands the fleet holds steady.

    * ``queue_high``/``queue_low``: mean scheduler queue depth per
      routable replica;
    * ``occupancy_high``/``occupancy_low``: mean live-slot occupancy;
    * ``blocks_high``: max paged-pool used fraction (None or unpaged
      engines skip the signal);
    * ``prefill_queue_high``/``prefill_queue_low``: mean SHIP-BUILD
      queue depth per routable prefill specialist (the disagg round's
      separate load signal — specialists hold no decode lanes, so
      queue/occupancy/TPOT never see their pressure); role-less fleets
      have no prefill views and skip the signal;
    * ``scale_up_cooldown_s``/``scale_down_cooldown_s``: minimum
      spacing between same-direction actions; a scale-down is also
      embargoed for ``scale_down_cooldown_s`` after any scale-up
      (never retire the capacity a burst just bought).
    """

    min_replicas: int = 1
    max_replicas: int = 4
    scale_up_cooldown_s: float = 30.0
    scale_down_cooldown_s: float = 120.0
    queue_high: float = 4.0
    queue_low: float = 0.5
    occupancy_high: float = 0.85
    occupancy_low: float = 0.35
    blocks_high: float = 0.85
    prefill_queue_high: float = 2.0
    prefill_queue_low: float = 0.5

    def validate(self):
        if self.min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {self.min_replicas}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas ({self.max_replicas}) < min_replicas "
                f"({self.min_replicas})")
        if self.scale_up_cooldown_s < 0 \
                or self.scale_down_cooldown_s < 0:
            raise ValueError("cooldowns must be >= 0")
        for low, high, name in (
                (self.queue_low, self.queue_high, "queue"),
                (self.prefill_queue_low, self.prefill_queue_high,
                 "prefill_queue"),
                (self.occupancy_low, self.occupancy_high,
                 "occupancy")):
            if low < 0 or high <= low:
                raise ValueError(
                    f"need 0 <= {name}_low < {name}_high, got "
                    f"low={low} high={high}")
        if self.blocks_high is not None \
                and not 0.0 < self.blocks_high <= 1.0:
            raise ValueError(
                f"blocks_high must be in (0, 1] or None, got "
                f"{self.blocks_high}")


class Autoscaler:
    """Scale a :class:`~singa_tpu_torch.serve.fleet.ServeFleet` between
    ``min_replicas`` and ``max_replicas`` off its own routing signals
    plus the installed burn-rate policy.

    >>> policy = observe.slo.SLOPolicy(slo, budget_frac=0.05)
    >>> scaler = Autoscaler(fleet, AutoscaleConfig(max_replicas=4),
    ...                     slo_policy=policy)
    >>> while serving:
    ...     fleet.step()
    ...     policy.poll()
    ...     scaler.check()

    ``slo_policy`` may be None (pure load-signal scaling).  Metrics
    ride the registry as ``serve.autoscale.*{fleet=}`` and surface in
    ``health_report()["serve"]["autoscale"]``; every decision is a
    ``serve/autoscale`` trace instant AND a structured entry in
    :attr:`scaling_events`."""

    def __init__(self, fleet, config=None, slo_policy=None,
                 clock=None, reg=None):
        self.fleet = fleet
        self.config = config if config is not None else AutoscaleConfig()
        self.config.validate()
        if fleet.replicas < self.config.min_replicas:
            raise ValueError(
                f"fleet has {fleet.replicas} replicas, below "
                f"min_replicas={self.config.min_replicas} — build the "
                f"fleet at least min-wide")
        self.slo_policy = slo_policy
        self.clock = (clock if clock is not None
                      else getattr(fleet, "_clock", time.monotonic))
        reg = reg if reg is not None else _registry()
        self.registry = reg
        lbl = dict(fleet=fleet.fleet_label)
        self._g_replicas = reg.gauge(
            "serve.autoscale.replicas",
            help="replicas the autoscaler currently targets as "
                 "serving (routable + draining)", **lbl)
        self._g_min = reg.gauge(
            "serve.autoscale.min_replicas",
            help="configured scale floor", **lbl)
        self._g_max = reg.gauge(
            "serve.autoscale.max_replicas",
            help="configured scale ceiling", **lbl)
        self._g_draining = reg.gauge(
            "serve.autoscale.draining",
            help="replicas mid-drain toward retirement", **lbl)
        self._c_ups = reg.counter(
            "serve.autoscale.scale_ups",
            help="replicas added/revived/drain-cancelled by the "
                 "autoscaler", **lbl)
        self._c_downs = reg.counter(
            "serve.autoscale.scale_downs",
            help="replicas drained and retired by the autoscaler",
            **lbl)
        self._c_failed = reg.counter(
            "serve.autoscale.decisions_failed",
            help="scaling actions abandoned typed (serve.autoscale "
                 "fault, constructor failure); retried on a later "
                 "check", **lbl)
        self._registered = [
            self._g_replicas, self._g_min, self._g_max,
            self._g_draining, self._c_ups, self._c_downs,
            self._c_failed]
        self._g_min.set(self.config.min_replicas)
        self._g_max.set(self.config.max_replicas)
        #: structured decision ledger: dicts of {t, action, replica,
        #: reason, signals} (actions: scale_up, scale_up_failed,
        #: drain_begin, drain_cancelled, drain_done) — the SOAK.json
        #: evidence trail
        self.scaling_events = []
        self._last_up_t = None
        self._last_down_t = None
        self._draining_idx = None
        self._closed = False
        self._log = get_channel("serve")
        self._refresh_gauges()

    # -- signal gathering ------------------------------------------------
    def signals(self, now=None) -> dict:
        """One JSON-able snapshot of everything the decision reads:
        per-replica router views aggregated + burn-rate state."""
        all_views = [v for v in self.fleet.load_views()
                     if not v["draining"]]
        # prefill specialists carry NO decode load (their queue depth
        # and occupancy are structurally 0) — folding them into the
        # decode means would dilute real pressure, so the roles see
        # separate aggregates (role-less fleets: pviews is empty and
        # nothing changes)
        pviews = [v for v in all_views if v.get("role") == "prefill"]
        views = [v for v in all_views if v.get("role") != "prefill"]
        n = len(views)
        q = [v["queue_depth"] for v in views]
        occ = [v["occupancy"] for v in views]
        blocks = [v["blocks_used_frac"] for v in views
                  if v.get("blocks_used_frac") is not None]
        ewmas = [v["tpot_ewma"] for v in views
                 if v.get("tpot_ewma") is not None]
        pq = [v.get("prefill_depth", 0) for v in pviews]
        pol = self.slo_policy
        return {
            "routable": len(all_views),
            "draining": self._draining_idx,
            "queue_depth_mean": (sum(q) / n) if n else 0.0,
            "queue_depth_max": max(q) if q else 0,
            "occupancy_mean": (sum(occ) / n) if n else 0.0,
            "occupancy_max": max(occ) if occ else 0.0,
            "blocks_used_frac_max": max(blocks) if blocks else None,
            "tpot_ewma_max_s": max(ewmas) if ewmas else None,
            "prefill_routable": len(pviews),
            "prefill_depth_mean": (sum(pq) / len(pq)) if pq else 0.0,
            "prefill_depth_max": max(pq) if pq else 0,
            "alerts_firing": ([name for name, st in pol.alerts.items()
                               if st["firing"]]
                              if pol is not None else []),
        }

    # -- the decision loop -----------------------------------------------
    def check(self, now=None):
        """One threadless decision pass: finish an in-flight drain,
        then evaluate scale-up (burn alert or high-water load), then
        scale-down (all-quiet + cooldowns).  Returns the ledger entry
        it appended, or None when the fleet holds steady."""
        if self._closed:
            raise RuntimeError("autoscaler is closed")
        if now is None:
            now = self.clock()
        event = None
        self._sync_drain_state()
        sig = self.signals(now)
        event = self._replace_dead(now, sig)
        if event is not None:
            self._refresh_gauges()
            return event
        up_reasons = self._up_reasons(sig)
        if up_reasons:
            # pressure is evaluated BEFORE a finished drain retires:
            # load returning just as the drain empties takes the free
            # cancel_drain path instead of paying retire + respawn
            if self._can_scale_up(sig, now):
                event = self._scale_up(now, sig, up_reasons)
        elif self._draining_idx is not None \
                and self.fleet.drained(self._draining_idx):
            event = self._finish_drain(now, sig)
        elif self._can_scale_down(sig, now):
            event = self._begin_drain(now, sig)
        self._refresh_gauges()
        return event

    def _sync_drain_state(self):
        """A draining replica that FAILED over (or was revived by
        hand) is no longer ours to retire."""
        idx = self._draining_idx
        if idx is None:
            return
        rep = self.fleet._replicas[idx]
        if not (rep.healthy and rep.draining):
            self._draining_idx = None

    def _up_reasons(self, sig) -> list:
        cfg = self.config
        reasons = []
        if sig["alerts_firing"]:
            reasons.append("slo_burn:" + ",".join(sig["alerts_firing"]))
        if sig["queue_depth_mean"] > cfg.queue_high:
            reasons.append("queue_depth")
        if sig["occupancy_mean"] > cfg.occupancy_high:
            reasons.append("occupancy")
        if (cfg.blocks_high is not None
                and sig["blocks_used_frac_max"] is not None
                and sig["blocks_used_frac_max"] > cfg.blocks_high):
            reasons.append("kv_blocks")
        if (sig["prefill_routable"] > 0
                and sig["prefill_depth_mean"] > cfg.prefill_queue_high):
            # build-queue pressure on the prefill side: a separate
            # signal with a separate remedy (a prefill specialist, not
            # a decode replica — _scale_role picks it)
            reasons.append("prefill_queue")
        return reasons

    def _can_scale_up(self, sig, now) -> bool:
        cfg = self.config
        if self._draining_idx is not None:
            return True  # cancelling a drain is always available
        if sig["routable"] >= cfg.max_replicas:
            return False
        return (self._last_up_t is None
                or now - self._last_up_t >= cfg.scale_up_cooldown_s)

    def _can_scale_down(self, sig, now) -> bool:
        cfg = self.config
        if self._draining_idx is not None:
            return False  # one drain in flight at a time
        if sig["routable"] <= cfg.min_replicas:
            return False
        if sig["alerts_firing"]:
            return False
        if sig["queue_depth_mean"] > cfg.queue_low \
                or sig["occupancy_mean"] > cfg.occupancy_low:
            return False
        if sig["prefill_routable"] > 0 \
                and sig["prefill_depth_mean"] > cfg.prefill_queue_low:
            return False  # ship builds still queued: not all-quiet
        if self._last_down_t is not None \
                and now - self._last_down_t < cfg.scale_down_cooldown_s:
            return False
        # never retire capacity a burst just bought
        if self._last_up_t is not None \
                and now - self._last_up_t < cfg.scale_down_cooldown_s:
            return False
        return True

    # -- actions ---------------------------------------------------------
    def _record(self, now, action, replica, reason, sig, error=None,
                **extra):
        entry = {"t": now, "action": action, "replica": replica,
                 "reason": reason, "signals": sig}
        if error is not None:
            entry["error"] = error
        entry.update(extra)
        self.scaling_events.append(entry)
        _trace.event("serve/autoscale", cat="serve", action=action,
                     replica=replica, reason=reason)
        return entry

    def _scale_role(self, reasons) -> str:
        """Which ROLE the pressure calls for: prefill-only pressure
        wants a prefill specialist, anything decode-side on a
        disaggregated fleet wants a decode replica, and symmetric
        fleets always grow mixed (the only role add_replica accepts
        there)."""
        if not getattr(self.fleet, "_disagg", False):
            return "mixed"
        if reasons == ["prefill_queue"]:
            return "prefill"
        return "decode"

    def _scale_up(self, now, sig, reasons):
        reason = "+".join(reasons)
        fleet = self.fleet
        role = self._scale_role(reasons)
        # a drain in flight IS spare capacity: cancelling it is
        # cheaper than any spawn, and it cannot fail — but a drain is
        # always decode-side capacity, so prefill-only pressure skips
        # the cancel and buys an actual specialist (unless the spawn
        # gates — ceiling or cooldown — block it, where the cancel is
        # still strictly better than holding)
        prefill_can_spawn = (
            role == "prefill"
            and sig["routable"] < self.config.max_replicas
            and (self._last_up_t is None
                 or now - self._last_up_t
                 >= self.config.scale_up_cooldown_s))
        if self._draining_idx is not None and not prefill_can_spawn:
            idx = self._draining_idx
            fleet.cancel_drain(idx)
            self._draining_idx = None
            self._last_up_t = now
            self._c_ups.inc()
            self._log.info("autoscale: drain of replica %d cancelled "
                           "(%s)", idx, reason)
            return self._record(now, "drain_cancelled", idx, reason,
                                sig, role=role)
        try:
            # the fault site guards the WHOLE action: fired here,
            # nothing was constructed or registered — the decision
            # aborts typed and a later check retries it
            if _faults._armed:
                _faults.check("serve.autoscale")
            roles = getattr(fleet, "roles", None)
            retired = [r.idx for r in fleet._replicas if r.retired]
            # prefer a retired slot whose pinned role MATCHES the
            # pressure (reviving a decode slot does nothing for a
            # backed-up prefill side), then any retired slot for
            # mixed growth, then a fresh spawn with the right role
            match = [i for i in retired
                     if roles is None or roles[i] == role]
            if match:
                idx = match[0]
                fleet.revive(idx)
                how = "revive"
            elif retired and role == "mixed":
                idx = retired[0]
                fleet.revive(idx)
                how = "revive"
            else:
                idx = fleet.add_replica(role=role)
                how = "spawn"
        except Exception as e:
            self._c_failed.inc()
            self._log.warning("autoscale: scale-up abandoned (%r); "
                              "will retry", e)
            return self._record(now, "scale_up_failed", None, reason,
                                sig, error=repr(e), role=role)
        self._last_up_t = now
        self._c_ups.inc()
        self._log.info("autoscale: scale-up via %s -> %s replica %d "
                       "(%s)", how, role, idx, reason)
        return self._record(now, "scale_up", idx,
                            f"{reason} via={how}", sig, role=role)

    @staticmethod
    def _in_reconnect_grace(rep) -> bool:
        """A distributed replica still inside its transport reconnect
        (+grace) window must not be respawned: the worker may be about
        to resume its session, and a concurrent revive would
        double-spawn the replica index.  The deadline is on
        ``time.monotonic`` (transport time, not the autoscaler's
        signal clock) and cleared on resume / revive."""
        deadline = getattr(rep, "reconnect_deadline", None)
        return deadline is not None and time.monotonic() < deadline

    def _replace_dead(self, now, sig):
        """Replace a FAILED (not retired — those are deliberate
        scale-downs) replica: revive it on its pinned config so the
        fleet heals back to its pre-failure width without waiting for
        load pressure.  Runs before the pressure evaluation — a dead
        replica is lost capacity whatever the signals say — but
        respects the scale-up cooldown so a crash-looping replica
        cannot drive a revive storm.  Replicas inside a reconnect
        grace window are skipped (see ``_in_reconnect_grace``)."""
        fleet = self.fleet
        cfg = self.config
        if sig["routable"] >= cfg.max_replicas:
            return None
        if self._last_up_t is not None \
                and now - self._last_up_t < cfg.scale_up_cooldown_s:
            return None
        dead = [r for r in fleet._replicas
                if not r.healthy and not r.retired
                and not getattr(r, "needs_failover", False)
                and not self._in_reconnect_grace(r)]
        if not dead:
            return None
        rep = dead[0]
        roles = getattr(fleet, "roles", None)
        role = roles[rep.idx] if roles is not None else "mixed"
        try:
            if _faults._armed:
                _faults.check("serve.autoscale")
            fleet.revive(rep.idx)
        except Exception as e:
            self._c_failed.inc()
            self._log.warning(
                "autoscale: dead-replica replacement abandoned (%r); "
                "will retry", e)
            return self._record(now, "replace_failed", rep.idx,
                                "replica_dead", sig, error=repr(e),
                                role=role)
        self._last_up_t = now
        self._c_ups.inc()
        self._log.info("autoscale: dead %s replica %d replaced", role,
                       rep.idx)
        return self._record(now, "replace_dead", rep.idx,
                            "replica_dead", sig, role=role)

    def _begin_drain(self, now, sig):
        fleet = self.fleet
        # least-loaded routable victim: fewest queued + live requests
        # (cheapest to drain); prefill specialists are skipped — their
        # load is ship builds, priced separately
        cands = [v for v in fleet.load_views()
                 if not v["draining"] and v.get("role") != "prefill"]
        if len(cands) <= self.config.min_replicas:
            return None
        view = min(cands, key=lambda v: (v["queue_depth"]
                                         + v["occupancy"],
                                         -v["replica"]))
        idx = view["replica"]
        try:
            if _faults._armed:
                _faults.check("serve.autoscale")
            fleet.start_drain(idx)
        except Exception as e:
            self._c_failed.inc()
            return self._record(now, "scale_down_failed", idx,
                                "all_quiet", sig, error=repr(e))
        self._draining_idx = idx
        self._log.info("autoscale: draining replica %d toward "
                       "retirement", idx)
        return self._record(now, "drain_begin", idx, "all_quiet", sig)

    def _finish_drain(self, now, sig):
        idx = self._draining_idx
        try:
            self.fleet.retire_replica(idx)
        except RuntimeError:
            return None  # raced new work into the replica; keep waiting
        self._draining_idx = None
        self._last_down_t = now
        self._c_downs.inc()
        self._log.info("autoscale: replica %d retired", idx)
        return self._record(now, "drain_done", idx, "drained", sig)

    def _refresh_gauges(self):
        fleet = self.fleet
        serving = sum(r.healthy and not r.retired
                      for r in fleet._replicas)
        self._g_replicas.set(serving)
        self._g_draining.set(sum(r.draining for r in fleet._replicas))

    # -- reporting / lifecycle -------------------------------------------
    def section(self) -> dict:
        """JSON-able autoscaler state (SOAK.json's ``autoscale``
        key; the health report's section is registry-derived so it
        works cross-process, this one is richer)."""
        return {
            "enabled": True,
            "config": asdict(self.config),
            "replicas_serving": int(self._g_replicas.value),
            "draining": self._draining_idx,
            "scale_ups": self._c_ups.value,
            "scale_downs": self._c_downs.value,
            "decisions_failed": self._c_failed.value,
            "events": list(self.scaling_events),
        }

    def close(self):
        """Unregister the autoscaler's metrics (the fleet and any
        in-flight drain are left exactly as they are — closing the
        policy must not mutate capacity)."""
        if self._closed:
            return
        self.registry.remove(*self._registered)
        self._closed = True
