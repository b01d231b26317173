"""Multi-window SLO burn-rate alerting (the Google-SRE workbook
pattern) over the windowed telemetry layer.

The passive half already exists: every retire is checked against the
declared :class:`~singa_tpu_torch.observe.health.SLO` and breaches count
into ``serve.slo_violations{engine=,kind=}``.  This module is the
ACTIVE half — it answers "how fast is the error budget burning, and
is that page-worthy":

    burn_rate(window) = (violations/sec over window
                         / completions/sec over window) / budget_frac

A burn rate of 1 spends exactly the error budget (``budget_frac`` of
requests may violate); 14 spends a 30-day budget in ~2 days.  Each
:class:`BurnRule` pairs a LONG window (is this real?) with a SHORT
window (is it still happening?) and fires only when BOTH burn above
its threshold — the standard defense against paging on a blip and
against paging forever after a burst ends.  Alerts clear
HYSTERETICALLY: both windows must fall below
``threshold * clear_ratio`` before the alert clears, so a burn
hovering at the threshold doesn't flap.

Surfaces (all add-only):

* ``serve.slo.burn_rate{window=60}`` gauges — one per distinct window,
  refreshed on every :meth:`SLOPolicy.poll`;
* ``serve.slo.alert_firing{rule=page}`` gauges (0/1) and
  ``serve.slo.alerts_fired/alerts_cleared{rule=}`` counters;
* ``serve/slo_alert`` trace instants on every fire/clear (captured by
  the flight recorder even with tracing off);
* ``health_report()["serve"]["slo_alerts"]`` — always present,
  ``{"enabled": False}`` until a policy is installed;
* an ``on_alert(rule_name, firing, info)`` callback hook — the fleet
  autoscaler (serve/autoscale.py) subscribes here, and so can a pager.

Polling is THREADLESS by design (the ``Watchdog.check()`` idiom): the
owner calls :meth:`poll` from its drive loop with an injectable clock,
so every transition is deterministic under test.

The port's own copy of ``singa_tpu/observe/slo.py`` (it imports
nothing of the JAX package); the wire formats are the same.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from . import trace as _trace
from .registry import registry as _registry
from .timeseries import _wlabel

__all__ = ["BurnRule", "SLOPolicy", "DEFAULT_RULES", "install",
           "uninstall", "installed", "alerts_section"]


@dataclass(frozen=True)
class BurnRule:
    """One multi-window burn-rate alert.

    ``threshold`` is the burn-rate multiple both windows must exceed
    to fire; ``clear_ratio`` (in (0, 1]) scales it down for the clear
    condition (hysteresis).  The defaults below mirror the SRE
    workbook's page/ticket split, scaled to this layer's default
    window ladder."""

    name: str
    long_s: float
    short_s: float
    threshold: float
    clear_ratio: float = 0.8

    def validate(self):
        if not self.name:
            raise ValueError("BurnRule needs a name")
        if self.short_s <= 0 or self.long_s <= 0 \
                or self.short_s >= self.long_s:
            raise ValueError(
                f"BurnRule {self.name!r}: need 0 < short_s < long_s, "
                f"got short={self.short_s} long={self.long_s}")
        if self.threshold <= 0:
            raise ValueError(
                f"BurnRule {self.name!r}: threshold must be > 0, got "
                f"{self.threshold}")
        if not 0.0 < self.clear_ratio <= 1.0:
            raise ValueError(
                f"BurnRule {self.name!r}: clear_ratio must be in "
                f"(0, 1], got {self.clear_ratio}")


#: fast page (1m/5m) + slow ticket (30m/1h): the workbook pairing.
DEFAULT_RULES = (
    BurnRule("page", long_s=300.0, short_s=60.0, threshold=14.4),
    BurnRule("ticket", long_s=3600.0, short_s=1800.0, threshold=3.0),
)

# the installed policy (None = feature off): health_report reads the
# section through module functions so observe.health never imports a
# policy instance directly
_policy = None


def install(policy):
    """Make ``policy`` the process-wide one (last install wins — the
    health report shows one policy, like the watchdog)."""
    global _policy
    _policy = policy
    return policy


def uninstall(policy=None):
    """Detach the installed policy (or only ``policy`` if given and
    it is the installed one)."""
    global _policy
    if policy is None or _policy is policy:
        _policy = None


def installed():
    return _policy


def alerts_section() -> dict:
    """The ``health_report()["serve"]["slo_alerts"]`` section: always
    a dict with an ``enabled`` key so dashboards and CI can assert on
    it unconditionally."""
    if _policy is None:
        return {"enabled": False}
    return _policy.section()


class SLOPolicy:
    """Turn the per-retire violation counters into multi-window
    burn-rate alerts.

    >>> policy = observe.slo.SLOPolicy(slo, budget_frac=0.01)
    >>> while serving:
    ...     fleet.step()
    ...     policy.poll()          # threadless; injectable clock

    ``slo`` is the same object handed to ``model.serve(slo=...)`` —
    the policy never re-checks targets, it consumes the counters the
    engines already emit (``serve.slo_violations``) against the
    completion counters (``serve.completed``), summed across engines:
    a fleet burns ONE budget.  ``kinds`` restricts which violation
    kinds count as budget spend (default: the per-request kinds;
    ``queue`` violations are per scheduling pass, a different
    denominator).  ``budget_frac`` is the error budget as a fraction
    of requests (0.01 = 99% objective).

    ``install=True`` (default) registers the policy as the process
    policy so it surfaces in ``health_report()``; :meth:`close`
    unregisters the gauges and uninstalls."""

    def __init__(self, slo=None, budget_frac=0.01,
                 rules=DEFAULT_RULES, kinds=("ttft", "tpot"),
                 reg=None, clock=time.monotonic, on_alert=None,
                 ring_capacity=None, install=True):
        if not 0.0 < budget_frac < 1.0:
            raise ValueError(
                f"budget_frac must be in (0, 1), got {budget_frac}")
        rules = tuple(rules)
        if not rules:
            raise ValueError("need at least one BurnRule")
        for r in rules:
            r.validate()
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names: {names}")
        self.slo = slo
        self.budget_frac = float(budget_frac)
        self.rules = rules
        self.kinds = tuple(kinds)
        self.clock = clock
        self.on_alert = on_alert
        reg = reg if reg is not None else _registry()
        self.registry = reg
        self.windows = tuple(sorted(
            {r.short_s for r in rules} | {r.long_s for r in rules}))
        wkw = {} if ring_capacity is None else {
            "capacity": ring_capacity}
        self._wf_viol = reg.windowed(
            "serve.slo_violations", windows=self.windows, clock=clock,
            **wkw)
        self._wf_done = reg.windowed(
            "serve.completed", windows=self.windows, clock=clock,
            **wkw)
        self._g_burn = {
            w: reg.gauge("serve.slo.burn_rate",
                         help="error-budget burn-rate multiple over "
                              "the window (1 = spending exactly the "
                              "budget)", window=_wlabel(w))
            for w in self.windows}
        self._g_firing, self._c_fired, self._c_cleared = {}, {}, {}
        for r in rules:
            self._g_firing[r.name] = reg.gauge(
                "serve.slo.alert_firing",
                help="1 while the burn-rate alert is firing",
                rule=r.name)
            self._c_fired[r.name] = reg.counter(
                "serve.slo.alerts_fired",
                help="burn-rate alert fire transitions", rule=r.name)
            self._c_cleared[r.name] = reg.counter(
                "serve.slo.alerts_cleared",
                help="burn-rate alert clear transitions", rule=r.name)
        self._registered = (list(self._g_burn.values())
                            + list(self._g_firing.values())
                            + list(self._c_fired.values())
                            + list(self._c_cleared.values()))
        # rule name -> state dict (the section()/autoscaler surface)
        self.alerts = {
            r.name: {"firing": False, "since": None,
                     "burn_short": 0.0, "burn_long": 0.0,
                     "fired": 0, "cleared": 0}
            for r in rules}
        self._burn_last = {w: 0.0 for w in self.windows}
        if install:
            globals()["install"](self)

    # -- arithmetic ------------------------------------------------------
    def error_ratio(self, window, now=None) -> float:
        """Violations / completions over the window, fleet-summed.
        0.0 when nothing completed AND nothing violated; inf when
        violations arrive while completions are zero (a wedged fleet
        is burning budget, not idling)."""
        if now is None:
            now = self.clock()
        bad = sum(
            self._wf_viol.rate(window, now, match={"kind": k})
            for k in self.kinds)
        good = self._wf_done.rate(window, now)
        if good <= 0.0:
            return 0.0 if bad <= 0.0 else float("inf")
        return bad / good

    def burn_rate(self, window, now=None) -> float:
        """Error ratio over the window as a multiple of the budget."""
        return self.error_ratio(window, now) / self.budget_frac

    # -- the poll loop ---------------------------------------------------
    def poll(self, now=None) -> dict:
        """Refresh burn gauges and drive every rule's fire/clear state
        machine; returns :meth:`section`.  Safe to call as often as
        the owner likes — transitions are edge-triggered."""
        if now is None:
            now = self.clock()
        burns = {}
        for w in self.windows:
            b = self.burn_rate(w, now)
            burns[w] = b
            self._burn_last[w] = b
            # inf is honest (violations with zero completions); the
            # JSON writers sanitize it to null, Prometheus to +Inf
            self._g_burn[w].set(b)
        for rule in self.rules:
            st = self.alerts[rule.name]
            b_s, b_l = burns[rule.short_s], burns[rule.long_s]
            st["burn_short"], st["burn_long"] = b_s, b_l
            if not st["firing"]:
                if b_s >= rule.threshold and b_l >= rule.threshold:
                    st["firing"] = True
                    st["since"] = now
                    st["fired"] += 1
                    self._c_fired[rule.name].inc()
                    self._g_firing[rule.name].set(1)
                    self._transition(rule, True, b_s, b_l)
            else:
                clear_at = rule.threshold * rule.clear_ratio
                if b_s <= clear_at and b_l <= clear_at:
                    st["firing"] = False
                    st["since"] = None
                    st["cleared"] += 1
                    self._c_cleared[rule.name].inc()
                    self._g_firing[rule.name].set(0)
                    self._transition(rule, False, b_s, b_l)
        return self.section(now)

    def _transition(self, rule, firing, b_s, b_l):
        info = {"rule": rule.name, "firing": firing,
                "burn_short": b_s, "burn_long": b_l,
                "threshold": rule.threshold,
                "short_s": rule.short_s, "long_s": rule.long_s,
                "budget_frac": self.budget_frac}
        _trace.event("serve/slo_alert", cat="serve", **info)
        if self.on_alert is not None:
            # a raising subscriber must not kill the poll loop — the
            # alert state is already committed; log and move on
            try:
                self.on_alert(rule.name, firing, info)
            except Exception:
                from ..utils.logging import get_channel
                get_channel("observe").exception(
                    "slo on_alert callback raised for %s", rule.name)

    def firing(self, rule_name=None) -> bool:
        """True when the named rule (or ANY rule) is firing."""
        if rule_name is not None:
            return self.alerts[rule_name]["firing"]
        return any(st["firing"] for st in self.alerts.values())

    def section(self, now=None) -> dict:
        """The health/SOAK view of the policy state (always JSON-able;
        inf burn rates sanitize to null on the wire)."""
        return {
            "enabled": True,
            "budget_frac": self.budget_frac,
            "kinds": list(self.kinds),
            "burn_rates": {_wlabel(w): self._burn_last[w]
                           for w in self.windows},
            "rules": {
                r.name: {
                    "short_s": r.short_s, "long_s": r.long_s,
                    "threshold": r.threshold,
                    "clear_ratio": r.clear_ratio,
                    **self.alerts[r.name],
                } for r in self.rules},
        }

    def close(self):
        """Unregister the policy's gauges/counters and uninstall it
        (the windowed families stay — other consumers may share
        them)."""
        self.registry.remove(*self._registered)
        uninstall(self)
