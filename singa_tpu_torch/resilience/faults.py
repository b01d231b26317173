"""Fault injection (counterpart of ``singa_tpu/resilience/faults.py``):
a process-wide registry of named injection sites.

Code threads ``check(site)`` through its failure-prone paths, and chaos
tests arm a seeded-deterministic policy at a site to make the real code
path fail exactly there.  Disarmed (the default) a hook is one read of
the module flag ``_armed``.  Policies fire deterministically:
:class:`FailRate` draws from its own ``random.Random(seed)``,
:class:`FailOnce` and :class:`FailAfterN` count calls.  Every fired fault
increments ``resilience.faults_injected{site=}`` in the port's registry
and emits a ``resilience/fault`` trace event.

The site names are the JAX package's (:data:`SITES`); the port threads
``checkpoint.write`` and ``checkpoint.read`` (``Model.save_states`` and
``load_states``, ``Snapshot``, ``CheckpointManager``), ``io.binfile``
(the BinFile reader and writer), ``serve.prefix_copy`` (the prefix
cache's own pool copies), ``serve.prefill_chunk`` (a chunked admission's
pass), ``serve.fork_copy`` (a fork branch's copy-on-write block copy),
``serve.decode_step``, and the fleet's ``serve.route`` (admission
routing), ``serve.kv_ship`` (both halves of a KV ship) and
``serve.autoscale`` (a scaling action) so far.
"""

from __future__ import annotations

import random
import threading
import time
from contextlib import contextmanager

from ..observe import trace as _trace
from ..observe.registry import registry as _registry
from ..utils.logging import get_channel

__all__ = ["SITES", "FaultInjected", "FailOnce", "FailRate",
           "FailAfterN", "Latency", "inject", "injected", "clear",
           "armed", "check"]

#: The JAX package's canonical injection sites.  ``check`` takes any
#: name; the port hooks those the module docstring names.
SITES = (
    "checkpoint.write", "checkpoint.read", "comm.collective",
    "serve.decode_step", "serve.ep_dispatch", "serve.pp_boundary",
    "serve.prefill_chunk", "serve.prefix_copy", "serve.route",
    "serve.kv_ship", "serve.fork_copy", "serve.autoscale",
    "serve.dist.rpc", "serve.dist.frame", "io.binfile", "train.step",
)


class FaultInjected(RuntimeError):
    """Raised at an armed injection site.  ``transient`` feeds the
    retry layer's classification: transient injected faults are
    retried (modelling flaky I/O), fatal ones are not (modelling
    corruption)."""

    def __init__(self, site, message=None, transient=True):
        super().__init__(message or f"injected fault at {site}")
        self.site = site
        self.transient = transient


class _Policy:
    """Base policy: subclasses decide *whether* call N fires; the base
    owns *what* firing means (latency, then the optional error).
    ``latency_s`` alone (no error) models a slow but healthy path."""

    def __init__(self, transient=True, latency_s=0.0, error=None):
        self.transient = transient
        self.latency_s = float(latency_s)
        self.error = error  # optional exception INSTANCE to raise
        self.calls = 0
        self.fired = 0
        self._lock = threading.Lock()

    def _should_fire(self) -> bool:  # pragma: no cover - abstract
        raise NotImplementedError

    def fire(self, site):
        with self._lock:
            self.calls += 1
            hit = self._should_fire()
            if hit:
                self.fired += 1
        if self.latency_s > 0.0:
            time.sleep(self.latency_s)
        if not hit:
            return
        _registry().counter(
            "resilience.faults_injected",
            help="faults fired by the injection registry",
            site=site).inc()
        _trace.event("resilience/fault", cat="resilience", site=site,
                     policy=type(self).__name__, transient=self.transient)
        get_channel("resilience").warning(
            "injected fault at %s (%s, fired=%d)", site,
            type(self).__name__, self.fired)
        if self.error is not None:
            raise self.error
        raise FaultInjected(site, transient=self.transient)


class FailOnce(_Policy):
    """Fire on the first call, pass forever after — the canonical
    transient fault a retry should absorb."""

    def _should_fire(self):
        return self.fired == 0


class FailRate(_Policy):
    """Fire each call with probability ``rate``, drawn from a private
    seeded RNG — deterministic per (seed, call sequence)."""

    def __init__(self, rate, seed=0, **kw):
        super().__init__(**kw)
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        self.rate = float(rate)
        self._rng = random.Random(seed)

    def _should_fire(self):
        return self._rng.random() < self.rate


class FailAfterN(_Policy):
    """Pass the first ``n`` calls, then fire ``times`` consecutive
    calls (default 1), then pass again — "the run died at step N"."""

    def __init__(self, n, times=1, **kw):
        super().__init__(**kw)
        self.n = int(n)
        self.times = int(times)

    def _should_fire(self):
        return self.calls > self.n and self.fired < self.times


class Latency(_Policy):
    """Pure latency injection: every call sleeps ``latency_s`` and
    never raises — models a degraded-but-alive dependency."""

    def __init__(self, latency_s, **kw):
        super().__init__(latency_s=latency_s, **kw)

    def _should_fire(self):
        return False


# -- the registry -----------------------------------------------------------

_lock = threading.Lock()
_policies: dict = {}
# module-global arm flag: the ONLY thing a disarmed hook reads
_armed = False


def inject(site, policy) -> _Policy:
    """Arm ``policy`` at ``site`` (replacing any previous policy
    there).  Returns the policy so tests can read ``.fired``."""
    global _armed
    with _lock:
        _policies[site] = policy
        _armed = True
    return policy


def clear(site=None):
    """Disarm ``site``, or every site when None.  When the last policy
    goes, the module flag drops and every hook is a single bool read
    again."""
    global _armed
    with _lock:
        if site is None:
            _policies.clear()
        else:
            _policies.pop(site, None)
        _armed = bool(_policies)


@contextmanager
def injected(site, policy):
    """Scoped injection for tests: arm on entry, disarm on exit."""
    inject(site, policy)
    try:
        yield policy
    finally:
        clear(site)


def armed() -> bool:
    return _armed


def check(site):
    """The hook production code calls at an injection site.  Disarmed:
    one global read and return.  Armed with a policy at ``site``: the
    policy decides whether this call sleeps and/or raises."""
    if not _armed:
        return
    pol = _policies.get(site)
    if pol is not None:
        pol.fire(site)
