"""Span tracing — the event half of ``singa_tpu_torch.observe``.

Dapper-style host-side spans over the stack's hot paths (graph-mode
compile/replay, optimizer update, collectives at trace time, async
checkpoint, serve prefill/decode/retire), answering "where did this
step's time go?" with one buffer that every exporter in ``export.py``
reads (JSONL, Chrome trace-event JSON for Perfetto, and — for the
registry — Prometheus text).

Design constraints, in priority order:

1. **near-zero cost when disabled** — ``span()``/``event()`` are one
   module-global flag check; ``span()`` returns a shared singleton
   no-op context manager, so the disabled fast path allocates nothing
   (tests assert identity).  Instrumentation can therefore live
   permanently in hot loops (the serve engine's per-step path,
   ``_GraphRunner.run``).
2. **injectable clock** — ``enable(clock=...)`` takes any ``()->
   float`` seconds callable, making span timestamps/durations exactly
   deterministic in tests (the same pattern the serve engine uses for
   its scheduling clock).
3. **thread-aware** — spans nest per thread (a thread-local stack
   tracks depth and parent), and the buffer append is a single CPython
   list.append (atomic under the GIL), so the async-checkpoint writer
   thread and the main loop can trace concurrently without locks.

Spans are recorded as COMPLETE events at exit (Chrome "X" phase: one
record with ``ts`` + ``dur``) rather than begin/end pairs — half the
buffer traffic, and exporters never see an unmatched begin.  A span
that is still open when the buffer is drained is simply absent; wrap
the drain in the outermost scope you care about.

Event record schema (plain dicts, stable keys)::

    {"name": str, "cat": str, "ph": "X" | "i",
     "ts": float seconds, "dur": float seconds ("X" only),
     "tid": str thread name, "depth": int, "parent": str | None,
     "args": dict | None}

Usage::

    from singa_tpu_torch import observe
    observe.enable()
    with observe.span("train/step", cat="train", step=i) as sp:
        ...
        sp.set(loss=float(loss))           # attach args mid-span
    observe.event("cache/miss", cat="train", key=k)

    @observe.traced                        # or @observe.traced("name")
    def prefill(...): ...

    observe.export.write_chrome_trace("/tmp/trace.json")

The port's own copy of ``singa_tpu/observe/trace.py`` (it imports
nothing of the JAX package); the wire formats are the same.
"""

from __future__ import annotations

import functools
import threading
import time

__all__ = ["enable", "disable", "is_enabled", "clear", "drain",
           "events", "span", "event", "traced", "set_max_events",
           "dropped"]

# Module-global fast path: `if not _active: return _NULL_SPAN` is the
# ENTIRE disabled cost of a span.  The buffer is a flat list of dicts;
# list.append is atomic under the GIL, so writer threads need no lock.
# ``_active`` is ``_enabled or (flight-recorder ring attached)``: the
# monitor's always-on crash ring (observe/monitor.py) receives every
# record regardless of enable(), so instrumentation keeps feeding the
# forensic buffer even when full tracing is off.
_enabled = False
_active = False
_ring = None  # deque(maxlen=N) owned by monitor.FlightRecorder
_clock = time.perf_counter
_events: list = []
_dropped = 0
_max_events = 1_000_000  # hard cap: a forgotten enable() cannot OOM
_tls = threading.local()


def _update_active():
    global _active
    _active = _enabled or _ring is not None


def _attach_ring(ring):
    """Internal (monitor.FlightRecorder): route every emitted record
    into ``ring`` (an append-only bounded buffer, e.g. a deque with
    maxlen) in ADDITION to the main buffer; ``None`` detaches."""
    global _ring
    _ring = ring
    _update_active()


def enable(clock=None):
    """Turn tracing on.  ``clock``: ``() -> float`` seconds (default
    ``time.perf_counter``); inject a fake for deterministic tests."""
    global _enabled, _clock
    if clock is not None:
        _clock = clock
    _enabled = True
    _update_active()


def disable():
    """Turn tracing off (buffer retained — export then ``clear()``)
    and restore the default clock."""
    global _enabled, _clock
    _enabled = False
    _clock = time.perf_counter
    _update_active()


def is_enabled() -> bool:
    return _enabled


def clear():
    """Drop all buffered events (and the drop counter)."""
    drain()


def events() -> list:
    """Snapshot copy of the buffered events (safe while tracing)."""
    return list(_events)


def drain() -> list:
    """Return the buffered events and clear the buffer.  The buffer is
    SWAPPED (one rebind), not copied-then-deleted: a writer thread
    racing the drain lands its event either in the returned list or in
    the fresh buffer — never silently dropped."""
    global _events, _dropped
    out, _events = _events, []
    _dropped = 0
    return out


def dropped() -> int:
    """Events discarded because the buffer hit ``set_max_events``."""
    return _dropped


def set_max_events(n: int):
    """Resize the buffer cap (default 1e6 events)."""
    global _max_events
    if n < 1:
        raise ValueError(f"max_events must be >= 1, got {n}")
    _max_events = int(n)


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _emit(rec: dict):
    global _dropped
    if _ring is not None:
        _ring.append(rec)  # bounded by construction (deque maxlen)
    if not _enabled:
        return
    if len(_events) >= _max_events:
        _dropped += 1
        return
    _events.append(rec)


class _NullSpan:
    """The shared disabled-mode span: enters/exits/sets for free.
    ``span()`` returns THIS object (no allocation) when tracing is
    off — the identity is part of the overhead contract."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def set(self, **args):
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "cat", "args", "_t0", "_parent", "_depth",
                 "_clk")

    def __init__(self, name, cat, args):
        self.name = name
        self.cat = cat
        self.args = args or None

    def set(self, **args):
        """Attach/overwrite span args mid-flight (e.g. a compile's
        cost-table numbers discovered inside the span)."""
        if self.args is None:
            self.args = args
        else:
            self.args.update(args)
        return self

    def __enter__(self):
        st = _stack()
        self._parent = st[-1] if st else None
        self._depth = len(st)
        st.append(self.name)
        self._clk = _clock
        self._t0 = _clock()
        return self

    def __exit__(self, *a):
        t1 = _clock()
        st = _stack()
        if st and st[-1] == self.name:
            st.pop()
        if not _active or _clock is not self._clk:
            # tracing AND recorder off, or enable()/disable() swapped
            # the clock mid-span: in the latter case the duration
            # would mix two time bases (garbage — possibly negative
            # billions of seconds), and no buffer, ring included, may
            # ever receive such a record
            return False
        _emit({"name": self.name, "cat": self.cat, "ph": "X",
               "ts": self._t0, "dur": t1 - self._t0,
               "tid": threading.current_thread().name,
               "depth": self._depth, "parent": self._parent,
               "args": self.args})
        return False


def span(name: str, cat: str = "app", **args):
    """Context manager timing one scope.  ``cat`` groups spans into
    one exporter track per subsystem (train/serve/comms/snapshot/...);
    keyword args become Chrome-trace span args."""
    if not _active:
        return _NULL_SPAN
    return _Span(name, cat, args)


def event(name: str, cat: str = "app", **args):
    """Zero-duration instant (Chrome "i" phase) — cache misses,
    collective issues, admissions."""
    if not _active:
        return
    st = _stack()
    _emit({"name": name, "cat": cat, "ph": "i", "ts": _clock(),
           "tid": threading.current_thread().name,
           "depth": len(st), "parent": st[-1] if st else None,
           "args": args or None})


def traced(fn=None, *, name=None, cat="app"):
    """Decorator form of ``span``: ``@traced`` or
    ``@traced(name="serve/prefill", cat="serve")``.  Disabled-mode
    cost is the one flag check."""
    if fn is None:
        return functools.partial(traced, name=name, cat=cat)
    label = name or getattr(fn, "__qualname__", fn.__name__)

    @functools.wraps(fn)
    def wrapper(*a, **kw):
        if not _active:
            return fn(*a, **kw)
        with _Span(label, cat, None):
            return fn(*a, **kw)

    return wrapper
