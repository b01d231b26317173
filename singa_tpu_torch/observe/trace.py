"""Host-side span tracing (the part of ``singa_tpu/observe/trace.py`` that
the port emits: the ``opt/update`` span of training, the serve engine's
``serve/decode_step`` and ``serve/prefill`` spans and its
``serve/retire`` and ``serve/request_rejected`` instants).

Spans are recorded as complete events at exit.  Disabled, ``span()`` is
one flag check and returns a shared no-op context manager.

Event record schema (plain dicts)::

    {"name": str, "cat": str, "ph": "X" (span) or "i" (instant),
     "ts": float seconds,
     "dur": float seconds, "tid": str thread name, "depth": int,
     "parent": str | None, "args": dict | None}
"""

from __future__ import annotations

import threading
import time

__all__ = ["enable", "disable", "drain", "event", "span"]

_enabled = False
_events: list = []
_tls = threading.local()


def enable():
    """Turn tracing on."""
    global _enabled
    _enabled = True


def disable():
    """Turn tracing off (buffer kept)."""
    global _enabled
    _enabled = False


def drain() -> list:
    """Return the buffered events and clear the buffer."""
    global _events
    out, _events = _events, []
    return out


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def set(self, **args):
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("name", "cat", "args", "_t0", "_parent", "_depth")

    def __init__(self, name, cat, args):
        self.name = name
        self.cat = cat
        self.args = args or None

    def set(self, **args):
        """Attach or overwrite span args mid-flight."""
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
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        t1 = time.perf_counter()
        st = _stack()
        if st and st[-1] == self.name:
            st.pop()
        if _enabled:
            _events.append({
                "name": self.name, "cat": self.cat, "ph": "X",
                "ts": self._t0, "dur": t1 - self._t0,
                "tid": threading.current_thread().name,
                "depth": self._depth, "parent": self._parent,
                "args": self.args})
        return False


def span(name: str, cat: str = "app", **args):
    """Context manager timing one scope on the host clock."""
    if not _enabled:
        return _NULL_SPAN
    return _Span(name, cat, args)


def event(name: str, cat: str = "app", **args):
    """Record an instant (``"ph": "i"``, ``dur`` 0) when tracing is on."""
    if not _enabled:
        return
    st = _stack()
    _events.append({
        "name": name, "cat": cat, "ph": "i", "ts": time.perf_counter(),
        "dur": 0.0, "tid": threading.current_thread().name,
        "depth": len(st), "parent": st[-1] if st else None,
        "args": args or None})
