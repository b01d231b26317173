"""Process-wide counters (the part of ``singa_tpu/observe/registry.py``
that the training path emits: ``opt.updates``).

A metric is identified by ``(name, frozen label set)``; asking the
registry for the same identity returns the same object.
"""

from __future__ import annotations

import threading

__all__ = ["Counter", "MetricsRegistry", "registry"]


class Counter:
    """Monotonically increasing count."""

    KIND = "counter"

    def __init__(self, name, labels=(), help=""):
        self.name = name
        self.labels = labels  # sorted tuple of (key, value) pairs
        self.help = help
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n=1):
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc({n}))")
        with self._lock:
            self.value += n
        return self


def _label_key(labels: dict):
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Name+labels -> counter map with get-or-create semantics."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def counter(self, name, help="", **labels) -> Counter:
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = Counter(name, key[1], help=help)
            return m


_default = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide default registry."""
    return _default
