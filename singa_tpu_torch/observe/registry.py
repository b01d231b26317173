"""Process-wide metrics (the parts of ``singa_tpu/observe/registry.py``
that the port emits: ``opt.updates``, ``train.steps``,
``graph.cache_hit`` and ``graph.cache_miss`` from training, the ``serve.*``
counters, gauges and latency histograms of the serve engine).

A metric is identified by ``(kind, name, frozen label set)``; asking the
registry for the same identity returns the same object.  ``remove``
drops metrics again (an engine's ``close()``).  Histograms keep their
samples in a :class:`LatencySeries` (``utils/metrics.py``, the port's
copy of ``singa_tpu/utils/metrics.py``): a ring of the newest samples
and the exact all-time count.
"""

from __future__ import annotations

import threading

from ..utils.metrics import LatencySeries, percentile

__all__ = ["Counter", "Gauge", "Histogram", "LatencySeries",
           "MetricsRegistry", "percentile", "registry"]


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


class Gauge:
    """A value that is set, not accumulated."""

    KIND = "gauge"

    def __init__(self, name, labels=(), help=""):
        self.name = name
        self.labels = labels
        self.help = help
        self.value = 0.0

    def set(self, v):
        self.value = float(v)
        return self


class Histogram:
    """A latency distribution; ``series`` holds the samples."""

    KIND = "histogram"

    def __init__(self, name, labels=(), help=""):
        self.name = name
        self.labels = labels
        self.help = help
        self.series = LatencySeries()

    def observe(self, v):
        self.series.record(v)
        return self


def _label_key(labels: dict):
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """(kind, name, labels) -> metric map with get-or-create semantics."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, help, labels):
        key = (cls.KIND, name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(name, key[2], help=help)
            return m

    def counter(self, name, help="", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name, help="", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name, help="", **labels) -> Histogram:
        return self._get(Histogram, name, help, labels)

    def remove(self, *metrics):
        """Drop ``metrics`` from the registry (the objects keep working)."""
        with self._lock:
            for m in metrics:
                self._metrics.pop((m.KIND, m.name, m.labels), None)


_default = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide default registry."""
    return _default
