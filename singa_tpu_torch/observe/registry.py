"""Process-wide metrics (the parts of ``singa_tpu/observe/registry.py``
that the port emits: ``opt.updates`` from training, the ``serve.*``
counters, gauges and latency histograms of the serve engine).

A metric is identified by ``(kind, name, frozen label set)``; asking the
registry for the same identity returns the same object.  ``remove``
drops metrics again (an engine's ``close()``).  Histograms keep their
samples in a :class:`LatencySeries` (``singa_tpu/utils/metrics.py``):
a ring of the newest samples and the exact all-time count.
"""

from __future__ import annotations

import collections
import math
import threading

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


def percentile(values, p) -> float:
    """Nearest-rank percentile (p in [0, 100]): an observed value, nan
    for no values."""
    vals = sorted(values)
    if not vals:
        return float("nan")
    if p <= 0:
        return float(vals[0])
    rank = math.ceil(min(p, 100) / 100.0 * len(vals))
    return float(vals[min(len(vals), max(1, rank)) - 1])


class LatencySeries:
    """Per-event latencies (seconds): the newest ``max_samples`` kept
    for percentiles, the count exact over every value recorded."""

    def __init__(self, max_samples=8192):
        self.values = collections.deque(maxlen=max_samples)
        self.count = 0

    def record(self, seconds):
        self.values.append(float(seconds))
        self.count += 1

    def percentile(self, p) -> float:
        return percentile(self.values, p)

    def summary(self) -> dict:
        vals = self.values
        return {"count": self.count,
                "mean": sum(vals) / len(vals) if vals else float("nan"),
                "p50": self.percentile(50), "p99": self.percentile(99),
                "max": max(vals) if vals else float("nan")}


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
