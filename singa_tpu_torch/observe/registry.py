"""Process-wide metrics registry — the state half of ``singa_tpu_torch.observe``.

Three metric kinds, the Prometheus trinity:

* :class:`Counter` — monotone count (cache misses, tokens emitted,
  collectives issued).
* :class:`Gauge` — last-written level (queue depth, slot occupancy).
* :class:`Histogram` — per-event value distribution; adopts the
  existing :class:`~singa_tpu_torch.utils.metrics.LatencySeries` wholesale,
  so its ``summary()`` is the same count/mean/p50/p99/max schema the
  serving stats already report (nearest-rank percentiles, see
  ``utils.metrics.percentile``).

A metric is identified by ``(name, frozen label set)`` — asking the
registry for the same identity returns the SAME object (get-or-create),
which is what lets independent subsystems (``serve.EngineStats``, the
graph runner, the communicator) accumulate into one process-wide
surface without coordination.  Re-registering an identity as a
different kind raises: silent type morphing is how dashboards break.

The default process registry is reachable via :func:`registry`;
isolated registries (tests, per-bench snapshots) are just
``MetricsRegistry()`` instances.  Export: ``snapshot()`` here (stable
JSON-able dict), Prometheus text exposition in ``export.py``.

The port's own copy of ``singa_tpu/observe/registry.py`` (it imports
nothing of the JAX package); the wire formats are the same.
"""

from __future__ import annotations

import bisect as _bisect
import threading
import time as _time

from ..utils.metrics import LatencySeries

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "registry", "DEFAULT_BUCKETS"]

#: the root of the wire schemas' names (``<root>.telemetry/1``,
#: ``.health/1``, ``.crash/1``): the JAX package's, so dumps, health
#: reports and crash bundles of the two packages read and merge alike
SCHEMA_ROOT = "singa_tpu"

#: default cumulative-histogram bucket ladder (seconds): latency-
#: shaped, 1ms..2min.  Buckets exist for the PROMETHEUS side — a
#: summary's precomputed quantiles cannot be aggregated across a fleet
#: of replicas, while ``sum(rate(x_bucket[5m])) by (le)`` +
#: ``histogram_quantile()`` can.  Override per metric via
#: ``registry.histogram(name, buckets=...)``.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)


class _Metric:
    __slots__ = ("name", "labels", "help", "_lock", "_rings")

    KIND = "metric"

    def __init__(self, name, labels, help=""):
        self.name = name
        self.labels = labels  # tuple of (key, value) pairs, sorted
        self.help = help
        # per-metric lock: `value += n` is a read-modify-write across
        # bytecodes, and the observe layer promises concurrent use
        # (async-checkpoint writer thread + main loop)
        self._lock = threading.Lock()
        # windowed-telemetry rings (observe.timeseries), attached by
        # ``MetricsRegistry.windowed``: every value write appends the
        # new value.  Empty tuple when no window is registered — the
        # hot-path cost of the feature being off is one truthiness
        # check.
        self._rings = ()

    @property
    def key(self):
        return (self.name, self.labels)


class Counter(_Metric):
    """Monotonically increasing count."""

    __slots__ = ("value",)

    KIND = "counter"

    def __init__(self, name, labels=(), help=""):
        super().__init__(name, labels, help)
        self.value = 0

    def inc(self, n=1):
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc({n})); use a Gauge")
        with self._lock:
            self.value += n
            # inside the lock: two concurrent incs must append their
            # cumulative samples in value order, or a ring's newest
            # sample can sit BELOW the true cumulative value and
            # under-report the window's growth
            if self._rings:
                for r in self._rings:
                    r.append(self.value)
        return self


class Gauge(_Metric):
    """Last-written level; ``set``/``inc``/``dec``."""

    __slots__ = ("value",)

    KIND = "gauge"

    def __init__(self, name, labels=(), help=""):
        super().__init__(name, labels, help)
        self.value = 0.0

    def set(self, v):
        self.value = v
        if self._rings:
            for r in self._rings:
                r.append(v)
        return self

    def inc(self, n=1):
        with self._lock:
            self.value += n
            if self._rings:  # in value order — see Counter.inc
                for r in self._rings:
                    r.append(self.value)
        return self

    def dec(self, n=1):
        with self._lock:
            self.value -= n
            if self._rings:  # in value order — see Counter.inc
                for r in self._rings:
                    r.append(self.value)
        return self


class Histogram(_Metric):
    """Value distribution over a :class:`LatencySeries` (count/mean/
    p50/p99/max summary schema).  ``buckets``: cumulative upper bounds
    for the Prometheus ``_bucket{le=...}`` exposition (+Inf is
    implicit); defaults to :data:`DEFAULT_BUCKETS`."""

    __slots__ = ("series", "buckets", "_bins")

    KIND = "histogram"

    def __init__(self, name, labels=(), help="", series=None,
                 buckets=None):
        super().__init__(name, labels, help)
        self.series = series if series is not None else LatencySeries()
        if buckets is None:
            self.buckets = DEFAULT_BUCKETS
        else:
            b = tuple(float(x) for x in buckets)
            if not b or list(b) != sorted(set(b)):
                raise ValueError(
                    f"buckets must be non-empty, strictly increasing, "
                    f"got {buckets}")
            self.buckets = b
        # per-ladder-bin counts, filled AT RECORD TIME through the
        # series' hook seam: adopters record into the series directly
        # (EngineStats), so observe() cannot be the binning point, and
        # the series' retained-value ring is BOUNDED (values age out),
        # so a read-side catch-up could miss evicted values.  A
        # record-time hook is O(log buckets) per event and keeps the
        # cumulative bins exact over all time — the Prometheus
        # histogram contract — regardless of the retained window.
        self._bins = [0] * len(self.buckets)
        for v in self.series.values:  # adopt pre-existing samples
            self._bin(v)
        self.series.add_hook(self._bin)

    def _bin(self, v):
        i = _bisect.bisect_left(self.buckets, v)
        if i < len(self._bins):
            self._bins[i] += 1

    def observe(self, v):
        self.series.record(v)
        return self

    @property
    def count(self):
        return self.series.count

    def bucket_counts(self) -> list:
        """Cumulative ``(le, count)`` pairs, ending with ``(inf,
        count)``.  Bins are maintained at record time (O(log buckets)
        per event), so a scrape's cost does not grow with process
        uptime and the bins stay cumulative over all time even though
        the retained value window is bounded.  The +Inf bucket uses
        the series' RUNNING count (same source as ``_count``), so
        ``x_bucket{le="+Inf"} == x_count`` always holds."""
        out, c = [], 0
        for le, n in zip(self.buckets, self._bins):
            c += n
            out.append((le, c))
        out.append((float("inf"), self.series.count))
        return out

    def summary(self) -> dict:
        return self.series.summary()


def _label_key(labels: dict):
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Name+labels -> metric map with get-or-create semantics."""

    def __init__(self):
        self._metrics = {}
        self._kinds = {}  # name -> metric class (one kind per name)
        self._windowed = {}  # name -> timeseries.WindowedFamily
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, labels, help, **kw):
        key = (name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                # one kind per NAME, not just per (name, labels): a
                # Prometheus family declares a single TYPE, so a
                # counter x{op=a} next to a gauge x{op=b} would render
                # an exposition conformant scrapers reject
                prior = self._kinds.get(name)
                if prior is not None and prior is not cls:
                    raise TypeError(
                        f"metric name {name!r} already registered as "
                        f"{prior.KIND}, requested {cls.KIND} (one kind "
                        f"per name — Prometheus families share a TYPE)")
                m = cls(name, key[1], help=help, **kw)
                self._metrics[key] = m
                self._kinds[name] = cls
                wf = self._windowed.get(name)
                if wf is not None:
                    # the family pre-dates this label set (a fleet
                    # scale-up registering a new engine's counters):
                    # windowing follows the name, not the moment
                    wf._attach(m)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r}{dict(key[1])} already registered "
                    f"as {m.KIND}, requested {cls.KIND}")
            return m

    def counter(self, name, help="", **labels) -> Counter:
        return self._get_or_create(Counter, name, labels, help)

    def gauge(self, name, help="", **labels) -> Gauge:
        return self._get_or_create(Gauge, name, labels, help)

    def histogram(self, name, help="", series=None, buckets=None,
                  **labels) -> Histogram:
        """``series``: adopt an existing LatencySeries as the backing
        store (EngineStats hands its TTFT/TPOT series over this way —
        one copy of the data, two views).  ``buckets``: per-metric
        Prometheus bucket-ladder override (first registration wins —
        get-or-create semantics)."""
        return self._get_or_create(Histogram, name, labels, help,
                                   series=series, buckets=buckets)

    def windowed(self, name, windows=None, capacity=None,
                 clock=None) -> "WindowedFamily":
        """Attach windowed telemetry (observe.timeseries) to every
        metric named ``name`` — current AND future label sets — and
        return the :class:`~singa_tpu_torch.observe.timeseries
        .WindowedFamily` (get-or-create: asking again for the same
        name returns the SAME family; windows/capacity/clock are
        first-registration-wins, like histogram buckets).

        >>> wf = registry().windowed("serve.completed", windows=(60,))
        >>> wf.rate(60)      # completions/s over the last minute

        The family's values ride ``export.prometheus_text`` as sibling
        ``<name>_rate_60s``-style gauges and
        ``health_report()["windowed"]``; the all-time family is
        untouched.  Memory: one bounded ring per label set, O(ring)
        forever."""
        from .timeseries import (DEFAULT_RING_CAPACITY,
                                 DEFAULT_WINDOWS, WindowedFamily)

        with self._lock:
            wf = self._windowed.get(name)
            if wf is None:
                kind = self._kinds.get(name)
                wf = WindowedFamily(
                    name,
                    kind.KIND if kind is not None else None,
                    windows=(windows if windows is not None
                             else DEFAULT_WINDOWS),
                    capacity=(capacity if capacity is not None
                              else DEFAULT_RING_CAPACITY),
                    clock=clock if clock is not None else _time.monotonic)
                self._windowed[name] = wf
                for (n, _), m in self._metrics.items():
                    if n == name:
                        wf._attach(m)
            return wf

    def windowed_families(self) -> dict:
        """``{name: WindowedFamily}`` of every windowed registration
        (the health report's ``windowed`` section source)."""
        with self._lock:
            return dict(self._windowed)

    def unwindow(self, name):
        """Drop a windowed family (tests, policy teardown).  The
        attached counter/gauge rings stop being read and are dropped;
        histogram series hooks are detached."""
        with self._lock:
            wf = self._windowed.pop(name, None)
            if wf is None:
                return
            for (n, _), m in self._metrics.items():
                if n == name:
                    wf._detach_metric(m)

    def metrics(self) -> list:
        """All registered metrics, in stable (name, labels) order."""
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def remove(self, *metrics):
        """Unregister metric objects (e.g. a retired engine's
        ``serve.*`` set — see ``EngineStats.unregister``) so a
        process-lifetime registry doesn't pin dead subsystems'
        histograms forever.  Unknown metrics are ignored.  A name
        whose last metric is removed frees its kind reservation too.
        Windowed rings attached to the removed metrics are detached
        with them — a retired engine's windowed series disappears
        instead of freezing at its last value (the scale-down
        leaked-gauge contract)."""
        with self._lock:
            for m in metrics:
                self._metrics.pop(m.key, None)
                wf = self._windowed.get(m.name)
                if wf is not None:
                    wf._detach_metric(m)
            names = {name for name, _ in self._metrics}
            for name in [n for n in self._kinds if n not in names]:
                del self._kinds[name]

    def clear(self):
        with self._lock:
            self._metrics.clear()
            self._kinds.clear()
            self._windowed.clear()

    def dump(self) -> dict:
        """Wire-serializable full dump (the federation telemetry
        schema, ``observe.federate``): one dict per metric with
        name/kind/labels/help, plus value (counter/gauge) or the full
        cumulative bucket ladder + running sum/count + exact
        nearest-rank p50/p99 (histogram).  Unlike :meth:`snapshot`
        this ships the BUCKETS, so a controller can re-expose a
        worker's histograms as real TYPE-histogram families that
        ``histogram_quantile`` aggregates across hosts."""
        out = []
        for m in self.metrics():
            d = {"name": m.name, "kind": m.KIND,
                 "labels": [list(kv) for kv in m.labels],
                 "help": m.help}
            if isinstance(m, Histogram):
                d["buckets"] = [[le, c] for le, c in
                                m.bucket_counts()]
                d["sum"] = m.series.total_sum
                d["count"] = m.series.count
                d["p50"] = m.series.percentile(50)
                d["p99"] = m.series.percentile(99)
            else:
                d["value"] = m.value
            out.append(d)
        return {"schema": f"{SCHEMA_ROOT}.telemetry/1", "metrics": out}

    def snapshot(self) -> dict:
        """JSON-able view: ``{"counters": {...}, "gauges": {...},
        "histograms": {...}}`` keyed ``name{k=v,...}`` (labels sorted,
        braces omitted when unlabeled)."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for m in self.metrics():
            k = m.name
            if m.labels:
                k += "{" + ",".join(f"{lk}={lv}"
                                    for lk, lv in m.labels) + "}"
            if isinstance(m, Counter):
                out["counters"][k] = m.value
            elif isinstance(m, Histogram):
                out["histograms"][k] = m.summary()
            else:
                out["gauges"][k] = m.value
        return out


_default = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide default registry."""
    return _default
