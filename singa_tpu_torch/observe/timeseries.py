"""Windowed telemetry: bounded (timestamp, value) rings over registry
metrics — the "last 60 seconds" truth next to the all-time truth.

Everything the registry exports is ALL-TIME (monotone counters,
lifetime histograms): perfect for audits, useless for control loops —
"the error budget is burning 14x too fast over the last minute" needs
a rate over a window, and "TTFT p99 over the last 10 minutes" needs
quantiles over recent samples only.  This module adds that layer
without touching the existing schema:

* :class:`WindowRing` — a bounded ring of ``(t, value)`` samples with
  an injectable clock.  O(capacity) memory forever; reads scan only
  the in-window tail.
* :class:`WindowedFamily` — windowed views over every metric of one
  NAME (all label sets), created by
  ``registry.windowed(name, windows=(60, 600, 3600))``.  Counters
  record their cumulative value on every ``inc`` (``rate(window)`` =
  growth over the window / window); histograms record each observed
  value (``quantile``/``mean`` over the in-window samples, ``rate`` =
  events/s); gauges record each written level (``mean``/``quantile``).
  Metrics registered LATER under the same name (a new engine label
  from a fleet scale-up) attach automatically, and
  ``MetricsRegistry.remove`` detaches their rings — a retired
  replica's windowed series disappears with its all-time series
  instead of freezing at its last value.

The windowed values ride the existing exporters as SIBLING gauges
(``<name>_rate_60s{...}``-style — see ``export.prometheus_text``) and
``health_report()["windowed"]``; the all-time families are unchanged
(add-only).  ``observe/slo.py`` builds multi-window burn-rate alerts
on exactly this surface.

Clock discipline: every read method takes ``now=None`` (defaults to
the ring's clock) so tests and pollers are deterministic under a fake
clock.  A clock that goes BACKWARDS never corrupts a ring: samples
are kept in append order, the in-window scan walks from the newest
sample toward the oldest and stops at the first one older than
``now - window`` — a sample stamped "in the future" (recorded before
the clock stepped back) simply counts as in-window.

The port's own copy of ``singa_tpu/observe/timeseries.py`` (it imports
nothing of the JAX package); the wire formats are the same.
"""

from __future__ import annotations

import collections
import time

from ..utils.metrics import percentile as _percentile

__all__ = ["WindowRing", "WindowedFamily", "DEFAULT_WINDOWS",
           "DEFAULT_RING_CAPACITY"]

#: default window ladder (seconds): 1m / 10m / 1h — the Google-SRE
#: alerting windows' order of magnitude, overridable per family.
DEFAULT_WINDOWS = (60.0, 600.0, 3600.0)

#: default per-ring sample bound.  4096 samples cover an hour at >1
#: event/s; beyond that the oldest samples age out and the longest
#: windows degrade toward "since the oldest retained sample" — O(ring)
#: memory forever is the contract, not unbounded fidelity.
DEFAULT_RING_CAPACITY = 4096


class WindowRing:
    """Bounded ring of ``(t, value)`` samples.

    ``kind`` decides the arithmetic:

    * ``"counter"`` — samples are CUMULATIVE values (appended on every
      ``inc``); :meth:`rate` is the value growth across the window
      divided by the window.  The ring tracks the last value EVICTED
      (``_floor``) so a wrapped ring still has a baseline, and the
      value at attach time so a counter adopted mid-life doesn't
      credit its history to the first window.
    * ``"event"`` — samples are per-event values (histogram
      observations); :meth:`rate` is events/s in the window and
      :meth:`quantile`/:meth:`mean` summarize the in-window values.
    * ``"level"`` — samples are written levels (gauge sets);
      :meth:`mean`/:meth:`quantile` summarize, :meth:`rate` is the
      write rate (rarely interesting, but defined).
    """

    __slots__ = ("kind", "capacity", "_clock", "_buf", "_floor_t",
                 "_floor_v")

    def __init__(self, kind="event", capacity=DEFAULT_RING_CAPACITY,
                 clock=time.monotonic, baseline=0.0):
        if kind not in ("counter", "event", "level"):
            raise ValueError(f"unknown ring kind {kind!r}")
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.kind = kind
        self.capacity = int(capacity)
        self._clock = clock
        self._buf = collections.deque()
        # baseline: the cumulative value "before the oldest retained
        # sample" — starts at the metric's value when the ring
        # attached, advances as samples age out of the ring
        self._floor_t = clock()
        self._floor_v = float(baseline)

    def __len__(self):
        return len(self._buf)

    def append(self, value, t=None):
        if t is None:
            t = self._clock()
        if len(self._buf) >= self.capacity:
            ft, fv = self._buf.popleft()
            self._floor_t, self._floor_v = ft, fv
        self._buf.append((t, float(value)))

    def _tail(self, window, now):
        """In-window ``(t, v)`` pairs, oldest-first.  Scans newest ->
        oldest and stops at the first sample older than the cutoff;
        with a monotone clock this is exact, and a backwards clock can
        only hide samples OLDER than the break point (never corrupt
        the ring) — a sample stamped after ``now`` counts in-window.
        Reads snapshot the buffer first: the registry promises
        cross-thread use (writer threads append while a scrape or
        poll reads), and iterating a live deque under mutation
        raises."""
        cutoff = now - window
        buf = tuple(self._buf)
        out = []
        for t, v in reversed(buf):
            if t < cutoff:
                break
            out.append((t, v))
        out.reverse()
        return out

    def values(self, window, now=None) -> list:
        """In-window sample values, oldest-first."""
        if now is None:
            now = self._clock()
        return [v for _, v in self._tail(window, now)]

    def rate(self, window, now=None) -> float:
        """Per-second rate over the window.  Counter rings: value
        growth / window (0.0 when nothing changed — an idle counter
        has rate 0, not nan).  Event/level rings: samples / window."""
        if now is None:
            now = self._clock()
        window = float(window)
        if window <= 0:
            raise ValueError(f"window must be > 0, got {window}")
        if self.kind != "counter":
            return len(self._tail(window, now)) / window
        # one snapshot serves the whole computation (see _tail)
        buf = tuple(self._buf)
        if not buf:
            return 0.0
        latest = buf[-1][1]
        cutoff = now - window
        if buf[-1][0] >= cutoff:
            # baseline = cumulative value AT the window's start: the
            # last retained sample at/before the cutoff, else the
            # eviction/attach floor.  (A sample exactly ON the cutoff
            # is the baseline, so only growth strictly inside the
            # window counts — matching the in-window scan, which also
            # keeps the boundary sample as the reference point.)
            baseline = self._floor_v
            for t, v in buf:
                if t <= cutoff:
                    baseline = v
                else:
                    break
        else:
            baseline = latest  # no in-window growth
        # clamp: a counter reset (or a backwards clock interleaving
        # samples) must never export a negative rate
        return max(latest - baseline, 0.0) / window

    def mean(self, window, now=None) -> float:
        vals = self.values(window, now)
        return sum(vals) / len(vals) if vals else float("nan")

    def quantile(self, q, window, now=None) -> float:
        """Nearest-rank quantile (``q`` in [0, 1]) over the in-window
        samples; nan when the window is empty (same contract as
        ``LatencySeries``)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        return _percentile(self.values(window, now), q * 100.0)


class WindowedFamily:
    """Windowed views over every metric of one registry NAME.

    Built by ``MetricsRegistry.windowed(name, ...)`` — do not
    construct directly.  Holds one :class:`WindowRing` per label set
    (attached when the metric is, detached when the metric is removed)
    and aggregates reads across them: counter rates SUM (the fleet
    view), event samples MERGE before the quantile.  ``match``
    filters by a label subset (``match={"kind": "ttft"}``)."""

    def __init__(self, name, kind, windows=DEFAULT_WINDOWS,
                 capacity=DEFAULT_RING_CAPACITY, clock=time.monotonic):
        ws = tuple(float(w) for w in windows)
        if not ws or any(w <= 0 for w in ws):
            raise ValueError(
                f"windows must be non-empty positive seconds, got "
                f"{windows}")
        self.name = name
        # "counter" | "gauge" | "histogram" — None until the first
        # metric attaches (a family can be registered BEFORE its name
        # exists; the first attach resolves the arithmetic)
        self.kind = kind
        self.windows = ws
        self.capacity = int(capacity)
        self.clock = clock
        self.rings = {}  # label tuple (sorted (k, v) pairs) -> ring
        # label tuple -> the EXACT hook object registered on a
        # histogram's series: ``ring.append`` is a fresh bound-method
        # object on every attribute access, and remove_hook filters
        # by identity, so detach must present the same object
        self._series_hooks = {}

    # -- attachment (registry-driven) -----------------------------------
    def _attach(self, metric):
        """Create and wire a ring for ``metric`` (idempotent)."""
        if self.kind is None:
            self.kind = metric.KIND
        if metric.labels in self.rings:
            return self.rings[metric.labels]
        baseline = metric.value if self.kind == "counter" else 0.0
        ring = WindowRing(
            "event" if self.kind == "histogram" else
            ("counter" if self.kind == "counter" else "level"),
            capacity=self.capacity, clock=self.clock,
            baseline=baseline)
        self.rings[metric.labels] = ring
        if self.kind == "histogram":
            # adopters record into the series directly, so the series'
            # record hook is the one point that sees every value
            hook = ring.append
            self._series_hooks[metric.labels] = hook
            metric.series.add_hook(hook)
        else:
            # counters/gauges: every write appends the NEW value
            metric._rings = metric._rings + (ring,)
        return ring

    def _detach_metric(self, metric):
        """Unwire ``metric``'s ring (registry.remove / unwindow): the
        series hook or the metric's ring tuple, then the ring itself —
        a retired metric's windowed series must disappear, not freeze
        or keep consuming records."""
        ring = self.rings.pop(metric.labels, None)
        if ring is None:
            return
        hook = self._series_hooks.pop(metric.labels, None)
        if hook is not None:
            metric.series.remove_hook(hook)
        else:
            metric._rings = tuple(r for r in metric._rings
                                  if r is not ring)

    # -- reads ----------------------------------------------------------
    def _selected(self, match):
        # snapshot first: a concurrent scale-up attaches rings while
        # a scrape/poll reads (same discipline as export's copy)
        rings = dict(self.rings)
        if match is None:
            return list(rings.values())
        want = {(str(k), str(v)) for k, v in match.items()}
        return [r for labels, r in rings.items()
                if want <= set(labels)]

    def rate(self, window, now=None, match=None) -> float:
        """Summed per-second rate across the (matching) label sets."""
        if now is None:
            now = self.clock()
        return sum(r.rate(window, now) for r in self._selected(match))

    def values(self, window, now=None, match=None) -> list:
        if now is None:
            now = self.clock()
        out = []
        for r in self._selected(match):
            out.extend(r.values(window, now))
        return out

    def mean(self, window, now=None, match=None) -> float:
        vals = self.values(window, now, match)
        return sum(vals) / len(vals) if vals else float("nan")

    def quantile(self, q, window, now=None, match=None) -> float:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        return _percentile(self.values(window, now, match), q * 100.0)

    def section(self, now=None) -> dict:
        """JSON-able health view: per-window aggregates in the shape
        the window's arithmetic supports (counter: rate; histogram:
        rate + p50/p99/mean; gauge: mean)."""
        if now is None:
            now = self.clock()
        out = {"kind": self.kind, "series": len(self.rings),
               "windows": {}}
        for w in self.windows:
            key = _wlabel(w)
            if self.kind in ("counter", None):
                out["windows"][key] = {"rate": self.rate(w, now)}
            elif self.kind == "histogram":
                out["windows"][key] = {
                    "rate": self.rate(w, now),
                    "mean": self.mean(w, now),
                    "p50": self.quantile(0.5, w, now),
                    "p99": self.quantile(0.99, w, now),
                }
            else:
                out["windows"][key] = {"mean": self.mean(w, now)}
        return out


def _wlabel(window) -> str:
    """``60`` -> ``"60"``, ``2.5`` -> ``"2.5"`` — the window-second
    key used in sibling-gauge names and section dicts."""
    w = float(window)
    return str(int(w)) if w == int(w) else str(w)
