"""Training and latency metrics (counterpart of
``singa_tpu/utils/metrics.py``): a step timer that skips warm-up steps,
nearest-rank percentiles, the bounded
``LatencySeries`` the registry's histograms keep, and ``accuracy``."""

from __future__ import annotations

import collections
import math
import time

__all__ = ["StepTimer", "percentile",
           "DEFAULT_MAX_SAMPLES", "LatencySeries", "accuracy"]


class StepTimer:
    """Per-step wall time, the first ``skip_first`` steps (compiles,
    captures) left out of the steady figures.  Host clock: a caller
    timing device work synchronises before ``stop``."""

    def __init__(self, skip_first=2):
        self.skip_first = skip_first
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        assert self._t0 is not None
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *a):
        self.stop()

    @property
    def steady(self):
        return self.times[self.skip_first:] or self.times

    def mean_step_seconds(self) -> float:
        s = self.steady
        return sum(s) / len(s) if s else float("nan")

    def samples_per_sec(self, batch_size) -> float:
        """nan when no step was recorded or the mean is zero."""
        m = self.mean_step_seconds()
        if m != m or m == 0.0:
            return float("nan")
        return batch_size / m

    def samples_per_sec_per_chip(self, batch_size, num_chips=1) -> float:
        return self.samples_per_sec(batch_size) / num_chips


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


#: default bound on the samples a series keeps
DEFAULT_MAX_SAMPLES = 8192


class LatencySeries:
    """Per-event latencies (seconds).  The newest ``max_samples`` are
    kept in a ring for the mean, percentiles and max; ``count`` and
    ``total_sum`` stay exact over every value recorded.  ``add_hook``
    registers ``fn(value)`` called on every later ``record``."""

    def __init__(self, max_samples=DEFAULT_MAX_SAMPLES):
        if max_samples is not None and max_samples < 1:
            raise ValueError(
                f"max_samples must be >= 1 or None, got {max_samples}")
        self.max_samples = max_samples
        self.values = collections.deque(maxlen=max_samples)
        self.total_sum = 0.0
        self._total_count = 0
        self._hooks = ()

    def add_hook(self, fn):
        self._hooks = self._hooks + (fn,)

    def remove_hook(self, fn):
        self._hooks = tuple(h for h in self._hooks if h is not fn)

    def record(self, seconds: float):
        v = float(seconds)
        self.values.append(v)
        self.total_sum += v
        self._total_count += 1
        for h in self._hooks:
            h(v)

    @property
    def count(self) -> int:
        return self._total_count

    def mean(self) -> float:
        return (sum(self.values) / len(self.values)
                if self.values else float("nan"))

    def percentile(self, p) -> float:
        return percentile(self.values, p)

    def summary(self) -> dict:
        """``count`` (all-time), and the mean, p50, p99 and max of the
        kept ring."""
        return {
            "count": self.count,
            "mean": self.mean(),
            "p50": self.percentile(50),
            "p99": self.percentile(99),
            "max": (max(self.values) if self.values else float("nan")),
        }


def accuracy(logits, labels):
    """Share of rows whose argmax equals the label; tensors or arrays."""
    import numpy as np

    from .. import tensor

    p = logits if isinstance(logits, np.ndarray) else tensor.to_numpy(logits)
    t = labels if isinstance(labels, np.ndarray) else tensor.to_numpy(labels)
    return float((p.argmax(-1) == t).mean())
