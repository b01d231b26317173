"""The port's host-only helpers against the JAX package's: the fault
policies and retry of ``singa_tpu_torch/resilience`` (``singa_tpu/
resilience/{faults,retry}.py``) and ``utils/{timer,metrics}.py``.

Each case runs the same scripted inputs (a numpy seed, a scripted clock
for ``time.perf_counter``, ``time.sleep`` recorded instead of slept)
through both packages and compares what comes out exactly: these are
host computations on Python floats, so they agree to the bit.
"""

import time

import numpy as np
import pytest

from singa_tpu import tensor as jtensor
from singa_tpu.resilience import faults as jfaults
from singa_tpu.resilience import retry as jretry
from singa_tpu.utils import metrics as jmetrics
from singa_tpu.utils import timer as jtimer
from singa_tpu_torch import device, tensor
from singa_tpu_torch.resilience import faults, retry
from singa_tpu_torch.utils import metrics, timer

PACKAGES = {"jax": (jfaults, jretry, jmetrics, jtimer),
            "port": (faults, retry, metrics, timer)}


@pytest.fixture
def clock(monkeypatch):
    """``time.perf_counter`` reads a scripted sequence: 10.0, then each
    reading a seeded step later; ``time.sleep`` records its argument."""
    state = {"t": 10.0, "rng": np.random.RandomState(0), "slept": []}

    def reset():
        state["t"] = 10.0
        state["rng"] = np.random.RandomState(0)
        state["slept"] = []

    def perf_counter():
        state["t"] += float(state["rng"].uniform(0.001, 0.5))
        return state["t"]

    monkeypatch.setattr(time, "perf_counter", perf_counter)
    monkeypatch.setattr(time, "sleep", state["slept"].append)
    state["reset"] = reset
    return state


@pytest.mark.parametrize("values,p", [
    ([], 50), ([3.0], 99), ([5.0, 1.0, 3.0], 0), ([5.0, 1.0, 3.0], 50),
    ([5.0, 1.0, 3.0], 99), (list(np.random.RandomState(1).rand(101)), 90),
    (list(range(10)), 100), (list(range(10)), 150),
])
def test_percentile_matches_jax(values, p):
    a, b = metrics.percentile(values, p), jmetrics.percentile(values, p)
    assert a == b or (a != a and b != b)


@pytest.mark.parametrize("max_samples", [None, 1, 16, 8192])
def test_latency_series_matches_jax(max_samples):
    """The ring, the exact all-time totals, the summary and the hooks."""
    vals = np.random.RandomState(2).exponential(0.01, 50).tolist()
    out = {}
    for name, (_, _, m, _) in PACKAGES.items():
        s = m.LatencySeries(max_samples)
        seen = []
        s.add_hook(seen.append)
        for v in vals[:30]:
            s.record(v)
        s.remove_hook(seen.append)
        for v in vals[30:]:
            s.record(v)
        out[name] = (s.summary(), s.total_sum, list(s.values), seen,
                     s.percentile(75))
    assert out["port"] == out["jax"]


def test_latency_series_refuses_an_empty_ring():
    for m in (metrics, jmetrics):
        with pytest.raises(ValueError):
            m.LatencySeries(0)


@pytest.mark.parametrize("skip_first,steps", [(0, 3), (2, 6), (5, 3)])
def test_step_timer_matches_jax(clock, skip_first, steps):
    """Steps timed on the scripted clock (``skip_first`` past the steps
    recorded: every step counts)."""
    out = {}
    for name, (_, _, m, _) in PACKAGES.items():
        clock["reset"]()
        t = m.StepTimer(skip_first=skip_first)
        for _ in range(steps):
            with t:
                pass
        out[name] = (t.times, t.steady, t.mean_step_seconds(),
                     t.samples_per_sec(32), t.samples_per_sec_per_chip(32, 4))
    assert out["port"] == out["jax"]


def test_step_timer_without_steps_gives_nan():
    for m in (metrics, jmetrics):
        t = m.StepTimer()
        assert t.mean_step_seconds() != t.mean_step_seconds()
        assert t.samples_per_sec(8) != t.samples_per_sec(8)


def test_timer_matches_jax(clock):
    """``seconds`` None until a block exits, then that block's time;
    ``elapsed`` live; ``reset`` restarts."""
    out = {}
    for name, (_, _, _, tm) in PACKAGES.items():
        clock["reset"]()
        t = tm.Timer()
        seen = [t.seconds, t.elapsed()]
        with t:
            seen.append(t.seconds)
        seen += [t.seconds, t.elapsed()]
        t.reset()
        seen.append(t.elapsed())
        out[name] = seen
    assert out["port"] == out["jax"]
    assert out["port"][0] is None and out["port"][2] is None


@pytest.mark.parametrize("as_tensor", [False, True])
def test_accuracy_matches_jax(as_tensor):
    rng = np.random.RandomState(3)
    logits = rng.randn(40, 5).astype(np.float32)
    labels = rng.randint(0, 5, 40).astype(np.int32)
    if as_tensor:
        cpu = device.create_cpu_device()
        got = metrics.accuracy(tensor.from_numpy(logits, cpu),
                               tensor.from_numpy(labels, cpu))
        want = jmetrics.accuracy(jtensor.from_numpy(logits),
                                 jtensor.from_numpy(labels))
    else:
        got = metrics.accuracy(logits, labels)
        want = jmetrics.accuracy(logits, labels)
    assert got == want
    assert got == float((logits.argmax(-1) == labels).mean())


POLICIES = {
    "fail_once": lambda f: f.FailOnce(),
    "fail_once_fatal": lambda f: f.FailOnce(transient=False),
    "fail_rate": lambda f: f.FailRate(0.3, seed=7),
    "fail_after_n": lambda f: f.FailAfterN(3, times=2),
    "latency": lambda f: f.Latency(0.25),
    "fail_once_slow": lambda f: f.FailOnce(latency_s=0.5),
    "fail_once_custom_error": lambda f: f.FailOnce(error=KeyError("x")),
}


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_fault_policy_fires_as_jax(clock, policy):
    """Twelve calls of ``check`` at an armed site: which raise, what
    (type name, transient), the sleeps, ``calls`` and ``fired``; the site
    disarmed afterwards."""
    out = {}
    for name, (f, _, _, _) in PACKAGES.items():
        clock["reset"]()
        seen = []
        with f.injected("checkpoint.write", POLICIES[policy](f)) as pol:
            assert f.armed()
            for _ in range(12):
                try:
                    f.check("checkpoint.write")
                    seen.append(None)
                except Exception as e:  # noqa: BLE001 - compared by kind
                    seen.append((type(e).__name__,
                                 getattr(e, "transient", None)))
                f.check("checkpoint.read")  # not armed: passes
        assert not f.armed()
        f.check("checkpoint.write")
        out[name] = (seen, list(clock["slept"]), pol.calls, pol.fired)
    assert out["port"] == out["jax"]


def test_fail_rate_refuses_a_rate_outside_0_1():
    for f in (faults, jfaults):
        with pytest.raises(ValueError):
            f.FailRate(1.5)


@pytest.mark.parametrize("script,attempts", [
    (["ok"], 4), (["os", "ok"], 4), (["fault", "os", "ok"], 3),
    (["os", "os", "os"], 3), (["timeout", "fatal_fault"], 4),
    (["value"], 4), (["os", "value"], 4), ([], 1),
])
def test_retry_call_matches_jax(script, attempts):
    """``fn`` fails per ``script`` (an error a call, then returns):
    the result or the error's kind, the backoff delays (seeded jitter),
    and how many calls were made."""
    out = {}
    for name, (f, r, _, _) in PACKAGES.items():
        errors = {"os": lambda: OSError("disk"),
                  "timeout": lambda: TimeoutError("slow"),
                  "value": lambda: ValueError("bad"),
                  "fault": lambda: f.FaultInjected("s"),
                  "fatal_fault": lambda: f.FaultInjected("s",
                                                         transient=False)}
        calls, slept = [], []

        def fn():
            calls.append(1)
            k = len(calls) - 1
            if k < len(script) and script[k] != "ok":
                raise errors[script[k]]()
            return "done"

        try:
            res = r.retry_call(fn, "checkpoint.write",
                               policy=r.RetryPolicy(max_attempts=attempts,
                                                    seed=5),
                               sleep=slept.append)
        except r.RetryBudgetExceededError as e:
            res = ("gave_up", e.attempts, type(e.last_error).__name__,
                   type(e.__cause__).__name__)
        except Exception as e:  # noqa: BLE001 - compared by kind
            res = ("raised", type(e).__name__)
        out[name] = (res, slept, len(calls))
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("kind", ["os", "file_not_found", "timeout", "value",
                                  "runtime", "fault", "fatal_fault",
                                  "extra"])
def test_is_transient_matches_jax(kind):
    got = {}
    for name, (f, r, _, _) in PACKAGES.items():
        exc = {"os": OSError(), "file_not_found": FileNotFoundError(),
               "timeout": TimeoutError(), "value": ValueError(),
               "runtime": RuntimeError(), "fault": f.FaultInjected("s"),
               "fatal_fault": f.FaultInjected("s", transient=False),
               "extra": KeyError()}[kind]
        extra = (KeyError,) if kind == "extra" else ()
        got[name] = r.is_transient(exc, extra)
    assert got["port"] == got["jax"]


def test_retry_policy_delays_match_jax():
    import random

    for attempt in range(8):
        pj, pp = jretry.RetryPolicy(seed=3), retry.RetryPolicy(seed=3)
        assert pp.delay(attempt, random.Random(1)) == \
            pj.delay(attempt, random.Random(1))
