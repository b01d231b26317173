"""Active monitoring over the passive ``observe`` layer: flight
recorder, crash bundles, MFU/goodput accounting, and a hang/anomaly
watchdog.

``trace``/``registry``/``export`` record; nothing there
*interprets* the stream, survives a crash, or says whether the process
is healthy.  This module adds the four pieces every production
training/serving stack grows:

* **flight recorder** — a bounded ring of the most recent span/instant
  records, fed by the same ``trace`` instrumentation sites but
  INDEPENDENT of ``trace.enable()`` (the ring attaches via
  ``trace._attach_ring``; the main buffer stays empty unless tracing
  is on).  Cheap enough to leave on for a whole run, so a crash always
  has the last N events on hand.
* **crash bundles** — :func:`dump_report` writes a single JSON file
  with the recent events, a full registry snapshot, the captured
  steps' FLOP counts, and process/host info; :func:`install_crash_handler`
  wires it to ``sys.excepthook`` and SIGTERM/SIGINT so an OOM-killed or
  preempted run leaves forensics behind.
* **MFU / goodput** — :class:`MfuMeter` turns the per-step FLOPs the
  graph runner counts on a signature's first, eager call while the
  monitor runs (``model._compiled_cost_tables``: aten's matrix products
  through ``torch.utils.flop_counter.FlopCounterMode``, plus the
  hand-written kernels' own counts, which ``count_kernel_flops`` adds
  from their shapes since a ctypes launch is no aten op) times the
  observed ``train.steps`` rate into
  ``train.model_flops_per_s``, and divides by a per-device peak-FLOPs
  table into ``train.mfu``.  Unknown devices (CPU included) publish
  an honest ``nan``, never 0: a fake denominator is worse than none.
* **watchdog** — a background thread fed by :func:`heartbeat` calls
  from ``_GraphRunner.run`` and the serve decode loop.  A missed
  heartbeat emits a ``monitor/hang`` event carrying every thread's
  stack (``sys._current_frames``) and dumps a crash bundle; an EWMA
  z-score over step times increments ``<source>.step_time_anomalies``
  and attaches a trace instant; each host feeds a
  ``{process=<rank>}``-labeled step-time histogram so a multi-process
  health report can name the straggler.  The clock is injectable and
  ``check()`` is callable without the thread, so every firing rule is
  deterministic in tests.

Everything is off until :func:`start`; a stopped monitor costs the
instrumented sites one ``is None`` check per step.  The one-call
summary over all of it is :func:`observe.health_report()
<singa_tpu_torch.observe.health.health_report>` (observe/health.py).

The port's own copy of ``singa_tpu/observe/monitor.py`` (it imports
nothing of the JAX package); the wire formats are the same.
"""

from __future__ import annotations

import json
import math
import os
import signal
import sys
import threading
import time
import traceback
from collections import deque

from . import stepprof as _stepprof
from . import trace as _trace
from .registry import SCHEMA_ROOT, registry as _registry

__all__ = ["FlightRecorder", "flight_recorder", "dump_report",
           "install_crash_handler", "uninstall_crash_handler",
           "peak_flops", "step_flops", "MfuMeter", "Watchdog",
           "heartbeat", "start", "stop", "active", "watchdog",
           "crash_dir"]


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

class FlightRecorder:
    """Bounded ring of the most recent trace records, independent of
    ``trace.enable()``.  While started, every ``span()``/``event()``
    emission lands here too (deque append, GIL-atomic); the ring
    forgets beyond ``capacity``, so a forgotten recorder cannot OOM —
    it holds exactly the tail a post-mortem wants."""

    def __init__(self, capacity=2048):
        self.capacity = int(capacity)
        self._ring = deque(maxlen=self.capacity)
        self._started = False

    @property
    def active(self) -> bool:
        return self._started

    def start(self, capacity=None):
        if capacity is not None and int(capacity) != self.capacity:
            self.capacity = int(capacity)
            self._ring = deque(self._ring, maxlen=self.capacity)
        _trace._attach_ring(self._ring)
        self._started = True
        return self

    def stop(self):
        self._started = False
        _trace._attach_ring(None)

    def clear(self):
        self._ring.clear()

    def events(self) -> list:
        """Snapshot copy of the ring, oldest first."""
        return list(self._ring)

    def __len__(self):
        return len(self._ring)


_recorder = FlightRecorder()


def flight_recorder() -> FlightRecorder:
    """The process-wide flight recorder (started by :func:`start` or
    explicitly via ``flight_recorder().start()``)."""
    return _recorder


# ---------------------------------------------------------------------------
# crash bundles
# ---------------------------------------------------------------------------

def crash_dir() -> str:
    """Where crash bundles land: $SINGA_TPU_CRASH_DIR, else the system
    temp dir."""
    import tempfile

    return os.environ.get("SINGA_TPU_CRASH_DIR", tempfile.gettempdir())


def _process_info() -> dict:
    from ..parallel.communicator import process_info

    info = {
        "pid": os.getpid(),
        "argv": list(sys.argv),
        "python": sys.version.split()[0],
        "platform": sys.platform,
        "time_unix": time.time(),
    }
    try:
        info["hostname"] = __import__("socket").gethostname()
    except Exception:
        pass
    info.update(process_info())
    return info


def _process_rank() -> str:
    """This process's rank (``parallel.communicator.process_info``: its
    ``torch.distributed`` rank once a process group is up, else 0)."""
    from ..parallel.communicator import process_info

    return str(process_info()["process_index"])


#: extra cost-table providers: zero-arg callables returning
#: [{"key": str, "cost": {scalars}}] entries for crash bundles
_extra_cost_sources = []

#: the running FLOP tally of a step being counted (a one-item list), or
#: None.  The graph runner sets it around a signature's first, eager
#: call under ``FlopCounterMode``; a wrapper that launches a
#: hand-written kernel adds that launch's FLOPs through
#: :func:`count_kernel_flops`, since the mode sees aten ops only.
_flop_tally = None


def count_kernel_flops(n):
    """Credit ``n`` FLOPs of one hand-written kernel launch to the step
    being counted; one ``is None`` check otherwise.  Only launches the
    counter cannot see call this (a CPU tensor's plain version is aten
    ops, which the counter counts itself)."""
    t = _flop_tally
    if t is not None:
        t[0] += n


def register_cost_source(provider):
    """Register a zero-arg callable contributing cost-table entries to
    :func:`dump_report` bundles (and to :func:`step_flops`) beside the
    graph runners' tables."""
    if provider not in _extra_cost_sources:
        _extra_cost_sources.append(provider)


def _cost_tables() -> list:
    """Every graph runner's counted steps (``{"flops": ...}`` a
    signature), plus any registered extra sources' entries."""
    out = []
    try:
        from ..model import _compiled_cost_tables, _cost_args
    except Exception:
        pass
    else:
        for key, cost in _compiled_cost_tables():
            out.append({"key": key, "cost": _cost_args(cost)})
    for provider in _extra_cost_sources:
        try:
            out.extend(provider())
        except Exception:
            pass  # a broken telemetry source must not break bundles
    return out


def _thread_stacks() -> dict:
    """All-thread stacks keyed by thread name — the hang forensic."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for tid, frame in sys._current_frames().items():
        name = names.get(tid, str(tid))
        out[name] = "".join(traceback.format_stack(frame))
    return out


def dump_report(path=None, reason=None, extra=None) -> str:
    """Write a crash/health bundle and return its path: the flight
    recorder's recent events, the full registry snapshot, the counted
    steps' FLOPs, config/env, and process/host info — one
    self-contained, ``json.loads``-able post-mortem file."""
    if path is None:
        path = os.path.join(
            crash_dir(),
            f"monitor-crash-{os.getpid()}-{int(time.time() * 1000)}.json")
    wd = _watchdog
    report = {
        "schema": f"{SCHEMA_ROOT}.crash/1",
        "reason": reason,
        "host": _process_info(),
        "config": {k: v for k, v in os.environ.items()
                   if k.startswith(("SINGA", "TORCH", "CUDA", "BENCH"))},
        "recent_events": _recorder.events(),
        "trace_dropped": _trace.dropped(),
        "registry": _registry().snapshot(),
        "cost_tables": _cost_tables(),
        "watchdog": wd.summary() if wd is not None else None,
    }
    if extra:
        report.update(extra)
    from .export import json_sanitize

    with open(path, "w") as f:
        # default=str: recent events carry numpy/torch scalars in args;
        # a crash bundle must never be lost at dump time over a dtype.
        # json_sanitize: nan/inf floats become null so the bundle is
        # STRICT JSON, readable by any tooling, not just Python
        json.dump(json_sanitize(report), f, default=str)
    return path


_prev_excepthook = None
_prev_signal = {}
_signal_dumped = set()  # signums whose handler already wrote a bundle


def install_crash_handler(dir=None, signals=(signal.SIGTERM,
                                             signal.SIGINT)):
    """Wire :func:`dump_report` to ``sys.excepthook`` and the given
    signals, and start the flight recorder if it isn't running (a
    crash handler without a ring would dump an empty tail).  The
    previous excepthook/handlers are chained, not replaced; idempotent.
    Signal handlers are skipped off the main thread (CPython rule)."""
    global _prev_excepthook
    if dir is not None:
        os.environ["SINGA_TPU_CRASH_DIR"] = dir
    if not _recorder.active:
        _recorder.start()
    if _prev_excepthook is None:
        prev = sys.excepthook

        def hook(exc_type, exc, tb):
            # Ctrl-C with our SIGINT handler installed already wrote a
            # signal:2 bundle before default_int_handler raised this
            # KeyboardInterrupt — one incident, one bundle
            dup = (issubclass(exc_type, KeyboardInterrupt)
                   and signal.SIGINT in _signal_dumped)
            if not dup:
                try:
                    dump_report(
                        reason=f"uncaught:{exc_type.__name__}: {exc}",
                        extra={"traceback": "".join(
                            traceback.format_exception(exc_type, exc,
                                                       tb))})
                except Exception:
                    pass  # the original exception must still surface
            prev(exc_type, exc, tb)

        _prev_excepthook = prev
        sys.excepthook = hook
    for sig in signals:
        if sig in _prev_signal:
            continue
        try:
            old = signal.getsignal(sig)

            def handler(signum, frame, _old=old):
                try:
                    dump_report(reason=f"signal:{signum}")
                    _signal_dumped.add(signum)
                except Exception:
                    pass
                if _old is signal.SIG_IGN:
                    # the signal was a deliberate no-op before us
                    # (shell background jobs ignore SIGINT, shielding
                    # supervisors ignore SIGTERM) — dump forensics but
                    # do NOT turn an ignored signal into a fatal one
                    return
                if callable(_old):
                    _old(signum, frame)
                else:
                    # restore the default disposition and re-raise so
                    # the process dies with the right signal status
                    signal.signal(signum, signal.SIG_DFL)
                    os.kill(os.getpid(), signum)

            signal.signal(sig, handler)
            _prev_signal[sig] = old
        except ValueError:
            pass  # not the main thread


def uninstall_crash_handler():
    """Restore the previous excepthook/signal handlers (tests)."""
    global _prev_excepthook
    if _prev_excepthook is not None:
        sys.excepthook = _prev_excepthook
        _prev_excepthook = None
    for sig, old in list(_prev_signal.items()):
        try:
            signal.signal(sig, old)
        except ValueError:
            pass
        del _prev_signal[sig]
    _signal_dumped.clear()


# ---------------------------------------------------------------------------
# MFU accounting
# ---------------------------------------------------------------------------

# dense bf16 peak matmul FLOP/s per device, by device-name substring
# (first match wins — list "h100 pcie" before the bare "h100", "v5p"/
# "v5e" before the bare "v5").  H100: NVIDIA's data sheet, dense (no
# sparsity), SXM 989 TFLOP/s, PCIe 756.  The JAX package's TPU rows are
# kept so a name from either table reads the same.  float32 work and
# int8/fp8 paths make the ratio conservative/optimistic respectively;
# unknown kinds (the CPU, other GPUs) get nan, never a guess.
_PEAK_FLOPS = [
    ("h100 pcie", 756e12), ("h100", 989e12),
    ("v5 lite", 197e12), ("v5litepod", 197e12), ("v5e", 197e12),
    ("v5p", 459e12), ("v5", 459e12),
    ("v4", 275e12), ("v6", 918e12),
]


def peak_flops(device_kind=None) -> float:
    """Per-device bf16 peak for a ``device_kind`` string (default:
    ``torch.cuda.get_device_name(0)``, nan without a GPU); nan when
    unknown — the MFU of an unmodeled device is unknowable, not
    zero."""
    if device_kind is None:
        try:
            import torch

            if not torch.cuda.is_available():
                return float("nan")
            device_kind = torch.cuda.get_device_name(0)
        except Exception:
            return float("nan")
    kind = str(device_kind).lower()
    for sub, peak in _PEAK_FLOPS:
        if sub in kind:
            return peak
    return float("nan")


def step_flops() -> float:
    """FLOPs of one captured training step, as the graph runner counted
    its signature's first, eager call while the monitor ran; the
    LARGEST count wins (eval/probe signatures ride the same cache).
    nan when no step was counted."""
    best = float("nan")
    for entry in _cost_tables():
        f = entry["cost"].get("flops")
        if f and not (best == best and best >= f):  # best is nan or < f
            best = float(f)
    return best


class MfuMeter:
    """Publishes ``train.model_flops_per_s`` and ``train.mfu`` gauges
    from the ``train.steps`` counter rate × per-step FLOPs ÷ the
    device's peak.  ``sample()`` is rate-over-interval: call it
    periodically (the watchdog thread does) or once at report time.
    Both gauges hold nan until the first samplable interval — and stay
    nan on backends with no cost table or no peak entry."""

    #: intervals shorter than this neither reset the window nor
    #: republish: a report landing right after a watchdog-thread
    #: sample would otherwise see 0 steps over ~0 seconds and publish
    #: a misleading 0 for a process that just trained at high
    #: utilization
    MIN_INTERVAL_S = 0.5

    def __init__(self, reg=None, clock=time.monotonic):
        reg = reg if reg is not None else _registry()
        self._reg = reg
        self._clock = clock
        self._g_flops = reg.gauge(
            "train.model_flops_per_s",
            help="counted step flops x observed train.steps rate")
        self._g_mfu = reg.gauge(
            "train.mfu",
            help="model_flops_per_s / per-chip bf16 peak (nan when "
                 "peak or cost table unknown)")
        self._g_flops.set(float("nan"))
        self._g_mfu.set(float("nan"))
        self._last = (clock(), self._steps())
        self.last = None  # most recent published sample dict

    def _steps(self) -> int:
        return self._reg.counter("train.steps").value

    def sample(self) -> dict:
        """One accounting interval; returns (and publishes) the rates
        since the previous ``sample()``/construction.  Back-to-back
        calls inside ``MIN_INTERVAL_S`` return the previous sample
        unchanged instead of resetting the window."""
        now, steps = self._clock(), self._steps()
        t0, s0 = self._last
        dt = now - t0
        if dt < self.MIN_INTERVAL_S:
            if self.last is not None:
                return self.last
            # no samplable interval yet either: report nan WITHOUT
            # publishing or resetting — steps-s0==0 over a ~0s window
            # would otherwise publish mfu=0 for a process that may be
            # training flat-out (the misleading zero this class's
            # contract forbids)
            nan = float("nan")
            return {"steps_per_s": nan, "step_flops": step_flops(),
                    "model_flops_per_s": nan,
                    "peak_flops_per_s": peak_flops(), "mfu": nan}
        self._last = (now, steps)
        rate = (steps - s0) / dt if dt > 0 else float("nan")
        f = step_flops()
        # a ZERO-step interval (a process serving, checkpointing, or
        # between phases) publishes nan, not a hard 0.0: a busy
        # process must never read as 0 flops/s, and model_flops_per_s
        # and mfu must go honest-nan TOGETHER — unknown-peak backends
        # used to report flops 0.0 next to mfu null, an inconsistent
        # pair (the committed BENCH_SERVE health.train bug)
        model_fps = (f * rate if steps != s0
                     else float("nan"))  # nan propagates from f/rate
        peak = peak_flops()
        mfu = model_fps / peak  # nan when peak unknown (CPU)
        self._g_flops.set(model_fps)
        self._g_mfu.set(mfu)
        self.last = {"steps_per_s": rate, "step_flops": f,
                     "model_flops_per_s": model_fps,
                     "peak_flops_per_s": peak, "mfu": mfu}
        return self.last

    def read(self) -> dict:
        """Most recent published sample WITHOUT mutating the sampling
        window — what reports should call: ``health_report()`` racing
        the watchdog poll thread must not shrink its interval to ~0
        and overwrite a real rate with 0."""
        return self.last if self.last is not None else self.sample()


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------

class _SourceState:
    __slots__ = ("last_beat", "beats", "hang_fired", "armed",
                 "ewma_mean", "ewma_var", "n_samples", "hist", "anom")

    def __init__(self, now):
        self.last_beat = now
        self.beats = 0
        self.hang_fired = False
        self.armed = True
        self.ewma_mean = 0.0
        self.ewma_var = 0.0
        self.n_samples = 0
        self.hist = None
        self.anom = None


class Watchdog:
    """Hang + step-time-anomaly detector over :func:`heartbeat`\\ s.

    * **hangs** — an ARMED source that beat at least once and then
      stays silent past ``timeout_s`` fires exactly ONCE (latched
      until the next beat): ``monitor.hangs{source=}`` counter, a
      ``monitor/hang`` instant carrying all-thread stacks, and a
      flight-recorder crash bundle.  Repeated ``check()``\\ s do not
      re-fire — a wedged step is one incident, not one per poll.
      A beat with ``busy=False`` DISARMS the source (idle is not
      hung): the serve engine disarms when it drains, so a healthy
      traffic lull never fires.  Train stays armed between dispatches
      — size ``timeout_s`` above legitimate gaps (eval, checkpoint).
    * **step-time anomalies** — each beat's ``step_time`` is z-scored
      against an EWMA mean/variance (checked BEFORE the sample updates
      the estimate, after ``warmup`` samples); beyond ``z_threshold``
      it increments ``<source>.step_time_anomalies`` and attaches a
      trace instant.  Fresh-compile dispatches are beat-only: a
      compile is minutes against milliseconds and would poison the
      estimator (and the straggler histogram) for the rest of the run.
    * **straggler attribution** — step times feed a
      ``<source>.step_time{process=<torch.distributed rank>}``
      histogram;
      in multi-process runs every host publishes its own summary, so
      the health report can name the slow one.

    ``clock`` is injectable and ``check()`` needs no thread — tests
    drive every rule deterministically; ``start()`` runs ``check()``
    (plus an MFU sample) every ``poll_interval_s`` on a daemon
    thread."""

    def __init__(self, timeout_s=300.0, poll_interval_s=5.0, clock=None,
                 reg=None, z_threshold=6.0, warmup=8, ewma_alpha=0.2,
                 dump_on_hang=True, mfu=None):
        self.timeout_s = float(timeout_s)
        self.poll_interval_s = float(poll_interval_s)
        self._clock = clock if clock is not None else time.monotonic
        self._reg = reg if reg is not None else _registry()
        self.z_threshold = float(z_threshold)
        self.warmup = int(warmup)
        self.alpha = float(ewma_alpha)
        self.dump_on_hang = dump_on_hang
        self.mfu = mfu
        self._sources = {}
        self._lock = threading.Lock()
        self._thread = None
        self._stop = threading.Event()
        self.last_dump = None
        self._process = _process_rank()
        self._hang_total = 0  # across sources (registry counters are
        #                       per source label)

    # -- feeding ---------------------------------------------------------
    def beat(self, source, step_time=None, steps=1, fresh_compile=False,
             busy=True):
        """``busy=False`` marks the source idle-by-choice: liveness is
        refreshed but hang detection is DISARMED until the next busy
        beat — a drained serve engine is not a wedged one."""
        st = self._sources.get(source)
        if st is None:
            with self._lock:
                st = self._sources.setdefault(
                    source, _SourceState(self._clock()))
                if st.hist is None:
                    st.hist = self._reg.histogram(
                        f"{source}.step_time",
                        help="per-dispatch step seconds",
                        process=self._process)
                    st.anom = self._reg.counter(
                        f"{source}.step_time_anomalies",
                        help="EWMA z-score outliers", process=self._process)
        st.last_beat = self._clock()
        st.beats += steps
        st.hang_fired = False
        st.armed = busy
        if step_time is None or fresh_compile:
            return
        dt = step_time / max(steps, 1)
        if st.n_samples >= self.warmup and st.ewma_var > 0:
            z = (dt - st.ewma_mean) / math.sqrt(st.ewma_var)
            if z > self.z_threshold:
                st.anom.inc()
                extra = {}
                if _stepprof._active:
                    # the step profiler names the CULPRIT lane for
                    # this source's anomaly — host-bound (scheduling
                    # bubble) vs device-bound (model got slower) —
                    # from its most recent sealed step, so the alert
                    # carries the answer, not just the symptom
                    verdict = _stepprof.culprit(source)
                    if verdict is not None:
                        extra = verdict
                _trace.event(
                    "monitor/step_time_anomaly", cat="monitor",
                    source=source, step_time=dt, z=round(z, 2),
                    ewma_mean=st.ewma_mean, **extra)
        a = self.alpha
        if st.n_samples == 0:
            st.ewma_mean = dt
        else:
            d = dt - st.ewma_mean
            st.ewma_mean += a * d
            st.ewma_var = (1 - a) * (st.ewma_var + a * d * d)
        st.n_samples += 1
        st.hist.observe(dt)

    # -- checking --------------------------------------------------------
    def check(self) -> list:
        """One watchdog pass; returns the sources that newly hung."""
        now = self._clock()
        fired = []
        for source, st in list(self._sources.items()):
            if (not st.armed or st.hang_fired
                    or now - st.last_beat <= self.timeout_s):
                continue
            st.hang_fired = True
            fired.append(source)
            self._hang_total += 1
            self._reg.counter(
                "monitor.hangs", help="missed-heartbeat incidents",
                source=source).inc()
            stacks = _thread_stacks()
            _trace.event("monitor/hang", cat="monitor", source=source,
                         silent_s=now - st.last_beat,
                         threads=list(stacks))
            if self.dump_on_hang:
                try:
                    self.last_dump = dump_report(
                        reason=f"hang:{source}",
                        extra={"thread_stacks": stacks})
                except Exception:
                    pass
        return fired

    @property
    def hangs(self) -> int:
        return self._hang_total

    def hang_latched(self, source) -> bool:
        """True when ``source``'s heartbeat latched a hang.  The fleet
        probes every replica per step — this is the one-field read
        that keeps that probe off :meth:`summary`'s full dict build
        (clock reads + EWMA/anomaly fields for EVERY source in the
        process)."""
        st = self._sources.get(source)
        return st is not None and st.hang_fired

    def summary(self) -> dict:
        now = self._clock()
        return {
            "timeout_s": self.timeout_s,
            "hangs": self.hangs,
            "last_dump": self.last_dump,
            "sources": {
                s: {"beats": st.beats,
                    "last_heartbeat_age_s": now - st.last_beat,
                    "step_time_ewma_s": st.ewma_mean,
                    "anomalies": st.anom.value if st.anom else 0,
                    "armed": st.armed,
                    "hang_latched": st.hang_fired}
                for s, st in self._sources.items()},
        }

    def forget(self, source):
        """Drop a retired source's state and unregister its step-time
        metrics (the serve engine calls this at ``close()`` — without
        it every per-engine heartbeat source would pin its histogram's
        value list for process lifetime, the same leak
        ``EngineStats.unregister`` exists to prevent)."""
        st = self._sources.pop(source, None)
        if st is not None and st.hist is not None:
            self._reg.remove(st.hist, st.anom)

    # -- thread ----------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.poll_interval_s):
                try:
                    self.check()
                    if self.mfu is not None:
                        self.mfu.sample()
                except Exception:
                    pass  # the watchdog must never kill the run

        self._thread = threading.Thread(
            target=loop, name="singa-tpu-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.poll_interval_s + 1)
            self._thread = None


# ---------------------------------------------------------------------------
# module-level lifecycle (what the benches and instrumented sites use)
# ---------------------------------------------------------------------------

_watchdog = None
_mfu = None


def active() -> bool:
    """True when :func:`start` has run — the instrumented hot paths
    gate their two extra clock calls on this."""
    return _watchdog is not None


def watchdog() -> Watchdog | None:
    return _watchdog


def mfu_meter() -> MfuMeter | None:
    return _mfu


def heartbeat(source, step_time=None, steps=1, fresh_compile=False,
              busy=True):
    """Liveness + step-time feed from the hot loops (graph runner,
    serve decode).  No-op (one ``is None`` check) until ``start()``.
    ``busy=False`` disarms hang detection for the source (idle, not
    hung) until its next busy beat."""
    wd = _watchdog
    if wd is None:
        return
    wd.beat(source, step_time=step_time, steps=steps,
            fresh_compile=fresh_compile, busy=busy)


def forget(source):
    """Drop a retired heartbeat source (see ``Watchdog.forget``)."""
    wd = _watchdog
    if wd is not None:
        wd.forget(source)


def start(watchdog_timeout_s=300.0, poll_interval_s=5.0,
          recorder_capacity=2048, clock=None, reg=None, thread=True,
          crash_handler=False, **watchdog_kw) -> Watchdog:
    """Turn monitoring on: flight recorder attached, MFU meter
    registered, watchdog created (threaded unless ``thread=False`` —
    tests drive ``check()`` by hand with an injected ``clock``).
    Idempotent while running."""
    global _watchdog, _mfu
    if _watchdog is not None:
        return _watchdog
    _recorder.start(capacity=recorder_capacity)
    _mfu = MfuMeter(reg=reg, clock=clock if clock is not None
                    else time.monotonic)
    _watchdog = Watchdog(timeout_s=watchdog_timeout_s,
                         poll_interval_s=poll_interval_s, clock=clock,
                         reg=reg, mfu=_mfu, **watchdog_kw)
    if crash_handler:
        install_crash_handler()
    if thread:
        _watchdog.start()
    return _watchdog


def stop(keep_recorder=False):
    """Stop the watchdog thread and (unless ``keep_recorder``) detach
    the flight recorder."""
    global _watchdog, _mfu
    if _watchdog is not None:
        _watchdog.stop()
        _watchdog = None
    _mfu = None
    if not keep_recorder:
        _recorder.stop()
