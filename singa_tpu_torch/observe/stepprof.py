"""Step-anatomy profiler: host/device attribution for every
``engine.step()``.

ROADMAP item 5 ("overlap host scheduling with device compute") needs a
measuring stick before the surgery: the RequestLedger attributes
per-REQUEST phases (queue/prefill/decode/stall), but nothing measures
where one STEP's wall time goes — how much is host bookkeeping between
dispatches (the device-idle *bubble* the overlap work must close) and
how much is the device actually executing.  This module is that
microscope:

* **host segments** — clock fences at the existing seams in
  ``serve/engine.py`` decompose the step wall into named host
  segments: ``schedule`` (the scheduling pass), ``admit`` (one
  admission's host work), ``prefix_lookup`` (radix-cache probes),
  ``dispatch`` (building inputs + launching an executable),
  ``sync`` (host-side copies after the device is done), ``emit``
  (token emission + callbacks), ``retire`` (slot teardown),
  ``ledger`` (RequestLedger hooks).  Fences nest; accounting is
  EXCLUSIVE (a retire inside the emit loop is retire time, never
  double-counted as emit), and unfenced host time lands in
  ``other`` — so the segments always sum to the wall exactly, the
  RequestLedger's seal-time idiom.
* **device time** — one hook at the executor seam (``engine._x``,
  ``_ProfExec`` around ``_LocalExec``) and one around the engine's
  decode step (a captured step is one graph replay, never a call
  through the executor) record dispatch → the device reaching the
  dispatch's end (a synchronize of the output's CUDA stream; nothing
  on the CPU, where the call has already run).  Async
  dispatch is therefore credited, not hidden: host work done while
  the device runs overlaps the device window instead of extending
  it.  ``bubble_frac = (wall - device) / wall`` is the fraction of
  the step during which the device sat idle — the item-5 metric.
* **zero cost when off** — every fence site is ONE module-flag read
  (``if stepprof._active:``), the trace.py discipline: no allocation,
  no clock call, nothing enters a captured step (the hook only adds a
  synchronize after the dispatch, and never while a stream is
  capturing, so no graph is captured after warm-up with the profiler
  ON).

Publication surfaces:

* registry: ``serve.step.{wall_s,host_s,device_s}{engine=}`` and
  ``serve.step.segment_s{engine=,segment=}`` histograms on a dedicated
  100µs–5s ladder (:data:`STEP_BUCKETS` — the default request ladder
  is far too coarse for 5–50ms steps), plus
  ``serve.step.bubble_frac{engine=}`` on a 0–1 fraction ladder.
  Registered lazily per engine label; an engine's close
  (:func:`forget_engine`) removes its series — the retire-unregisters
  contract.
* trace: one ``cat="step.host"`` COMPLETE record per step (segment
  fractions in args) and one ``cat="step.device"`` record per device
  window, emitted through ``trace._emit`` whenever tracing or the
  flight-recorder ring is live — so worker step anatomy rides the
  existing cross-host trace federation (observe/federate.py) and
  shows up as two lanes per host pid in the merged Chrome trace.
* ring: the last N full step records (per-piece host intervals +
  device windows) for the dual-lane local Chrome trace
  (``export.chrome_trace(steps=...)``).
* health: :func:`section` → ``health_report()["serve"]
  ["step_anatomy"]``; :func:`why_slow_summary` rides the why_slow
  section; :func:`culprit` feeds the Watchdog so a step-time anomaly
  names host-vs-device.

Profiler state is MODULE-level (like trace/monitor): an
``EngineSupervisor`` restart builds a fresh engine under the same
profiler, whose fresh ``engine=`` label starts fresh series while the
dead engine's are removed.

The port's own copy of ``singa_tpu/observe/stepprof.py`` (it imports
nothing of the JAX package); the wire formats are the same.
"""

from __future__ import annotations

import collections
import threading
import time

from .registry import registry as _registry
from . import trace as _trace

__all__ = ["StepProfiler", "enable", "disable", "active", "profiler",
           "section", "why_slow_summary", "culprit", "records",
           "forget_engine", "SEGMENTS", "STEP_BUCKETS",
           "FRACTION_BUCKETS"]

#: segment taxonomy (docs/OBSERVABILITY.md "Step anatomy"): the named
#: host segments, the device-execution windows, and the unfenced
#: remainder.  Fractions over these sum to 1 per step by construction.
SEGMENTS = ("schedule", "admit", "prefix_lookup", "dispatch", "device",
            "sync", "emit", "retire", "ledger", "other")

#: dedicated step-latency ladder: 100µs–5s.  registry.DEFAULT_BUCKETS
#: starts at 1ms and tops at 2min — the request ladder, far too coarse
#: for 5–50ms steps.
STEP_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)

#: bubble_frac is a ratio in [0, 1]; a time ladder would be nonsense
FRACTION_BUCKETS = (0.01, 0.02, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6,
                    0.7, 0.8, 0.9, 0.95, 0.99, 1.0)

# Module-global fast path, mirroring trace._active: `if not
# stepprof._active: <skip>` is the ENTIRE disabled cost of a fence
# site.  _prof is non-None exactly while _active is True.
_active = False
_prof = None
_tls = threading.local()

def _cuda_tensor(out):
    """The first CUDA tensor in ``out`` (a tensor, or tuples, lists and
    dicts of them), or None."""
    import torch

    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                return x
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return None


def _block(out):
    """Wait until the device has run what produced ``out``: a
    synchronize of the current stream of its CUDA device.  Nothing for
    CPU outputs (the call has run), and nothing while that stream is
    capturing a CUDA graph: a synchronize there would end the capture,
    and a capture runs nothing to wait for."""
    t = _cuda_tensor(out)
    if t is None:
        return out
    import torch

    stream = torch.cuda.current_stream(t.device)
    if torch.cuda.is_current_stream_capturing():
        return out
    stream.synchronize()
    return out


def enable(clock=None, ring=512, reg=None) -> "StepProfiler":
    """Attach a fresh process-wide profiler and turn the fences on.
    ``clock``: ``() -> float`` seconds — pass the trace clock when
    both are on so step-anatomy trace records share its time base
    (the dist worker does; offsets then correct both together).
    ``ring`` bounds the per-step record buffer."""
    global _active, _prof
    _prof = StepProfiler(clock=clock, ring=ring, reg=reg)
    _active = True
    return _prof


def disable(unregister=True):
    """Turn the fences off and detach.  ``unregister=True`` (default)
    also removes every ``serve.step.*`` series the profiler created —
    the retire-unregisters contract; pass False to keep them readable
    (export after disable)."""
    global _active, _prof
    p, _prof = _prof, None
    _active = False
    _tls.cur = None
    if p is not None and unregister:
        p.unregister()


def active() -> bool:
    return _active


def profiler():
    """The live profiler, or None when off."""
    return _prof


def forget_engine(label):
    """Remove a closed engine's ``serve.step.*{engine=label}`` series
    (``engine._release_everything`` calls this): a supervisor-rebuilt
    engine's fresh label must not leave the dead one's series frozen
    in the exposition.  Safe no-op when the profiler is off."""
    if _prof is not None:
        _prof.forget_engine(label)


# -- fences (serve/engine.py calls these, each behind one _active
#    read; all are safe no-ops when no step is open on this thread) --

def begin(engine, step=None):
    p = _prof
    if p is not None:
        p.step_begin(engine, step=step)


def end():
    st = getattr(_tls, "cur", None)
    _tls.cur = None
    if st is not None and st.owner is _prof and _prof is not None:
        _prof._finish(st)


def abort():
    """Drop the open step record (the engine's failure path: a step
    that raised has no meaningful anatomy)."""
    _tls.cur = None


def begin_quantum(engine, step=None) -> bool:
    """Open a step for an out-of-``step()`` work quantum — a prefix
    BUILD chunk on a disaggregated prefill specialist, whose engine
    never runs the decode step loop but whose dispatches are exactly
    the host/device anatomy this profiler exists to expose.  No-op
    (returns False) when a step is already open on this thread — a
    build driven from inside ``step()`` stays attributed to that
    step.  The caller pairs True with :func:`end` / :func:`abort`."""
    p = _prof
    if p is None or getattr(_tls, "cur", None) is not None:
        return False
    p.step_begin(engine, step=step)
    return True


def push(name):
    st = getattr(_tls, "cur", None)
    if st is not None:
        st.push(name)


def pop():
    st = getattr(_tls, "cur", None)
    if st is not None:
        st.pop()


def timed_dispatch(fn, a, kw):
    """The executor-seam hook (``engine._ProfExec``, and the engine's
    decode step): time the host dispatch (building inputs + launching)
    and the device window (dispatch return → the device done with the
    output, :func:`_block`).  The wait is the ONLY added work and runs
    after the dispatch, so nothing enters a captured step.  Outside an
    open step, or inside a dispatch already being timed (an eager
    decode step's own calls through the executor), the call passes
    straight through: its time is the enclosing dispatch's."""
    st = getattr(_tls, "cur", None)
    if st is None or (st.stack and st.stack[-1] == "dispatch"):
        return fn(*a, **kw)
    st.push("dispatch")
    out = fn(*a, **kw)
    st.pop()
    st.push("device")
    _block(out)
    t0, dur = st.pop()
    st.dev += dur
    st.dev_windows.append((t0, dur))
    return out


# -- health/monitor read surface --------------------------------------

def section() -> dict:
    """``health_report()["serve"]["step_anatomy"]``: always a dict
    with an ``enabled`` key, so dashboards and the CI gate can assert
    on it unconditionally."""
    if _prof is None:
        return {"enabled": False}
    return _prof.section()


def why_slow_summary():
    """The compact step-anatomy rider on ``why_slow``: overall
    host/device split, the dominant host segment, and the culprit
    verdict.  None when the profiler is off or has no steps."""
    if _prof is None:
        return None
    return _prof.why_slow_summary()


def culprit(source=None):
    """The Watchdog feed: host-vs-device attribution for the LAST
    completed step of the engine behind heartbeat ``source``
    (``serve.e<label>``), or of the most recent step when the source
    doesn't parse.  None when the profiler is off or has no record."""
    if _prof is None:
        return None
    return _prof.culprit(source)


def records() -> list:
    """Snapshot of the per-step ring (for the dual-lane Chrome
    trace exporter)."""
    if _prof is None:
        return []
    return list(_prof._ring)


# -- the profiler ------------------------------------------------------

class _StepState:
    """One step's open record: an exclusive-time segment stack plus
    the device windows.  Allocated only while the profiler is ON."""

    __slots__ = ("owner", "engine", "step", "t0", "last", "stack",
                 "seg", "pieces", "dev", "dev_windows", "clock")

    def __init__(self, owner, engine, step, clock):
        self.owner = owner
        self.engine = engine
        self.step = step
        self.clock = clock
        self.t0 = self.last = clock()
        self.stack = []
        self.seg = {}
        self.pieces = []       # (segment, t_start, dur) host intervals
        self.dev = 0.0
        self.dev_windows = []  # (t_start, dur) device-busy intervals

    def push(self, name):
        now = self.clock()
        if self.stack:
            # the parent's elapsed-so-far is the parent's, exclusively
            cur = self.stack[-1]
            dt = now - self.last
            self.seg[cur] = self.seg.get(cur, 0.0) + dt
            self.pieces.append((cur, self.last, dt))
        self.stack.append(name)
        self.last = now

    def pop(self):
        if not self.stack:
            return (self.last, 0.0)
        now = self.clock()
        name = self.stack.pop()
        t0, dt = self.last, now - self.last
        self.seg[name] = self.seg.get(name, 0.0) + dt
        self.pieces.append((name, t0, dt))
        self.last = now
        return (t0, dt)


class StepProfiler:
    """Per-step host/device time attribution (module docstring).

    Single-writer per thread (each engine's step loop is
    single-threaded; concurrent engines on different threads each
    carry their own open step via a thread-local)."""

    def __init__(self, clock=None, ring=512, reg=None):
        self._clock = clock if clock is not None else time.perf_counter
        self._reg = reg if reg is not None else _registry()
        self._ring = collections.deque(maxlen=int(ring))
        self._metrics = {}      # engine label -> {"wall": h, ...}
        self._seg_metrics = {}  # (label, segment) -> Histogram
        self._registered = []
        self._agg = {}          # label -> {"steps", "wall_s",
        #                                   "device_s", "seg": {...}}
        self.steps = 0

    # -- recording -------------------------------------------------------
    def step_begin(self, engine, step=None):
        _tls.cur = _StepState(self, engine, step, self._clock)

    def _finish(self, st):
        now = self._clock()
        while st.stack:          # a dangling fence closes at step end
            st.pop()
        wall = max(now - st.t0, 0.0)
        seg = st.seg
        other = wall - sum(seg.values())
        if other > 0.0:
            seg["other"] = seg.get("other", 0.0) + other
        device = st.dev
        host = max(wall - device, 0.0)
        bubble = (host / wall) if wall > 0.0 else 0.0
        label = st.engine
        agg = self._agg.get(label)
        if agg is None:
            agg = self._agg[label] = {"steps": 0, "wall_s": 0.0,
                                      "device_s": 0.0, "seg": {}}
        agg["steps"] += 1
        agg["wall_s"] += wall
        agg["device_s"] += device
        aseg = agg["seg"]
        for k, v in seg.items():
            aseg[k] = aseg.get(k, 0.0) + v
        self._publish(label, wall, host, device, bubble, seg)
        rec = {"engine": label, "step": st.step, "t0": st.t0,
               "wall_s": wall, "host_s": host, "device_s": device,
               "bubble_frac": bubble, "segments": dict(seg),
               "pieces": st.pieces, "device_windows": st.dev_windows}
        self._ring.append(rec)
        self.steps += 1
        if _trace._active:
            # ride the trace buffer/ring (and, on a dist worker, the
            # trace federation): one host-lane record per step, one
            # device-lane record per window — per-host dual lanes in
            # the merged Chrome trace come from exactly these
            tid = threading.current_thread().name
            _trace._emit({
                "name": f"step/e{label}", "cat": "step.host",
                "ph": "X", "ts": st.t0, "dur": wall, "tid": tid,
                "depth": 0, "parent": None,
                "args": {"engine": label, "step": st.step,
                         "bubble_frac": round(bubble, 4),
                         "device_s": device,
                         "segments": {k: round(v, 6)
                                      for k, v in seg.items()}}})
            for t0w, dw in st.dev_windows:
                _trace._emit({
                    "name": f"device/e{label}", "cat": "step.device",
                    "ph": "X", "ts": t0w, "dur": dw, "tid": tid,
                    "depth": 0, "parent": None,
                    "args": {"engine": label, "step": st.step}})

    def _publish(self, label, wall, host, device, bubble, seg):
        m = self._metrics.get(label)
        if m is None:
            reg = self._reg
            m = {
                "wall": reg.histogram(
                    "serve.step.wall_s",
                    help="engine.step() wall seconds",
                    buckets=STEP_BUCKETS, engine=label),
                "host": reg.histogram(
                    "serve.step.host_s",
                    help="host-side step seconds (wall - device)",
                    buckets=STEP_BUCKETS, engine=label),
                "device": reg.histogram(
                    "serve.step.device_s",
                    help="device-busy step seconds (dispatch -> "
                         "block_until_ready, summed per window)",
                    buckets=STEP_BUCKETS, engine=label),
                "bubble": reg.histogram(
                    "serve.step.bubble_frac",
                    help="device-idle fraction of the step wall",
                    buckets=FRACTION_BUCKETS, engine=label),
            }
            self._metrics[label] = m
            self._registered += list(m.values())
        m["wall"].observe(wall)
        m["host"].observe(host)
        m["device"].observe(device)
        m["bubble"].observe(bubble)
        for name, v in seg.items():
            h = self._seg_metrics.get((label, name))
            if h is None:
                h = self._reg.histogram(
                    "serve.step.segment_s",
                    help="per-segment host/device step seconds",
                    buckets=STEP_BUCKETS, engine=label, segment=name)
                self._seg_metrics[(label, name)] = h
                self._registered.append(h)
            h.observe(v)

    # -- lifecycle -------------------------------------------------------
    def forget_engine(self, label):
        dead = list(self._metrics.get(label, {}).values())
        dead += [h for (lbl, _), h in self._seg_metrics.items()
                 if lbl == label]
        if dead:
            self._reg.remove(*dead)
            self._registered = [m for m in self._registered
                                if m not in dead]
        self._metrics.pop(label, None)
        for key in [k for k in self._seg_metrics if k[0] == label]:
            del self._seg_metrics[key]

    def unregister(self):
        if self._registered:
            self._reg.remove(*self._registered)
            self._registered = []
        self._metrics = {}
        self._seg_metrics = {}

    # -- reads -----------------------------------------------------------
    def section(self) -> dict:
        engines = {}
        for label, agg in self._agg.items():
            denom = sum(agg["seg"].values())
            wall = agg["wall_s"]
            n = agg["steps"]
            engines[label] = {
                "steps": n,
                "wall_s_total": wall,
                "wall_s_mean": wall / n if n else 0.0,
                "device_s_total": agg["device_s"],
                "host_s_total": max(wall - agg["device_s"], 0.0),
                "bubble_frac": (max(wall - agg["device_s"], 0.0)
                                / wall if wall > 0 else 0.0),
                # fractions over ONE denominator (the summed segment
                # chain) — they sum to 1 up to float rounding, the
                # ledger's exact-arithmetic idiom
                "fractions": ({k: v / denom
                               for k, v in sorted(agg["seg"].items())}
                              if denom > 0 else {}),
            }
        return {"enabled": True, "steps": self.steps,
                "engines": engines,
                "why_slow": self.why_slow_summary()}

    def why_slow_summary(self):
        wall = sum(a["wall_s"] for a in self._agg.values())
        if wall <= 0.0:
            return None
        device = sum(a["device_s"] for a in self._agg.values())
        host_seg = {}
        for a in self._agg.values():
            for k, v in a["seg"].items():
                if k != "device":
                    host_seg[k] = host_seg.get(k, 0.0) + v
        top = max(host_seg, key=host_seg.get) if host_seg else None
        bubble = max(wall - device, 0.0) / wall
        return {
            "bubble_frac": bubble,
            "device_frac": min(device / wall, 1.0),
            "host_frac": bubble,
            "top_host_segment": top,
            "top_host_segment_frac": (host_seg[top] / wall
                                      if top is not None else 0.0),
            "culprit": "host" if bubble >= 0.5 else "device",
        }

    def culprit(self, source=None):
        label = None
        if isinstance(source, str) and source.startswith("serve.e"):
            label = source[len("serve.e"):]
        for rec in reversed(self._ring):
            if label is not None and rec["engine"] != label:
                continue
            host_seg = {k: v for k, v in rec["segments"].items()
                        if k != "device"}
            top = (max(host_seg, key=host_seg.get)
                   if host_seg else None)
            return {
                "culprit": ("host" if rec["bubble_frac"] >= 0.5
                            else "device"),
                "bubble_frac": round(rec["bubble_frac"], 4),
                "host_s": rec["host_s"],
                "device_s": rec["device_s"],
                "top_host_segment": top,
            }
        return None
