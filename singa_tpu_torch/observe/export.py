"""Exporters for the ``observe`` buffer and registry.

Three formats, three audiences:

* :func:`write_jsonl` / :func:`jsonl_lines` — the raw span/event
  records, one JSON object per line; greppable, streamable, the
  machine-diffable archive format.
* :func:`chrome_trace` / :func:`write_chrome_trace` — Chrome
  trace-event JSON (the ``{"traceEvents": [...]}`` object form),
  loadable directly in Perfetto (https://ui.perfetto.dev) or
  ``chrome://tracing``.  Tracks: one row per SUBSYSTEM (the span
  ``cat`` — train/serve/comms/snapshot/...), named via ``thread_name``
  metadata events, with the originating Python thread preserved in
  each span's args.  Timestamps are microseconds per the spec.
* :func:`prometheus_text` — text exposition of a
  :class:`~singa_tpu_torch.observe.registry.MetricsRegistry` (counters,
  gauges, and histograms with cumulative ``_bucket{le=...}`` series),
  scrapeable by any Prometheus agent.  Metric names are sanitized to
  the exposition charset and prefixed ``singa_tpu_``.  Histograms
  export the full bucket ladder (``registry.DEFAULT_BUCKETS`` or the
  per-metric override) precisely so that cross-process
  ``histogram_quantile(0.99, sum(rate(x_bucket[5m])) by (le))`` works
  over a fleet of replicas — the precomputed nearest-rank quantiles
  (kept as a sibling ``<name>_quantile`` gauge family, the
  single-process view) cannot be aggregated.

The request-tracing round adds :func:`request_trace_events`: the
:class:`~singa_tpu_torch.observe.requests.RequestLedger`'s per-request
timelines as Chrome-trace tracks (one row per request: queue /
prefill / decode phase spans per hop, flow arrows linking
cross-replica hops).  ``chrome_trace(requests=...)`` merges them into
the span trace under their own ``requests`` process group.

All exporters take explicit ``events``/``reg`` arguments and default
to the live trace buffer / default registry, so tests can run them on
synthetic data.

The port's own copy of ``singa_tpu/observe/export.py`` (it imports
nothing of the JAX package); the wire formats are the same.
"""

from __future__ import annotations

import json
import math
import os
import re
import time as _time

from . import trace as _trace
from .registry import (SCHEMA_ROOT, Counter, Histogram,
                       registry as _registry)

__all__ = ["jsonl_lines", "write_jsonl", "chrome_trace",
           "write_chrome_trace", "request_trace_events",
           "step_trace_events", "prometheus_text", "write_prometheus",
           "json_sanitize"]


def json_sanitize(obj):
    """Deep copy with non-finite floats (nan/inf) replaced by None, so
    the result serializes as STRICT JSON (``json.dumps(...,
    allow_nan=False)`` passes).  Python's encoder would emit the
    non-standard ``NaN`` token, which jq / JSON.parse / serde all
    reject — an honest in-memory ``mfu=nan`` must become ``null`` on
    the wire, not a file only Python can read.  Used by the benches'
    report/health writers and the monitor's crash bundles."""
    if isinstance(obj, dict):
        return {k: json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_sanitize(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    return obj


# ---------------------------------------------------------------------------
# JSONL
# ---------------------------------------------------------------------------

def jsonl_lines(events=None):
    """Yield one JSON line per buffered event (record schema as
    documented in ``trace.py``)."""
    if events is None:
        events = _trace.events()
    for rec in events:
        yield json.dumps(rec, default=str)


def write_jsonl(path, events=None):
    """Write the event log as JSONL; returns the event count."""
    n = 0
    with open(path, "w") as f:
        for line in jsonl_lines(events):
            f.write(line + "\n")
            n += 1
    return n


# ---------------------------------------------------------------------------
# Chrome trace-event JSON (Perfetto / chrome://tracing)
# ---------------------------------------------------------------------------

def request_trace_events(entries, pid=1) -> list:
    """Per-request Chrome-trace tracks from sealed
    :class:`~singa_tpu_torch.observe.requests.RequestLedger` entries: one
    tid per request, phase spans per hop (``queue`` submit→admission,
    ``prefill`` admission→first token, ``decode`` first token→hop
    end), rejection instants, and FLOW events (``ph: s``/``f``)
    drawing an arrow across each requeue/failover/hedge hop boundary —
    in Perfetto a failover-requeued request reads as one line with a
    visible jump between replicas.  Rides its own ``requests``
    process (``pid``) so the per-subsystem span tracks (pid 0) stay
    untouched."""
    out = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "requests"}}]
    flow_id = 0
    for tid, e in enumerate(entries):
        rid = e["request_id"]
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": f"req {rid}"}})
        hops = e.get("hops") or []
        for j, h in enumerate(hops):
            if j + 1 < len(hops):
                hop_end = hops[j + 1]["t_submit"]
            elif e.get("t_retire") is not None:
                hop_end = e["t_retire"]
            else:
                hop_end = h["t_submit"]
            base = {"request": rid, "hop": j,
                    "engine": h.get("engine"),
                    "replica": h.get("replica"),
                    "host": h.get("host"), "via": h.get("via")}

            def span(name, t0, t1, **extra):
                if t0 is None or t1 is None or t1 < t0:
                    return
                out.append({"name": name, "cat": "request", "ph": "X",
                            "pid": pid, "tid": tid, "ts": t0 * 1e6,
                            "dur": (t1 - t0) * 1e6,
                            "args": dict(base, **extra)})

            t_admit, t_first = h.get("t_admit"), h.get("t_first_token")
            span("queue", h["t_submit"],
                 t_admit if t_admit is not None else hop_end,
                 depth=h.get("queue_depth_at_enqueue"))
            span("prefill", t_admit, t_first,
                 kind=h.get("admit_kind"),
                 hit_tokens=h.get("hit_tokens"),
                 chunks=len(h.get("chunks") or ()))
            span("decode", t_first, hop_end, tokens=h.get("tokens"))
            rej = h.get("reject")
            if rej is not None:
                out.append({"name": "rejected", "cat": "request",
                            "ph": "i", "s": "t", "pid": pid,
                            "tid": tid, "ts": rej["t"] * 1e6,
                            "args": dict(base,
                                         reason=rej.get("reason"),
                                         started=rej.get("started"))})
            if j > 0:
                # flow arrow: previous hop's end -> this hop's submit
                flow_id += 1
                out.append({"name": "hop", "cat": "request", "ph": "s",
                            "pid": pid, "tid": tid, "id": flow_id,
                            "ts": h["t_submit"] * 1e6 - 1,
                            "args": base})
                out.append({"name": "hop", "cat": "request", "ph": "f",
                            "bp": "e", "pid": pid, "tid": tid,
                            "id": flow_id, "ts": h["t_submit"] * 1e6,
                            "args": base})
    return out


def step_trace_events(records, pid=2) -> list:
    """Dual-lane step-anatomy tracks from
    :func:`~singa_tpu_torch.observe.stepprof.records` entries: per engine a
    HOST lane (one ``X`` slice per host segment piece, named by
    segment, the step's wall as a ``step N`` parent slice) stacked
    directly above a DEVICE lane (one slice per dispatch→ready
    window).  The bubble is what you SEE: every gap in the device lane
    under host activity is device idle time — ROADMAP item 5's target
    rendered as empty pixels.  Rides its own ``step anatomy`` process
    (``pid``) next to the subsystem (pid 0) and request (pid 1)
    tracks."""
    out = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "step anatomy"}}]
    labels = []
    for rec in records:
        if rec["engine"] not in labels:
            labels.append(rec["engine"])
    lanes = {}
    for i, lbl in enumerate(labels):
        host_tid, dev_tid = 2 * i, 2 * i + 1
        lanes[lbl] = (host_tid, dev_tid)
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": host_tid,
                    "args": {"name": f"e{lbl} host"}})
        out.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": dev_tid,
                    "args": {"name": f"e{lbl} device"}})
    for rec in records:
        host_tid, dev_tid = lanes[rec["engine"]]
        base = {"engine": rec["engine"], "step": rec["step"]}
        # the step's wall as the host lane's top-level slice: nested
        # segment pieces render inside it, and its args carry the
        # sealed totals (the hover-card summary)
        out.append({"name": f"step {rec['step']}", "cat": "step.host",
                    "ph": "X", "pid": pid, "tid": host_tid,
                    "ts": rec["t0"] * 1e6, "dur": rec["wall_s"] * 1e6,
                    "args": dict(base,
                                 bubble_frac=round(
                                     rec["bubble_frac"], 4),
                                 host_s=rec["host_s"],
                                 device_s=rec["device_s"])})
        for name, t0, dur in rec["pieces"]:
            if name == "device" or dur <= 0.0:
                continue  # device windows render on their own lane
            out.append({"name": name, "cat": "step.host", "ph": "X",
                        "pid": pid, "tid": host_tid, "ts": t0 * 1e6,
                        "dur": dur * 1e6, "args": base})
        for t0, dur in rec["device_windows"]:
            out.append({"name": "device", "cat": "step.device",
                        "ph": "X", "pid": pid, "tid": dev_tid,
                        "ts": t0 * 1e6, "dur": dur * 1e6,
                        "args": base})
    return out


def chrome_trace(events=None, metadata=None, requests=None,
                 steps=None) -> dict:
    """Build the trace-event object: spans as complete ("X") events,
    instants as "i", one tid per subsystem category with a
    ``thread_name`` row label.  ``metadata`` is merged into the
    top-level ``otherData``.  ``requests``: optional sealed
    request-ledger entries rendered as per-request tracks
    (:func:`request_trace_events`) in the same document.  ``steps``:
    optional step-anatomy ring records
    (``stepprof.records()``) rendered as dual host/device lanes per
    engine (:func:`step_trace_events`)."""
    if events is None:
        events = _trace.events()
    cats = []
    for rec in events:
        if rec["cat"] not in cats:
            cats.append(rec["cat"])
    tid_of = {c: i for i, c in enumerate(cats)}
    out = []
    for c, tid in tid_of.items():
        out.append({"name": "thread_name", "ph": "M", "pid": 0,
                    "tid": tid, "args": {"name": c}})
    for rec in events:
        args = dict(rec["args"] or {})
        args["thread"] = rec["tid"]
        if rec.get("parent"):
            args["parent"] = rec["parent"]
        ev = {"name": rec["name"], "cat": rec["cat"], "ph": rec["ph"],
              "pid": 0, "tid": tid_of[rec["cat"]],
              "ts": rec["ts"] * 1e6, "args": args}
        if rec["ph"] == "X":
            ev["dur"] = rec["dur"] * 1e6
        else:
            ev["s"] = "t"  # instant scoped to its track
        out.append(ev)
    if requests:
        out.extend(request_trace_events(requests, pid=1))
    if steps:
        out.extend(step_trace_events(steps, pid=2))
    doc = {"traceEvents": out, "displayTimeUnit": "ms",
           "otherData": {"source": f"{SCHEMA_ROOT}.observe",
                         "dropped_events": _trace.dropped()}}
    if requests:
        doc["otherData"]["request_tracks"] = len(requests)
    if steps:
        doc["otherData"]["step_records"] = len(steps)
    if metadata:
        doc["otherData"].update(metadata)
    return doc


def write_chrome_trace(path, events=None, metadata=None,
                       requests=None, steps=None) -> int:
    """Write the Chrome trace JSON; returns the trace-event count
    (metadata rows included)."""
    doc = chrome_trace(events, metadata, requests=requests,
                       steps=steps)
    with open(path, "w") as f:
        # default=str: span args routinely carry numpy/torch scalars; a
        # trace must never be lost at export time over a dtype
        json.dump(doc, f, default=str)
    return len(doc["traceEvents"])


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_PREFIX = "singa_tpu_"

# process start (module import — the observe layer loads with the
# package), the singa_tpu_process_uptime_seconds zero point
_T0 = _time.monotonic()


def _build_info_labels():
    """(key, value) pairs for the ``singa_tpu_build_info`` gauge:
    package version, torch version, and the backend (``cuda`` when a
    GPU is visible, else ``cpu``; asking does not create a CUDA
    context)."""
    try:
        from .. import __version__ as ver
    except Exception:
        ver = "unknown"
    try:
        import torch
        tver = torch.__version__
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    except Exception:
        tver, backend = "absent", "none"
    return [("version", str(ver)), ("torch", tver),
            ("backend", backend)]


def _prom_name(name: str) -> str:
    n = _NAME_OK.sub("_", name)
    if n and n[0].isdigit():
        n = "_" + n
    return _PREFIX + n


def _prom_labels(labels, extra=()):
    items = list(labels) + list(extra)
    if not items:
        return ""
    body = ",".join(
        '%s="%s"' % (_NAME_OK.sub("_", k),
                     str(v).replace("\\", r"\\").replace('"', r'\"'))
        for k, v in items)
    return "{" + body + "}"


def _prom_num(v) -> str:
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v) if v != int(v) else str(int(v))


def prometheus_text(reg=None) -> str:
    """Render a registry in the Prometheus text exposition format.
    Histograms are exposed as real TYPE-histogram families: cumulative
    ``_bucket{le=...}`` series over the metric's bucket ladder
    (``registry.DEFAULT_BUCKETS`` or the per-metric override) ending
    in ``le="+Inf"`` == ``_count``, plus ``_sum``/``_count`` — the
    form ``histogram_quantile()`` can aggregate ACROSS a fleet of
    scraped replicas, which the previous summary-only exposition could
    not.  The nearest-rank p50/p99 each process already computes ride
    along as a sibling ``<name>_quantile`` gauge family (the exact
    single-process view; conformant scrapers reject quantile samples
    inside a histogram family, hence the separate name)."""
    if reg is None:
        reg = _registry()
    by_name = {}
    for m in reg.metrics():
        by_name.setdefault(m.name, []).append(m)
    lines = []
    for name in sorted(by_name):
        group = by_name[name]
        pname = _prom_name(name)
        kind = group[0].KIND
        # counter samples carry the _total suffix, and the classic
        # text format (prometheus_client convention) declares TYPE/
        # HELP under the SAMPLE name — a TYPE under the bare name
        # would describe a family with zero samples
        decl = pname + "_total" if kind == "counter" else pname
        help_ = next((m.help for m in group if m.help), "")
        if help_:
            lines.append(f"# HELP {decl} {help_}")
        lines.append(f"# TYPE {decl} {kind}")
        for m in group:
            if isinstance(m, Histogram):
                s = m.series
                for le, c in m.bucket_counts():
                    lines.append(
                        pname + "_bucket"
                        + _prom_labels(m.labels, [("le", _prom_num(le))])
                        + " " + _prom_num(c))
                # running total, NOT sum(s.values): once the retained
                # window is bounded, a windowed sum next to the
                # all-time _count would make rate(_sum)/rate(_count)
                # lie about the mean
                lines.append(pname + "_sum" + _prom_labels(m.labels)
                             + " " + _prom_num(s.total_sum))
                lines.append(pname + "_count" + _prom_labels(m.labels)
                             + " " + _prom_num(s.count))
            else:
                suffix = "_total" if isinstance(m, Counter) else ""
                lines.append(pname + suffix + _prom_labels(m.labels)
                             + " " + _prom_num(m.value))
        if kind == "histogram":
            # sibling family for the exact in-process quantiles
            lines.append(f"# TYPE {pname}_quantile gauge")
            for m in group:
                for q in (0.5, 0.99):
                    lines.append(
                        pname + "_quantile"
                        + _prom_labels(m.labels, [("quantile", q)])
                        + " " + _prom_num(m.series.percentile(q * 100)))
    lines.extend(_windowed_lines(reg))
    # scrape-target hygiene: build identity + process uptime, so any
    # dashboard can join a regression onto a deploy and rate() the
    # target's restarts
    lines.append("# HELP singa_tpu_build_info build identity "
                 "(version/torch/backend); always 1")
    lines.append("# TYPE singa_tpu_build_info gauge")
    lines.append("singa_tpu_build_info"
                 + _prom_labels(_build_info_labels()) + " 1")
    lines.append("# HELP singa_tpu_process_uptime_seconds seconds "
                 "since the observe layer loaded in this process")
    lines.append("# TYPE singa_tpu_process_uptime_seconds gauge")
    lines.append("singa_tpu_process_uptime_seconds "
                 + _prom_num(_time.monotonic() - _T0))
    return "\n".join(lines) + "\n"


def _windowed_lines(reg) -> list:
    """Sibling-gauge exposition for every windowed family
    (observe.timeseries): ``<name>_rate_60s``-style names, one sample
    per label set per window, each family with its own HELP/TYPE
    block.  The all-time families above are untouched — windowed
    truth rides NEXT TO them, never instead of them."""
    from .timeseries import _wlabel

    lines = []
    fams = reg.windowed_families()
    for name in sorted(fams):
        wf = fams[name]
        pname = _prom_name(name)
        if wf.kind == "histogram":
            cols = (("rate", "rate", "in-window events per second"),
                    ("p50", "q50", "nearest-rank p50 over the window"),
                    ("p99", "q99", "nearest-rank p99 over the window"))
        elif wf.kind == "gauge":
            cols = (("mean", "mean", "mean written level over the "
                                     "window"),)
        else:
            cols = (("rate", "rate", "counter growth per second over "
                                     "the window"),)
        now = wf.clock()
        rings = dict(wf.rings)  # scale-ups attach concurrently
        for col, _, help_ in cols:
            for w in wf.windows:
                # _wlabel of a fractional window carries a dot, which
                # is illegal in a metric NAME (fine in label values) —
                # sanitize or one bad window poisons the whole scrape
                fam = _NAME_OK.sub("_",
                                   f"{pname}_{col}_{_wlabel(w)}s")
                lines.append(
                    f"# HELP {fam} windowed sibling of {pname}: "
                    f"{help_} ({_wlabel(w)}s window)")
                lines.append(f"# TYPE {fam} gauge")
                for labels in sorted(rings):
                    ring = rings[labels]
                    if col == "rate":
                        v = ring.rate(w, now)
                    elif col == "mean":
                        v = ring.mean(w, now)
                    else:
                        v = ring.quantile(
                            0.5 if col == "p50" else 0.99, w, now)
                    lines.append(fam + _prom_labels(labels) + " "
                                 + _prom_num(v))
    return lines


def write_prometheus(path, reg=None) -> str:
    text = prometheus_text(reg)
    with open(path, "w") as f:
        f.write(text)
    return text
