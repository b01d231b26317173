"""Fleet-wide observability federation: see across the process boundary.

Multi-host serving (``serve/dist/``) leaves every observability
surface per-process: a request that prefills on worker A
and decodes on worker B has two disjoint ledgers, two registries, and
no merged timeline.  This module is the controller-side other half —
the Dapper story for the dist fleet:

* :class:`ClockSync` — NTP-style clock-offset estimation over the
  existing framed ``Conn.call``: N ping round trips per peer, keep the
  minimum-RTT sample (the one least contaminated by queueing), offset
  = ``peer_time - (t0 + t1) / 2``.  The estimate's error is bounded by
  RTT/2 by construction — the peer answered SOMEWHERE inside the round
  trip, and the midpoint is never more than half the trip away from
  any point in it.  Offsets are applied at MERGE time (worker records
  stay in their own clock on the wire) and re-estimated on every
  reconnect — ``_new_supervisor`` runs on spawn, ``revive``, and the
  autoscaler's ``replace_dead``, so a replacement process's fresh
  monotonic base is never mixed with its predecessor's.

* :class:`FleetTelemetry` — the merge point.  Workers ship registry
  dumps, sealed RequestLedger records, and drained trace events as
  framed ``telemetry`` replies (periodic pull from the fleet's
  watchdog slot + on-demand ``pull()``); the controller merges them
  into

  - one Chrome trace: one pid per host, worker timestamps shifted into
    controller time, cross-host FLOW arrows following KV ships and
    failover hops (:meth:`FleetTelemetry.chrome_trace`);
  - one Prometheus exposition with ``host=`` labels on every worker
    series (:meth:`FleetTelemetry.prometheus_text`) — the real-bucket
    histograms exist precisely so ``histogram_quantile(sum(rate(
    x_bucket[5m])) by (le))`` aggregates across a fleet, and
    :func:`quantile_from_buckets` is that aggregation done locally;
  - one fleet-wide why_slow (:meth:`FleetTelemetry.why_slow`): worker
    hop detail grafted onto the controller's routing skeleton, all
    seven phases (queue/prefill/ship/decode/stall/preempted/hops)
    exact, and the straggler HOST named.

Telemetry loss NEVER blocks serving: a pull that fails (partition,
timeout, the ``serve.dist.telemetry`` fault site) degrades the host to
a typed ``stale`` marker — last-known data stays readable, health says
so, and the serving RPC stream is untouched.  A host that is retired
or replaced is REMOVED (:meth:`FleetTelemetry.remove_host`): the
retire-unregisters contract extended across the boundary — a dead
host's series leave the exposition instead of freezing.

Everything here is pure data plumbing: no serve imports, injectable
clocks, synthetic-input friendly (the tests drive it with fake skewed
clocks and hand-built dumps).

The port's own copy of ``singa_tpu/observe/federate.py`` (it imports
nothing of the JAX package); the wire formats are the same.
"""

from __future__ import annotations

import copy
import json
import math
import time

from ..utils.metrics import percentile
from . import requests as _requests
from . import trace as _trace
from .registry import registry as _registry

__all__ = ["ClockSync", "FleetTelemetry", "dump_registry",
           "quantile_from_buckets", "merge_bucket_counts", "install",
           "uninstall", "dist_section"]


# ---------------------------------------------------------------------------
# clock-offset estimation
# ---------------------------------------------------------------------------

class ClockSync:
    """One peer's clock relation to ours, from min-RTT ping samples.

    ``offset`` is ``peer_clock - local_clock`` (seconds): a peer
    timestamp maps into local time as ``t_local = t_peer - offset``
    (:meth:`to_local`).  ``rtt`` is the minimum observed round trip and
    ``uncertainty == rtt / 2`` bounds the offset error — the peer read
    its clock somewhere inside the round trip, so the midpoint
    estimate can be wrong by at most half of it.
    """

    __slots__ = ("offset", "rtt", "samples", "_clock")

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self.offset = 0.0
        self.rtt = float("inf")
        self.samples = 0

    def sample(self, probe, samples=5):
        """Run ``samples`` round trips; ``probe()`` must return the
        peer's clock reading.  Keeps the minimum-RTT sample (least
        queueing noise — the standard NTP filter).  Returns self."""
        if samples < 1:
            raise ValueError(f"samples must be >= 1, got {samples}")
        for _ in range(samples):
            t0 = self._clock()
            t_peer = probe()
            t1 = self._clock()
            rtt = max(t1 - t0, 0.0)
            if rtt <= self.rtt:
                self.rtt = rtt
                self.offset = t_peer - (t0 + t1) / 2.0
            self.samples += 1
        return self

    @property
    def uncertainty(self) -> float:
        """Worst-case |true offset - estimate|: RTT/2."""
        return self.rtt / 2.0 if math.isfinite(self.rtt) else float("inf")

    def to_local(self, t_peer):
        """Map a peer timestamp into the local clock."""
        return t_peer - self.offset

    def summary(self) -> dict:
        return {"offset_s": self.offset,
                "rtt_s": self.rtt if math.isfinite(self.rtt) else None,
                "uncertainty_s": (self.uncertainty
                                  if math.isfinite(self.rtt) else None),
                "samples": self.samples}


# ---------------------------------------------------------------------------
# registry dumps (the metric half of the telemetry wire schema)
# ---------------------------------------------------------------------------

def dump_registry(reg=None) -> dict:
    """Serialize a registry for the telemetry wire
    (:meth:`MetricsRegistry.dump`): name/kind/labels/help per metric,
    plus value (counter/gauge) or the full cumulative bucket ladder +
    running sum/count + exact nearest-rank quantiles (histogram).
    Shipping the BUCKETS — not the summary — is what lets the
    controller re-expose worker histograms as real TYPE-histogram
    families that ``histogram_quantile`` can aggregate across
    hosts."""
    if reg is None:
        reg = _registry()
    return reg.dump()


def merge_bucket_counts(dumps) -> list:
    """Element-wise sum of cumulative ``[le, count]`` ladders from the
    same histogram family on several hosts (they share
    ``DEFAULT_BUCKETS`` or the family's override, so the ladders
    align).  This IS ``sum(x_bucket) by (le)``."""
    merged = {}
    for b in dumps:
        for le, c in b:
            le = float(le)
            merged[le] = merged.get(le, 0) + c
    return sorted(merged.items())


def quantile_from_buckets(bucket_counts, q) -> float:
    """Prometheus ``histogram_quantile``: linear interpolation inside
    the bucket holding rank ``q * count``.  ``bucket_counts`` is the
    cumulative ``(le, count)`` ladder ending at ``+Inf``.  Returns the
    highest finite bound when the rank lands in the overflow bucket
    (Prometheus returns the same)."""
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"q must be in [0, 1], got {q}")
    bc = [(float(le), c) for le, c in bucket_counts]
    total = bc[-1][1]
    if total <= 0:
        return float("nan")
    rank = q * total
    prev_le, prev_c = 0.0, 0
    for le, c in bc:
        if c >= rank:
            if math.isinf(le):
                # rank in overflow: the best honest answer is the
                # highest finite bound (prometheus semantics)
                return prev_le if prev_c else float("nan")
            if c == prev_c:
                return le
            return prev_le + (le - prev_le) * (rank - prev_c) / (c - prev_c)
        prev_le, prev_c = le, c
    return bc[-2][0] if len(bc) > 1 else float("nan")


# ---------------------------------------------------------------------------
# the controller-side merge point
# ---------------------------------------------------------------------------

class _Host:
    """Last-known telemetry for one worker host."""

    def __init__(self, host, clock_sync=None, thread=None, pid=None):
        self.host = host
        self.clock = clock_sync          # ClockSync or None (thread mode)
        self.thread = thread             # worker thread name (thread mode)
        self.pid = pid
        self.stale = False
        self.stale_reason = None
        self.last_pull_t = None
        self.pulls = 0
        self.registry = None             # last dump_registry() payload
        self.entries = {}                # rid -> sealed ledger entry (raw)
        self.trace = []                  # drained trace records (raw)

    def offset(self) -> float:
        return self.clock.offset if self.clock is not None else 0.0


class FleetTelemetry:
    """Merge worker telemetry into one trace / exposition / why_slow.

    The fleet drives it: :meth:`host_online` on every supervisor spawn
    (with a fresh :class:`ClockSync`), :meth:`ingest` per successful
    pull, :meth:`mark_stale` per failed one, :meth:`remove_host` on
    retire/replace.  Reads are pure over last-known state and never
    touch the wire."""

    def __init__(self, clock=time.monotonic, fleet="fleet"):
        self._clock = clock
        self.fleet = fleet
        self.hosts = {}           # host id -> _Host, insertion-ordered

    # -- fleet-driven lifecycle ------------------------------------------
    def host_online(self, host, clock_sync=None, thread=None,
                    pid=None):
        """(Re)register a host: a fresh supervisor means fresh clock
        base and fresh series — any predecessor's state is dropped
        first (replace_dead must not freeze the dead process's
        series into the exposition)."""
        self.hosts.pop(host, None)
        self.hosts[host] = _Host(host, clock_sync, thread=thread,
                                 pid=pid)
        return self.hosts[host]

    def remove_host(self, host):
        """Retire-unregisters, across the boundary: the host's series
        leave the exposition and its trace/ledger buffers are
        dropped."""
        self.hosts.pop(host, None)

    def mark_stale(self, host, reason):
        """Telemetry loss (NOT serving loss): keep last-known data,
        flag it typed.  Never raises — a telemetry failure must never
        block serving."""
        h = self.hosts.get(host)
        if h is None:
            h = self.host_online(host)
        h.stale = True
        h.stale_reason = str(reason)

    def ingest(self, host, payload, t=None):
        """Merge one telemetry reply.  Idempotent: ledger entries are
        keyed by request id (latest seal wins), the registry dump
        replaces the previous one wholesale, and trace events carry
        the worker's drain cursor semantics (each event arrives
        exactly once).  A successful pull clears ``stale``."""
        h = self.hosts.get(host)
        if h is None:
            h = self.host_online(host)
        h.stale = False
        h.stale_reason = None
        h.last_pull_t = t if t is not None else self._clock()
        h.pulls += 1
        if payload.get("registry") is not None:
            h.registry = payload["registry"]
        for e in payload.get("ledger") or ():
            rid = e.get("request_id")
            if rid is None:
                continue
            prev = h.entries.get(rid)
            if prev is not None and _seal_key(prev) == _seal_key(e):
                continue  # same seal re-shipped: idempotent
            if prev is None or (_seal_key(e) >= _seal_key(prev)):
                h.entries[rid] = e
        for rec in payload.get("trace") or ():
            h.trace.append(rec)
        if payload.get("pid") is not None:
            h.pid = payload["pid"]
        return h

    # -- merged request timelines ----------------------------------------
    def merged_entries(self, local_entries=None) -> list:
        """One sealed-entry list for the whole fleet, in controller
        time.  Controller entries (the routing skeleton: hop chain,
        replica/host stamps, ship_s) are grafted with worker-side hop
        detail (admission, first token, steps, preemptions — shifted
        by each host's clock offset); worker-only requests ride along
        as-is.  Deep-copies everything: calling twice is idempotent
        and never mutates the live ledgers."""
        if local_entries is None:
            lg = _requests.ledger()
            local_entries = lg.entries() if lg is not None else []
        out = [copy.deepcopy(e) for e in local_entries]
        seen = set()
        for e in out:
            seen.add(e.get("request_id"))
            for hop in e.get("hops") or ():
                if hop.get("host") is None \
                        and hop.get("replica") is not None:
                    hop["host"] = f"w{hop['replica']}"
        by_rid = {e.get("request_id"): e for e in out}
        scratch = _requests.RequestLedger(capacity=1)
        for host, h in self.hosts.items():
            dt = -h.offset()
            for rid, we in h.entries.items():
                we = _shift_entry(copy.deepcopy(we), dt)
                for hop in we.get("hops") or ():
                    if hop.get("host") is None:
                        hop["host"] = host
                ce = by_rid.get(rid)
                if ce is None:
                    seen.add(rid)
                    by_rid[rid] = we
                    out.append(we)
                elif _graft_entry(ce, we, host):
                    try:
                        scratch._finalize(ce)
                    except Exception:
                        pass  # partial worker record: keep the graft
        out.sort(key=lambda e: e.get("t_submit") or 0.0)
        return out

    # -- fleet why_slow ---------------------------------------------------
    def why_slow(self, local_entries=None, top_k=5) -> dict:
        """The fleet-wide ``why_slow``: the per-process attribution
        (queue/prefill/hops + the exact ``ship`` carve-out) computed
        over MERGED entries, plus the all-seven-phase latency
        decomposition and the straggler host
        (:meth:`RequestLedger.why_slow` grew those fields alongside
        this module)."""
        entries = self.merged_entries(local_entries)
        lg = _requests.RequestLedger(capacity=max(len(entries), 1))
        lg._ring = entries
        ws = lg.why_slow(top_k=top_k)
        ws["hosts"] = len(self.hosts)
        ws["stale_hosts"] = sorted(
            h.host for h in self.hosts.values() if h.stale)
        return ws

    # -- federated exposition --------------------------------------------
    def prometheus_text(self) -> str:
        """One exposition for the fleet: every worker series re-emitted
        with a ``host=`` label, TYPE/HELP declared once per family,
        bucket ladders shipped verbatim (so ``x_bucket{le="+Inf"} ==
        x_count`` holds per host series and ``sum() by (le)``
        aggregates), plus federation meta-series: per-host staleness,
        clock offset/rtt, and pull age.  Stale hosts keep their
        last-known series (flagged); REMOVED hosts are simply gone."""
        from .export import _prom_labels, _prom_name, _prom_num
        families = {}   # name -> {"kind", "help", "samples": [...]}
        for host, h in self.hosts.items():
            if h.registry is None:
                continue
            for m in h.registry["metrics"]:
                fam = families.setdefault(m["name"], {
                    "kind": m["kind"], "help": m.get("help", ""),
                    "samples": []})
                labels = [tuple(kv) for kv in m["labels"]]
                labels.append(("host", host))
                # sorted label order makes the federated exposition
                # deterministic across hosts and pulls (diff-able)
                fam["samples"].append((sorted(labels), m))
        lines = []
        for name in sorted(families):
            fam = families[name]
            pname = _prom_name(name)
            decl = pname + "_total" if fam["kind"] == "counter" \
                else pname
            if fam["help"]:
                lines.append(f"# HELP {decl} {fam['help']}")
            lines.append(f"# TYPE {decl} {fam['kind']}")
            for labels, m in fam["samples"]:
                if fam["kind"] == "histogram":
                    for le, c in m["buckets"]:
                        lines.append(
                            pname + "_bucket"
                            + _prom_labels(sorted(
                                labels + [("le", _prom_num(le))]))
                            + " " + _prom_num(c))
                    lines.append(pname + "_sum" + _prom_labels(labels)
                                 + " " + _prom_num(m["sum"]))
                    lines.append(pname + "_count"
                                 + _prom_labels(labels)
                                 + " " + _prom_num(m["count"]))
                else:
                    suffix = ("_total" if fam["kind"] == "counter"
                              else "")
                    lines.append(pname + suffix + _prom_labels(labels)
                                 + " " + _prom_num(m["value"]))
            if fam["kind"] == "histogram":
                lines.append(f"# TYPE {pname}_quantile gauge")
                for labels, m in fam["samples"]:
                    for q in (0.5, 0.99):
                        lines.append(
                            pname + "_quantile"
                            + _prom_labels(sorted(
                                labels + [("quantile", q)]))
                            + " " + _prom_num(m.get(f"p{int(q*100)}",
                                                    float("nan"))))
        now = self._clock()
        lines.append("# HELP singa_tpu_federation_stale 1 while the "
                     "host's telemetry channel is lost (typed stale "
                     "marker; serving is unaffected)")
        lines.append("# TYPE singa_tpu_federation_stale gauge")
        for host, h in self.hosts.items():
            lines.append("singa_tpu_federation_stale"
                         + _prom_labels([("host", host)])
                         + " " + ("1" if h.stale else "0"))
        lines.append("# TYPE singa_tpu_federation_clock_offset_seconds"
                     " gauge")
        lines.append("# TYPE singa_tpu_federation_clock_rtt_seconds "
                     "gauge")
        lines.append("# TYPE singa_tpu_federation_pull_age_seconds "
                     "gauge")
        for host, h in self.hosts.items():
            lbl = _prom_labels([("host", host)])
            if h.clock is not None:
                lines.append("singa_tpu_federation_clock_offset_"
                             "seconds" + lbl + " "
                             + _prom_num(h.clock.offset))
                if math.isfinite(h.clock.rtt):
                    lines.append("singa_tpu_federation_clock_rtt_"
                                 "seconds" + lbl + " "
                                 + _prom_num(h.clock.rtt))
            if h.last_pull_t is not None:
                lines.append("singa_tpu_federation_pull_age_seconds"
                             + lbl + " "
                             + _prom_num(max(now - h.last_pull_t,
                                             0.0)))
        return "\n".join(lines) + "\n"

    def merged_histogram(self, name) -> dict:
        """Fleet-level view of one histogram family: per-host cumulative
        ladders summed by ``le`` (``sum(x_bucket) by (le)``), total
        count, and the aggregated p50/p99 via
        :func:`quantile_from_buckets` — the cross-host quantile the
        per-process nearest-rank numbers cannot give."""
        per_host, ladders, count = {}, [], 0
        for host, h in self.hosts.items():
            if h.registry is None:
                continue
            for m in h.registry["metrics"]:
                if m["name"] != name or m["kind"] != "histogram":
                    continue
                per_host.setdefault(host, 0)
                per_host[host] += m["count"]
                ladders.append(m["buckets"])
                count += m["count"]
        merged = merge_bucket_counts(ladders) if ladders else []
        return {
            "name": name,
            "count": count,
            "per_host_counts": per_host,
            "buckets": merged,
            "p50": (quantile_from_buckets(merged, 0.5)
                    if merged else None),
            "p99": (quantile_from_buckets(merged, 0.99)
                    if merged else None),
        }

    # -- merged Chrome trace ---------------------------------------------
    def chrome_trace(self, events=None, requests=None,
                     metadata=None) -> dict:
        """One Chrome-trace document for the whole fleet.

        pid 0 is the controller's subsystem tracks, pid 1 the merged
        per-request tracks (hop flow arrows included), and pids 10+
        one per HOST: worker trace events shifted into controller time
        by each host's clock offset (thread-mode worker events, which
        already share the controller clock, are routed to their host's
        pid by thread name instead).  Cross-host FLOW arrows (``ph:
        s``/``f`` pairs spanning two host pids) follow every KV ship
        and failover hop whose source and destination hosts differ —
        in Perfetto a disaggregated request reads as an arrow from the
        prefill host into the decode host."""
        from . import export as _export
        if events is None:
            events = _trace.events()
        if requests is None:
            requests = self.merged_entries()
        hosts = list(self.hosts)
        pid_of = {h: 10 + i for i, h in enumerate(hosts)}
        thread_host = {h.thread: h.host for h in self.hosts.values()
                       if h.thread}
        ctrl, per_host = [], {h: [] for h in hosts}
        for rec in events:
            hh = thread_host.get(rec.get("tid"))
            if hh is not None:
                per_host[hh].append((rec, 0.0))  # same process clock
            else:
                ctrl.append(rec)
        for host, h in self.hosts.items():
            dt = -h.offset()
            for rec in h.trace:
                per_host[host].append((rec, dt))
        doc = _export.chrome_trace(ctrl, metadata=metadata,
                                   requests=requests)
        ev = doc["traceEvents"]
        flows = 0
        for host in hosts:
            pid = pid_of[host]
            ev.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": f"host {host}"}})
            ev.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": "cross-host"}})
            cats = []
            for rec, _ in per_host[host]:
                if rec["cat"] not in cats:
                    cats.append(rec["cat"])
            tid_of = {c: i + 1 for i, c in enumerate(cats)}
            for c, tid in tid_of.items():
                ev.append({"name": "thread_name", "ph": "M",
                           "pid": pid, "tid": tid,
                           "args": {"name": c}})
            for rec, dt in per_host[host]:
                args = dict(rec["args"] or {})
                args["thread"] = rec["tid"]
                args["host"] = host
                e2 = {"name": rec["name"], "cat": rec["cat"],
                      "ph": rec["ph"], "pid": pid,
                      "tid": tid_of[rec["cat"]],
                      "ts": (rec["ts"] + dt) * 1e6, "args": args}
                if rec["ph"] == "X":
                    e2["dur"] = rec["dur"] * 1e6
                else:
                    e2["s"] = "t"
                ev.append(e2)
        # cross-host flow arrows: one s/f pair per hop boundary whose
        # source and destination hosts differ, drawn between the two
        # host pids (KV ships span their measured wire time)
        fid = 1 << 20  # disjoint from request_trace_events' flow ids
        for e in requests:
            hops = e.get("hops") or []
            for j in range(1, len(hops)):
                src = hops[j - 1].get("host")
                dst = hops[j].get("host")
                if src is None or dst is None or src == dst:
                    continue
                if src not in pid_of or dst not in pid_of:
                    continue
                via = hops[j].get("via") or "hop"
                t1 = hops[j]["t_submit"] * 1e6
                ship_s = hops[j].get("ship_s")
                t0 = t1 - (ship_s * 1e6 if via == "kv_ship" and ship_s
                           else 1.0)
                fid += 1
                args = {"request": e.get("request_id"), "via": via,
                        "src_host": src, "dst_host": dst}
                ev.append({"name": via, "cat": "fleet", "ph": "s",
                           "pid": pid_of[src], "tid": 0, "id": fid,
                           "ts": t0, "args": args})
                ev.append({"name": via, "cat": "fleet", "ph": "f",
                           "bp": "e", "pid": pid_of[dst], "tid": 0,
                           "id": fid, "ts": t1, "args": args})
                flows += 1
        doc["otherData"]["hosts"] = hosts
        doc["otherData"]["cross_host_flows"] = flows
        return doc

    def write_chrome_trace(self, path, events=None, requests=None,
                           metadata=None) -> int:
        doc = self.chrome_trace(events, requests, metadata)
        with open(path, "w") as f:
            json.dump(doc, f, default=str)
        return len(doc["traceEvents"])

    def write_request_log(self, path, local_entries=None) -> int:
        """Merged sealed entries as strict JSONL (the bench
        ``--request-log`` artifact, fleet-wide)."""
        from .export import json_sanitize
        n = 0
        with open(path, "w") as f:
            for e in self.merged_entries(local_entries):
                f.write(json.dumps(json_sanitize(e), default=str,
                                   allow_nan=False) + "\n")
                n += 1
        return n

    # -- health -----------------------------------------------------------
    def section(self, top_k=3) -> dict:
        """``health_report()["serve"]["dist"]``: per-host telemetry
        status (clock model, staleness, pull age) + the fleet-wide
        why_slow."""
        now = self._clock()
        hosts = {}
        for host, h in self.hosts.items():
            hosts[host] = {
                "stale": h.stale,
                "stale_reason": h.stale_reason,
                "pulls": h.pulls,
                "last_pull_age_s": (max(now - h.last_pull_t, 0.0)
                                    if h.last_pull_t is not None
                                    else None),
                "pid": h.pid,
                "clock": (h.clock.summary() if h.clock is not None
                          else None),
                "ledger_entries": len(h.entries),
                # per-host step anatomy from the shipped registry
                # dump (observe.stepprof on the worker): mean device
                # bubble + step count, None until the host ships
                # serve.step.* series — the straggler question
                # "which HOST's engine is host-bound" answered here
                "step_anatomy": _host_step_anatomy(h.registry),
            }
        return {
            "enabled": True,
            "fleet": self.fleet,
            "hosts": hosts,
            "stale_hosts": sorted(h for h, d in hosts.items()
                                  if d["stale"]),
            "why_slow": self.why_slow(top_k=top_k),
        }


def _host_step_anatomy(dump):
    """Mean device-bubble fraction + step count for one host, from
    its shipped registry dump (pure dict work — the worker's
    ``serve.step.{bubble_frac,wall_s}`` running sums/counts summed
    across its engine labels).  None until the host ships the
    families (profiler off, or no pull yet)."""
    if not dump:
        return None
    bub_sum = bub_n = steps = 0
    for m in dump.get("metrics", ()):
        if m.get("kind") != "histogram":
            continue
        if m["name"] == "serve.step.bubble_frac":
            bub_sum += m.get("sum", 0.0)
            bub_n += m.get("count", 0)
        elif m["name"] == "serve.step.wall_s":
            steps += m.get("count", 0)
    if bub_n == 0:
        return None
    return {"steps": steps, "bubble_frac": bub_sum / bub_n}


def _seal_key(e):
    """Order two seals of the same request id: later retire wins (a
    rejected-then-resurrected request's final seal replaces the
    interim one); equal keys mean the same seal re-shipped."""
    t = e.get("t_retire")
    return (0.0 if t is None else t, e.get("outcome") or "")


_SHIFT_HOP_TS = ("t_submit", "t_admit", "t_first_token")


def _shift_entry(e, dt):
    """Shift every absolute timestamp in a sealed entry by ``dt``
    seconds (worker clock -> controller clock; durations are
    invariant).  Mutates and returns ``e`` (callers pass a copy)."""
    for k in ("t_submit", "t_retire"):
        if e.get(k) is not None:
            e[k] += dt
    for hop in e.get("hops") or ():
        for k in _SHIFT_HOP_TS:
            if hop.get(k) is not None:
                hop[k] += dt
        for ch in hop.get("chunks") or ():
            ch[0] += dt
        for st in hop.get("steps") or ():
            st[0] += dt
        for pre in hop.get("preemptions") or ():
            if pre[0] is not None:
                pre[0] += dt
            if len(pre) > 1 and pre[1] is not None:
                pre[1] += dt
        if hop.get("reject") and hop["reject"].get("t") is not None:
            hop["reject"]["t"] += dt
    return e


_GRAFT_FIELDS = ("t_admit", "admit_kind", "hit_tokens", "slot",
                 "chunks", "t_first_token", "steps", "tokens",
                 "preemptions")


def _graft_entry(ce, we, host) -> bool:
    """Fill the controller entry's hop skeleton with the worker's
    engine-side detail (process mode: the controller mirror only has
    submit/retire).  Hops match by host — the worker's record can only
    describe work that ran THERE.  Returns True when anything landed
    (the caller re-finalizes ttft/phases)."""
    grafted = False
    whops = [h for h in we.get("hops") or ()]
    if not whops:
        return False
    wi = 0
    for hop in ce.get("hops") or ():
        if hop.get("host") != host:
            continue
        if wi >= len(whops):
            break
        wh = whops[wi]
        wi += 1
        for k in _GRAFT_FIELDS:
            v = wh.get(k)
            if v in (None, [], 0) or hop.get(k) not in (None, [], 0):
                continue
            hop[k] = v
            grafted = True
    if grafted and ce.get("tokens_out") in (None, 0):
        ce["tokens_out"] = we.get("tokens_out")
    return grafted


# ---------------------------------------------------------------------------
# module-global install point (health_report reads through here)
# ---------------------------------------------------------------------------

_active_ft = None


def install(ft):
    """Make ``ft`` the fleet telemetry ``health_report()`` reads (a
    DistFleet with federation on installs itself)."""
    global _active_ft
    _active_ft = ft
    return ft


def uninstall(ft=None):
    """Detach (``ft`` given: only if it is still the installed one —
    two fleets in one process must not uninstall each other)."""
    global _active_ft
    if ft is None or _active_ft is ft:
        _active_ft = None


def dist_section() -> dict:
    """``health_report()["serve"]["dist"]``: always a dict with an
    ``enabled`` key; live content while a federated DistFleet is
    installed."""
    if _active_ft is None:
        return {"enabled": False}
    try:
        return _active_ft.section()
    except Exception as e:  # telemetry must never fail a health read
        return {"enabled": True, "error": repr(e)}
