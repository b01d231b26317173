"""Per-request lifecycle ledger — tail-latency attribution for the
serve stack (the request-tracing round).

The span layer (``trace.py``) answers "where did this STEP's time go";
nothing answers "where did this REQUEST's time go".  When TTFT p99
blows an SLO on a fleet, the existing telemetry can say *that* it
regressed but not *which* requests were slow or *why* — queue wait
behind a burst, a cold prefill that a warm prefix hit would have
skipped, a speculative chunk whose acceptance collapsed, or a failover
hop that restarted the wait from zero.  This module records ONE
structured timeline per ``GenerationRequest.request_id``:

* **hops** — every engine submission is a hop.  The initial submit is
  hop 0; a supervisor restart's requeue, a fleet failover's requeue,
  and a hedge re-dispatch each append another.  The SAME entry follows
  the request across replicas (resurrection: a rejected-requeue-safe
  entry reopens when the request is resubmitted), so a
  failover-requeued request's ledger shows both replicas with the time
  burned on each.
* **events per hop** — submit, queue position at enqueue, admission
  (cold vs prefix-warm with the hit-token count), each warm prefill
  chunk, first token, each decode/spec step with accepted-token
  counts, and typed rejections (shed / deadline / queue-full / engine
  failure / abandon), fed by narrow hooks in ``serve/engine.py``,
  ``serve/scheduler.py``, ``serve/prefix.py``, ``serve/supervisor.py``
  and ``serve/fleet.py``.
* **phase attribution** — at retire the timeline is decomposed into
  ``hops`` (time burned on earlier hops before the final submission),
  ``ship`` (a disaggregated admission's KV transfer — the fleet
  stamps the final ``via=kv_ship`` hop with its measured ``ship_s``,
  carved OUT of ``hops`` so a slow interconnect reads "ship", not
  "hops"), ``queue`` (final-hop submit → admission), ``prefill``
  (admission → first token), ``decode`` (first token → retire, stall
  and preemption removed), ``stall`` (inter-token gaps far beyond the
  request's own median — the spec-verify / scheduler-starvation
  signature) and ``preempted`` (time the paged engine held the
  request swapped out to host; swap pauses are excluded from the
  stall detector's gaps so the two phases never double-count one
  pause).  ``hops + ship + queue + prefill`` sum to TTFT *exactly*
  and all seven sum to the request's total latency exactly —
  attribution is arithmetic over recorded timestamps, never an
  estimate.
* **bounded retention** — sealed (retired or terminally rejected)
  entries live in a ring of ``capacity`` entries (the FlightRecorder
  idiom: a forgotten ledger cannot OOM), exported as strict JSONL via
  :func:`write_request_log` and as per-request Chrome-trace tracks
  (``export.request_trace_events``, flow arrows linking hops).

Disabled-mode contract (the ``trace._active`` discipline): every hook
site reads ONE module flag (``requests._active``) and allocates
nothing when it is False.  The ledger is pure host bookkeeping — no
torch, nothing enters a captured step, so the serve engine captures
no graph after warm-up with the ledger on (``chip_smoke.py``'s
``observe`` phase and ``tests/test_torch_graphs.py`` pin it).

The one-call summary is :func:`why_slow_section` —
``health_report()["serve"]["why_slow"]`` decomposes the top-K slowest
requests and the TTFT/TPOT p99 population into phase components, so
"p99 regressed" becomes "p99 is 80% queue wait on replica 1".

Usage::

    from singa_tpu_torch.observe import requests as reqtrace
    reqtrace.enable(capacity=1024)
    ... serve traffic ...
    reqtrace.write_request_log("/tmp/requests.jsonl")
    print(reqtrace.why_slow_section()["ttft_p99_attribution"])
    reqtrace.disable()

The port's own copy of ``singa_tpu/observe/requests.py`` (it imports
nothing of the JAX package); the wire formats are the same.
"""

from __future__ import annotations

import json

from ..utils.metrics import percentile

__all__ = ["RequestLedger", "enable", "disable", "active", "ledger",
           "why_slow_section", "write_request_log",
           "set_host_namer"]

# Module-global fast path, mirroring trace._active: `if not
# requests._active: <skip>` is the ENTIRE disabled cost of a hook
# site.  _ledger is non-None exactly while _active is True.
_active = False
_ledger = None

#: outcomes that mean "completed normally" (engine finish reasons —
#: "pruned" is a fork branch cut on purpose, a sealed result, not a
#: rejection)
_COMPLETED = ("length", "stop", "pruned")

# replica index -> host id, installed by a DistFleet (observe.federate)
# so hop records carry WHERE a hop ran across the process boundary;
# None (the default) leaves hosts unset — in-process fleets group
# under "local" in the per-host attribution
_host_namer = None


def set_host_namer(fn):
    """Install (or clear, with None) the replica->host-id mapping the
    ledger stamps onto hops as ``replica`` annotations arrive.  The
    dist fleet owns this: ``w<idx>`` per worker peer."""
    global _host_namer
    _host_namer = fn


def enable(capacity=1024, record_steps=True) -> "RequestLedger":
    """Attach a fresh process-wide ledger and turn the hooks on.
    ``capacity`` bounds the sealed-entry ring; ``record_steps=False``
    keeps only per-hop token counts instead of per-step timestamps
    (cheaper, but disables stall attribution)."""
    global _active, _ledger
    _ledger = RequestLedger(capacity=capacity,
                            record_steps=record_steps)
    _active = True
    return _ledger


def disable():
    """Detach the ledger and turn the hooks off.  The previously
    returned ledger object stays readable (export after disable); new
    serve activity no longer reaches it."""
    global _active, _ledger
    _active = False
    _ledger = None


def active() -> bool:
    return _active


def ledger():
    """The live ledger, or None when tracing is off."""
    return _ledger


def why_slow_section(top_k=5) -> dict:
    """The ``health_report()["serve"]["why_slow"]`` section: always a
    dict with an ``enabled`` key, so dashboards and the CI gate can
    assert on it unconditionally."""
    if not _active or _ledger is None:
        return {"enabled": False}
    return _ledger.why_slow(top_k=top_k)


def write_request_log(path, ledger_=None) -> int:
    """Write the sealed-entry ring as strict JSONL (one request per
    line, ``json_sanitize``-d: nan/inf become null); returns the line
    count.  Defaults to the live ledger."""
    lg = ledger_ if ledger_ is not None else _ledger
    if lg is None:
        raise RuntimeError(
            "no request ledger: call requests.enable() first (or pass "
            "one explicitly)")
    n = 0
    with open(path, "w") as f:
        for line in lg.jsonl_lines():
            f.write(line + "\n")
            n += 1
    return n


def _final_hop(e):
    """The hop whose engine actually served the request: latest hop
    with a first token (a requeue's earlier hops never got one), else
    the latest hop (never-admitted rejections)."""
    for h in reversed(e["hops"]):
        if h.get("t_first_token") is not None:
            return h
    return e["hops"][-1]


def _new_hop(engine, t):
    return {
        "engine": engine,       # EngineStats.engine_label (unique)
        "replica": None,        # fleet replica index, when routed
        "host": None,           # host id, when served across the
        #                         process boundary (observe.federate)
        "via": "submit",        # submit|supervisor_restart|failover|
        #                         hedge|refused|prefill|kv_ship|
        #                         ship_fallback
        "t_submit": t,
        "queue_depth_at_enqueue": None,
        "t_admit": None,
        "admit_kind": None,     # cold | warm
        "hit_tokens": 0,
        "slot": None,
        "branch": None,         # fork branch index (serve/fork.py);
        #                         None outside a fork family
        "chunks": [],           # [t, offset] per warm prefill chunk
        "t_first_token": None,
        "steps": [],            # [t, tokens] or [t, tokens, acc, drafted]
        "tokens": 0,            # tokens emitted on THIS hop
        "preemptions": [],      # [t_swap_out, t_swap_in|None] pairs
        "reject": None,         # {"t", "reason", "started"} terminal
    }


class RequestLedger:
    """Hook sink + bounded store for per-request timelines.

    Single-writer by design (the serve loop is single-threaded; dict/
    list mutation is GIL-atomic for the read paths).  Every hook is
    no-throw for unknown request ids — a telemetry layer must never be
    able to fail a request it is describing."""

    def __init__(self, capacity=1024, record_steps=True):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.record_steps = bool(record_steps)
        self._open = {}            # rid -> entry (unresolved)
        self._ring = []            # sealed entries, oldest first
        self._sealed_by_rid = {}   # rid -> latest sealed entry
        self.dropped = 0           # sealed entries evicted by the cap

    # -- internals -------------------------------------------------------
    def _hop(self, rid, engine=None):
        """The hop engine-side events land on: the entry's latest hop
        whose engine label matches (hedged twins run concurrently on
        two engines), else the latest hop.  Falls back to the sealed
        entry so a step/retire racing a seal (a speculative chunk's
        trailing step record) still lands."""
        e = self._open.get(rid)
        if e is None:
            e = self._sealed_by_rid.get(rid)
        if e is None or not e["hops"]:
            return None, None
        if engine is not None:
            for h in reversed(e["hops"]):
                if h["engine"] == engine:
                    return e, h
        return e, e["hops"][-1]

    def _seal(self, e):
        rid = e["request_id"]
        self._open.pop(rid, None)
        self._ring.append(e)
        self._sealed_by_rid[rid] = e
        while len(self._ring) > self.capacity:
            old = self._ring.pop(0)
            self.dropped += 1
            if self._sealed_by_rid.get(old["request_id"]) is old:
                del self._sealed_by_rid[old["request_id"]]

    # -- hooks (serve layer) ---------------------------------------------
    def on_submit(self, rid, engine, t, prompt_len=None,
                  max_new_tokens=None):
        """An engine accepted a submission: start a hop.  A request id
        already open gets a concurrent hop (hedge); a sealed entry
        whose rejection was requeue-safe (``started is not True``) is
        RESURRECTED — the same timeline continues across supervisor
        restarts and fleet failovers.  A completed entry's id starts a
        fresh timeline (the engine allows id reuse after resolution)."""
        hop = _new_hop(engine, t)
        e = self._open.get(rid)
        if e is not None:
            e["hops"].append(hop)
            return
        e = self._sealed_by_rid.get(rid)
        if (e is not None and e["outcome"] == "rejected"
                and e.get("started") is not True):
            # requeue: reopen the SAME entry — hop continuity is the
            # point of the ledger
            try:
                self._ring.remove(e)
            except ValueError:
                pass
            del self._sealed_by_rid[rid]
            e["outcome"] = e["reason"] = None
            e["started"] = None
            e["t_retire"] = None
            e["ttft_s"] = e["tpot_s"] = None
            e["phases"] = None
            e.pop("final_hop", None)
            e["hops"].append(hop)
            self._open[rid] = e
            return
        self._open[rid] = {
            "request_id": rid,
            "prompt_len": prompt_len,
            "max_new_tokens": max_new_tokens,
            "t_submit": t,
            "t_retire": None,
            "outcome": None,       # length|stop|rejected
            "reason": None,
            "started": None,       # last rejection's started flag
            "tokens_out": 0,
            "ttft_s": None,
            "tpot_s": None,
            "phases": None,
            "hops": [hop],
        }

    def annotate_hop(self, rid, engine=None, **attrs):
        """Attach routing metadata to the latest hop (the fleet sets
        ``replica``/``via``, the scheduler the enqueue depth)."""
        _, hop = self._hop(rid, engine)
        if hop is not None:
            hop.update(attrs)
            if _host_namer is not None and hop.get("host") is None \
                    and hop.get("replica") is not None:
                hop["host"] = _host_namer(hop["replica"])

    def on_admit(self, rid, engine, t, slot=None, step=None,
                 branch=None):
        """Admission started: the request left the queue for a pool
        slot (cold/warm classification arrives from the prefix cache's
        hook; no cache means it stays the cold default).  ``branch``:
        the fork branch index for a branch spawned off a live sibling
        (serve/fork.py) — its hop has zero queue and prefill by
        construction, and the branch id keeps the family legible in
        why_slow rows."""
        _, hop = self._hop(rid, engine)
        if hop is not None:
            hop["t_admit"] = t
            hop["slot"] = slot
            if branch is not None:
                hop["branch"] = int(branch)
            if hop["admit_kind"] is None:
                hop["admit_kind"] = "cold"

    def on_prefix(self, rid, hit_tokens):
        """Prefix-cache admission accounting (PrefixCache.on_admit):
        the warm/cold verdict and how many prompt tokens came from
        cached blocks."""
        _, hop = self._hop(rid)
        if hop is not None:
            hop["admit_kind"] = "warm" if hit_tokens > 0 else "cold"
            hop["hit_tokens"] = int(hit_tokens)

    def on_prefill_chunk(self, rid, engine, t, offset):
        """One block-width warm prefill window finished."""
        _, hop = self._hop(rid, engine)
        if hop is not None:
            hop["chunks"].append([t, int(offset)])

    def on_first_token(self, rid, engine, t):
        _, hop = self._hop(rid, engine)
        if hop is not None:
            hop["t_first_token"] = t
            hop["tokens"] += 1

    def on_step(self, rid, engine, t, tokens, accepted=None,
                drafted=None):
        """One engine step's emissions for this request: ``tokens``
        actually emitted (1 on a plain engine; up to spec_k on a
        speculative one), with the chunk's accepted/drafted proposal
        counts when speculating."""
        _, hop = self._hop(rid, engine)
        if hop is None:
            return
        hop["tokens"] += int(tokens)
        if self.record_steps:
            rec = [t, int(tokens)]
            if accepted is not None:
                rec += [int(accepted), int(drafted)]
            hop["steps"].append(rec)

    def on_preempt(self, rid, engine, t):
        """The paged engine swapped this request's blocks to host
        mid-decode: open a preemption interval on the hop.  Time
        inside it is attributed to the ``preempted`` phase at seal
        (exact arithmetic — carved OUT of decode, and excluded from
        the stall detector's inter-step gaps so the two phases never
        double-count one pause)."""
        _, hop = self._hop(rid, engine)
        if hop is not None:
            hop.setdefault("preemptions", []).append([t, None])

    def on_resume(self, rid, engine, t):
        """The request's blocks were restored and decode continues:
        close the newest open preemption interval."""
        _, hop = self._hop(rid, engine)
        if hop is None:
            return
        for iv in reversed(hop.get("preemptions") or []):
            if iv[1] is None:
                iv[1] = t
                break

    def on_retire(self, rid, engine, t, finish_reason, tokens=None):
        """Normal completion: seal the entry with its phase
        attribution.  Idempotent against hedge losers — a second
        retire for an already-completed id only annotates the losing
        hop."""
        e, hop = self._hop(rid, engine)
        if e is None:
            return
        if e["outcome"] in _COMPLETED:
            if hop is not None:
                hop["duplicate_retire_t"] = t
            return
        e["outcome"] = finish_reason
        e["t_retire"] = t
        if tokens is not None:
            e["tokens_out"] = int(tokens)
        # the hop the retiring ENGINE matched is authoritative: on a
        # hedged request the last-by-position hop may be the losing
        # twin, whose timestamps must not define ttft/tpot
        self._finalize(e, final=(hop if hop is not None
                                 and hop.get("t_first_token")
                                 is not None else None))
        self._seal(e)

    def on_reject(self, rid, t, reason, engine=None, started=None,
                  prompt_len=None, max_new_tokens=None):
        """Typed rejection: record a terminal hop event and seal.
        ``started`` keeps the engine's re-runnability verdict — a
        later resubmission of a ``started is not True`` entry reopens
        it (requeue continuity).  Unknown ids get a minimal sealed
        entry (a request refused before any engine accepted it —
        SLO-pressure admission, fleet down — must still appear in the
        request log instead of vanishing)."""
        e, hop = self._hop(rid, engine)
        if e is None:
            hop = _new_hop(None, t)
            hop["via"] = "refused"
            e = {
                "request_id": rid, "prompt_len": prompt_len,
                "max_new_tokens": max_new_tokens, "t_submit": t,
                "t_retire": None, "outcome": None, "reason": None,
                "started": None, "tokens_out": 0, "ttft_s": None,
                "tpot_s": None, "phases": None, "hops": [hop],
            }
            self._open[rid] = e
        if hop is not None and hop["reject"] is None:
            hop["reject"] = {"t": t, "reason": reason,
                             "started": started}
        if e["outcome"] in _COMPLETED:
            return  # hedge loser rejected after the winner completed
        e["reason"] = reason if e["reason"] is None \
            else f'{e["reason"]}; {reason}'
        e["started"] = started if started is not None else e["started"]
        if e["outcome"] == "rejected":
            return  # already sealed; reason/event updated above
        e["outcome"] = "rejected"
        e["t_retire"] = t
        self._finalize(e)
        self._seal(e)

    # -- attribution -----------------------------------------------------
    @staticmethod
    def _phases(e, final=None) -> dict:
        """Decompose one entry into the phase components (module
        docstring).  Exact by construction: hops + ship + queue +
        prefill == TTFT and all seven sum to t_retire - t_submit
        (stall is carved OUT of decode and ship OUT of hops, never
        added on top)."""
        if final is None:
            final = _final_hop(e)
        end = e["t_retire"] if e["t_retire"] is not None \
            else final["t_submit"]
        hops_s = max(final["t_submit"] - e["t_submit"], 0.0)
        # a disaggregated admission's KV transfer: the fleet stamps
        # the via=kv_ship hop with its measured ship_s (export ->
        # validate -> scatter), which happened strictly BEFORE this
        # hop's submit — carve it out of the hops span so the sums
        # stay exact and a slow ship is named, not lumped into "hops"
        ship_s = min(float(final.get("ship_s") or 0.0), hops_s)
        hops_s -= ship_s
        t_admit = final.get("t_admit")
        t_first = final.get("t_first_token")
        if t_admit is not None:
            queue_s = max(t_admit - final["t_submit"], 0.0)
        else:
            # never admitted on the final hop (rejected in queue)
            queue_s = max(end - final["t_submit"], 0.0)
        prefill_s = (max(t_first - t_admit, 0.0)
                     if t_first is not None and t_admit is not None
                     else 0.0)
        decode_s = (max(end - t_first, 0.0)
                    if t_first is not None else 0.0)
        # preempted: time the paged engine held this request swapped
        # out (clipped to the decode span — preemption only exists
        # after the first token, since admission always emits one)
        ivs = []
        for t_out, t_in in final.get("preemptions") or []:
            t_in = end if t_in is None else t_in
            if t_first is not None:
                a, b = max(t_out, t_first), min(t_in, end)
                if b > a:
                    ivs.append((a, b))
        preempted_s = min(sum(b - a for a, b in ivs), decode_s)
        stall_s = 0.0
        steps = final.get("steps") or []
        ts = [s[0] for s in steps]

        def swapped_inside(a, b):
            return sum(max(0.0, min(b, ti) - max(a, to))
                       for to, ti in ivs)

        # inter-step gaps NET of preemption time inside them: a swap
        # pause is the preempted phase's, never double-counted as
        # stall
        gaps = [b - a - swapped_inside(a, b)
                for a, b in zip(ts, ts[1:])]
        if len(gaps) >= 3:
            med = sorted(gaps)[len(gaps) // 2]
            if med > 0:
                # a gap 3x the request's own median inter-step time is
                # a stall (scheduler starvation, a slow spec verify, a
                # straggler compile) — subtract the excess over the
                # median so phase sums stay exact
                stall_s = sum(g - med for g in gaps if g > 3 * med)
        stall_s = min(stall_s, decode_s - preempted_s)
        return {
            "hops": hops_s,
            "ship": ship_s,
            "queue": queue_s,
            "prefill": prefill_s,
            "decode": decode_s - stall_s - preempted_s,
            "stall": stall_s,
            "preempted": preempted_s,
        }

    def _finalize(self, e, final=None):
        """Compute the derived latency fields at seal time so every
        JSONL line is self-contained.  ``final``: the hop that
        actually served the request (on_retire passes the engine-
        matched hop — on a hedged request the last hop by position
        may be the losing twin); falls back to the latest hop with a
        first token."""
        if final is None:
            final = _final_hop(e)
        e["final_hop"] = e["hops"].index(final)
        if final.get("t_first_token") is not None:
            e["ttft_s"] = final["t_first_token"] - e["t_submit"]
            # tokens_out (the engine's count at retire) over the hop's
            # own tally: the final step's on_step record can land
            # AFTER retire seals the entry (the engine emits, retires,
            # then writes the step record), so the hop tally may lag
            # by the last step's tokens at this point
            n = e["tokens_out"] or final["tokens"]
            if (e["t_retire"] is not None and n > 1):
                e["tpot_s"] = ((e["t_retire"] - final["t_first_token"])
                               / (n - 1))
        e["phases"] = self._phases(e, final)

    # -- reads -----------------------------------------------------------
    def entries(self) -> list:
        """Snapshot copy of the sealed ring, oldest first."""
        return list(self._ring)

    def entry(self, rid):
        """The entry for ``rid`` — open, else latest sealed, else
        None."""
        return self._open.get(rid) or self._sealed_by_rid.get(rid)

    @property
    def open_count(self) -> int:
        return len(self._open)

    def jsonl_lines(self):
        """One strict-JSON line per sealed entry (nan/inf -> null, the
        same json_sanitize contract the benches use)."""
        from .export import json_sanitize
        for e in self._ring:
            yield json.dumps(json_sanitize(e), default=str,
                             allow_nan=False)

    @staticmethod
    def _replica_key(e) -> str:
        """Grouping key for per-replica attribution: the final hop's
        fleet replica index when routed, else its engine label.  Uses
        the seal-time ``final_hop`` verdict (the hop whose engine
        retired the request) when present."""
        idx = e.get("final_hop")
        final = (e["hops"][idx] if idx is not None
                 else _final_hop(e))
        if final.get("replica") is not None:
            return str(final["replica"])
        return f'engine:{final.get("engine")}'

    @staticmethod
    def _host_key(e) -> str:
        """Grouping key for per-host attribution: the final hop's host
        id when served across the process boundary (observe.federate
        stamps it), else "local" — an in-process fleet is one host."""
        idx = e.get("final_hop")
        final = (e["hops"][idx] if idx is not None
                 else _final_hop(e))
        return final.get("host") or "local"

    def why_slow(self, top_k=5) -> dict:
        """Tail-latency attribution over the sealed ring.

        ``ttft_p99_attribution``: for the requests at/above the TTFT
        p99 (nearest-rank — the actual slowest observed requests),
        each phase's share of their summed TTFT; the fractions sum to
        1.  ``per_replica`` splits the same population by where the
        request finally ran.  ``tpot_p99_attribution`` does the decode
        side: how much of the slow requests' decode span was stall.
        ``slowest`` is the per-request evidence: top-K by TTFT with
        full phase breakdowns and the hop chain."""
        completed = [e for e in self._ring
                     if e["outcome"] in _COMPLETED
                     and e["ttft_s"] is not None]
        rejected = sum(1 for e in self._ring
                       if e["outcome"] == "rejected")
        out = {
            "enabled": True,
            "requests_tracked": len(self._ring),
            "open_requests": len(self._open),
            "completed": len(completed),
            "rejected": rejected,
            "dropped": self.dropped,
            "ttft_p99_s": None,
            "ttft_p99_attribution": {},
            "latency_p99_attribution": {},
            "per_replica": {},
            "per_host": {},
            "straggler_host": None,
            "tpot_p99_s": None,
            "tpot_p99_attribution": {},
            "slowest": [],
        }
        if not completed:
            return out
        ttfts = [e["ttft_s"] for e in completed]
        p99 = percentile(ttfts, 99)
        out["ttft_p99_s"] = p99
        pop = [e for e in completed if e["ttft_s"] >= p99]
        total = sum(e["ttft_s"] for e in pop)
        sums = {"queue": 0.0, "prefill": 0.0, "hops": 0.0,
                "ship": 0.0}
        # the full end-to-end decomposition over the same population:
        # all SEVEN phases sum to t_retire - t_submit per entry
        # (_phases is exact by construction), so these fractions sum
        # to 1 — the fleet-level "where did the whole latency go"
        lat_total = sum(e["t_retire"] - e["t_submit"] for e in pop)
        lat_sums = {"queue": 0.0, "prefill": 0.0, "ship": 0.0,
                    "decode": 0.0, "stall": 0.0, "preempted": 0.0,
                    "hops": 0.0}
        per_rep, per_host = {}, {}
        for e in pop:
            ph = e["phases"] or self._phases(e)
            for k in sums:
                sums[k] += ph.get(k, 0.0)
            for k in lat_sums:
                lat_sums[k] += ph.get(k, 0.0)
            rep = per_rep.setdefault(self._replica_key(e), {
                "requests": 0, "ttft_s": 0.0, "queue": 0.0,
                "prefill": 0.0, "hops": 0.0, "ship": 0.0})
            rep["requests"] += 1
            rep["ttft_s"] += e["ttft_s"]
            for k in ("queue", "prefill", "hops", "ship"):
                rep[k] += ph.get(k, 0.0)
            hst = per_host.setdefault(self._host_key(e), {
                "requests": 0, "ttft_s": 0.0, "total_s": 0.0})
            hst["requests"] += 1
            hst["ttft_s"] += e["ttft_s"]
            hst["total_s"] += e["t_retire"] - e["t_submit"]
        out["ttft_p99_attribution"] = {
            k: {"s": v, "frac": (v / total if total > 0 else 0.0)}
            for k, v in sums.items()}
        out["latency_p99_attribution"] = {
            k: {"s": v,
                "frac": (v / lat_total if lat_total > 0 else 0.0)}
            for k, v in lat_sums.items()}
        out["per_replica"] = per_rep
        out["per_host"] = per_host
        # the straggler: the host contributing the most tail TTFT —
        # same max-by idiom as health's step-time straggler
        worst = max(per_host, key=lambda h: per_host[h]["ttft_s"])
        out["straggler_host"] = {
            "host": worst, "ttft_s": per_host[worst]["ttft_s"],
            "requests": per_host[worst]["requests"]}
        tpots = [e["tpot_s"] for e in completed
                 if e["tpot_s"] is not None]
        if tpots:
            tp99 = percentile(tpots, 99)
            out["tpot_p99_s"] = tp99
            dpop = [e for e in completed
                    if e["tpot_s"] is not None and e["tpot_s"] >= tp99]
            dec = sum((e["phases"] or {}).get("decode", 0.0)
                      for e in dpop)
            stall = sum((e["phases"] or {}).get("stall", 0.0)
                        for e in dpop)
            pre = sum((e["phases"] or {}).get("preempted", 0.0)
                      for e in dpop)
            dt = dec + stall + pre
            out["tpot_p99_attribution"] = {
                "decode": {"s": dec,
                           "frac": dec / dt if dt > 0 else 0.0},
                "stall": {"s": stall,
                          "frac": stall / dt if dt > 0 else 0.0},
                # the paged engine's swap time: a slow request that
                # spent its tail preempted reads "preempted", not
                # "decode got slow"
                "preempted": {"s": pre,
                              "frac": pre / dt if dt > 0 else 0.0},
            }
        for e in sorted(completed, key=lambda e: -e["ttft_s"])[:top_k]:
            ph = e["phases"] or self._phases(e)
            out["slowest"].append({
                "request_id": e["request_id"],
                "ttft_s": e["ttft_s"],
                "total_s": (e["t_retire"] - e["t_submit"]
                            if e["t_retire"] is not None else None),
                "tokens_out": e["tokens_out"],
                "phases": ph,
                "dominant_phase": max(ph, key=ph.get),
                "hops": [{"engine": h.get("engine"),
                          "replica": h.get("replica"),
                          "host": h.get("host"),
                          "via": h.get("via"),
                          "branch": h.get("branch")}
                         for h in e["hops"]],
            })
        return out

    def snapshot(self) -> dict:
        """Small JSON-able status block (health/debugging)."""
        return {
            "capacity": self.capacity,
            "sealed": len(self._ring),
            "open": len(self._open),
            "dropped": self.dropped,
        }
