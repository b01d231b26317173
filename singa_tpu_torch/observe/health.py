"""Health-report schema: declarative serve SLOs and the one-call
:func:`health_report` summary over the whole ``observe`` layer.

Two exports:

* :class:`SLO` — declarative serving targets (``ttft_p99_s``,
  ``tpot_p50_s``, ``queue_depth_max``).  Hand one to
  ``model.serve(slo=...)`` (or ``EngineStats`` directly) and every
  retire is checked against it: a request beyond a target increments
  ``serve.slo_violations{engine=,kind=}`` and emits a trace instant;
  a scheduling pass beyond ``queue_depth_max`` emits a
  ``serve/queue_pressure`` event and a ``kind=queue`` violation.
  Checking per retire (not per scrape) means the counters are exact —
  no violation hides between two polls.
* :func:`health_report` — one JSON-able dict answering "is this
  process healthy and how close to hardware peak does it run":
  host/process info, train steps + MFU accounting
  (``monitor.MfuMeter``), per-process step-time summaries with the
  named straggler, serve goodput + SLO violation counts, watchdog
  hang/anomaly state, flight-recorder status, and the full registry
  snapshot.  ``bench.py`` / ``bench_serve.py`` embed it under their
  reports' ``health`` key and write it standalone via ``--health-out``.

Schema stability: like ``EngineStats.snapshot()``, the report is
extended by ADDING keys, never renaming — ``tests/test_monitor.py``
asserts the section set and CI parses the bench-emitted file.

The port's own copy of ``singa_tpu/observe/health.py`` (it imports
nothing of the JAX package); the wire formats are the same.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

from . import federate as _federate
from . import monitor as _monitor
from . import requests as _requests
from . import slo as _slo
from . import stepprof as _stepprof
from . import trace as _trace
from .registry import SCHEMA_ROOT, registry as _registry

__all__ = ["SLO", "health_report"]


@dataclass(frozen=True)
class SLO:
    """Serving service-level objectives; ``None`` disables a check.

    ``ttft_p99_s``/``tpot_p50_s`` are named for the dashboard line
    they guard, but they are enforced per REQUEST at retire time (a
    per-request bound is strictly stronger than the percentile it
    protects, and it is exact under any traffic shape).
    """

    ttft_p99_s: float | None = None
    tpot_p50_s: float | None = None
    queue_depth_max: int | None = None

    def asdict(self) -> dict:
        return asdict(self)


def _slo_violations(snap_counters: dict) -> dict:
    """Aggregate ``serve.slo_violations{engine=..,kind=..}`` counters
    across engines into ``{kind: total}``."""
    out = {"ttft": 0, "tpot": 0, "queue": 0}
    for key, v in snap_counters.items():
        if not key.startswith("serve.slo_violations"):
            continue
        for kind in out:
            if f"kind={kind}" in key:
                out[kind] += v
    return out


def _by_label(snap_counters: dict, name: str, label: str) -> dict:
    """Aggregate ``name{...,label=v,...}`` counters into ``{v: total}``
    (pure string work over the registry snapshot — no import of the
    resilience layer, which sits above observe)."""
    out = {}
    prefix = name + "{"
    for key, v in snap_counters.items():
        if not (key == name or key.startswith(prefix)):
            continue
        val = "_"
        if "{" in key:
            for part in key[key.index("{") + 1:-1].split(","):
                k, _, lv = part.partition("=")
                if k == label:
                    val = lv
        out[val] = out.get(val, 0) + v
    return out


def _sum_metric(snap: dict, name: str):
    """Sum a metric across its label sets (``name`` + ``name{...}``)."""
    prefix = name + "{"
    return sum(v for k, v in snap.items()
               if k == name or k.startswith(prefix))


def _prefix_section(snap: dict) -> dict:
    """The ``serve.prefix`` health section: radix prefix-cache
    counters summed across engines (zeros when no engine ever ran a
    cache — always present so dashboards can alert unconditionally).
    ``hit_rate_tokens`` is hit_tokens / lookup_tokens, the fraction
    of admitted prompt tokens served from cached blocks."""
    counters, gauges = snap["counters"], snap["gauges"]
    hit = _sum_metric(counters, "serve.prefix.hit_tokens")
    lookup = _sum_metric(counters, "serve.prefix.lookup_tokens")
    return {
        "hits": _sum_metric(counters, "serve.prefix.hits"),
        "misses": _sum_metric(counters, "serve.prefix.misses"),
        "evictions": _sum_metric(counters, "serve.prefix.evictions"),
        "hit_tokens": hit,
        "lookup_tokens": lookup,
        "hit_rate_tokens": (hit / lookup) if lookup else 0.0,
        "cached_blocks": _sum_metric(gauges,
                                     "serve.prefix.cached_blocks"),
    }


def _paged_section(snap: dict) -> dict:
    """The ``serve.paged`` health section: block-pool accounting and
    preemption/swap counters summed across engines (zeros when no
    paged engine ever ran — always present so dashboards can alert
    unconditionally).  ``blocks_used``/``blocks_free`` are gauges (the
    CURRENT pool state, last-written engine set included); the
    counters are lifetime totals."""
    counters, gauges = snap["counters"], snap["gauges"]
    return {
        "blocks_free": _sum_metric(gauges, "serve.paged.blocks_free"),
        "blocks_used": _sum_metric(gauges, "serve.paged.blocks_used"),
        "preemptions": _sum_metric(counters,
                                   "serve.paged.preemptions"),
        "swap_out": _sum_metric(counters, "serve.paged.swap_out"),
        "swap_in": _sum_metric(counters, "serve.paged.swap_in"),
    }


def _spec_section(snap: dict) -> dict:
    """The ``serve.spec`` health section: speculative-decoding
    acceptance counters summed across engines (zeros when no engine
    ever ran a draft — always present so dashboards can alert
    unconditionally).  ``acceptance_rate`` is accepted / drafted, the
    realized fraction of draft proposals the target verify kept — the
    number that decides whether speculation is still paying on live
    traffic."""
    counters = snap["counters"]
    acc = _sum_metric(counters, "serve.spec.accepted")
    drafted = _sum_metric(counters, "serve.spec.drafted")
    return {
        "accepted": acc,
        "drafted": drafted,
        "acceptance_rate": (acc / drafted) if drafted else 0.0,
    }


def _tp_section(snap: dict) -> dict:
    """The ``serve.tp`` health section: tensor-parallel serving
    (serve/tp.py) — shard width, per-shard KV bytes, and sharded
    dispatch counts (zeros when no TP engine ever ran — always
    present so dashboards can alert unconditionally).  ``shards`` is
    the WIDEST live engine's mesh (gauges max, not sum: two tp=2
    replicas are not a tp=4 engine); bytes/dispatches sum across
    engines."""
    counters, gauges = snap["counters"], snap["gauges"]
    prefix = "serve.tp.shards{"
    widths = [v for k, v in gauges.items()
              if k == "serve.tp.shards" or k.startswith(prefix)]
    return {
        "shards": max(widths) if widths else 0,
        "kv_bytes_per_shard": _sum_metric(
            gauges, "serve.tp.kv_bytes_per_shard"),
        "collectives_per_step": _sum_metric(
            gauges, "serve.tp.collectives_per_step"),
        "sharded_dispatches": _sum_metric(
            counters, "serve.tp.sharded_dispatches"),
    }


def _ep_section(snap: dict) -> dict:
    """The ``serve.ep`` health section: expert-parallel MoE serving
    (serve/ep.py) — expert shard width, per-expert routed-token load,
    dropped assignments, and a max/mean load-imbalance ratio (an
    imbalanced router is the MoE why_slow: collapsed routing shows up
    here before it shows up as expert-shard latency).  Zeros when no
    EP engine ever ran — always present so dashboards can alert
    unconditionally.  ``shards`` is the widest live engine's expert
    mesh (max, like the tp section); token/drop counters sum across
    engines, and expert_tokens sums per expert INDEX across engines
    (same-geometry replicas add up; the imbalance ratio is computed
    over the summed loads)."""
    counters, gauges = snap["counters"], snap["gauges"]
    widths = [v for k, v in gauges.items()
              if k == "serve.ep.shards"
              or k.startswith("serve.ep.shards{")]
    per_expert: dict = {}
    for k, v in counters.items():
        if k == "serve.ep.expert_tokens" \
                or k.startswith("serve.ep.expert_tokens{"):
            e = "0"
            if "expert=" in k:
                e = k.split("expert=")[1].split("}")[0].split(",")[0]
            per_expert[e] = per_expert.get(e, 0) + v
    loads = [per_expert[k] for k in sorted(per_expert, key=int)] \
        if per_expert else []
    total = sum(loads)
    imb = (max(loads) / (total / len(loads))
           if total and loads else None)
    return {
        "shards": max(widths) if widths else 0,
        "kv_bytes_per_shard": _sum_metric(
            gauges, "serve.ep.kv_bytes_per_shard"),
        "sharded_dispatches": _sum_metric(
            counters, "serve.ep.sharded_dispatches"),
        "expert_tokens": loads,
        "dropped_tokens": _sum_metric(
            counters, "serve.ep.dropped_tokens"),
        "load_imbalance": imb,
    }


def _pp_section(snap: dict) -> dict:
    """The ``serve.pp`` health section: pipeline-parallel serving
    (serve/pp.py) — stage depth, microbatch width, per-stage KV
    bytes, and stage-boundary hop counts (zeros when no PP engine
    ever ran — always present so dashboards can alert
    unconditionally).  ``stages`` is the deepest live engine's
    pipeline (max); bytes/dispatches/hops sum across engines."""
    counters, gauges = snap["counters"], snap["gauges"]
    depths = [v for k, v in gauges.items()
              if k == "serve.pp.stages"
              or k.startswith("serve.pp.stages{")]
    mbs = [v for k, v in gauges.items()
           if k == "serve.pp.microbatches"
           or k.startswith("serve.pp.microbatches{")]
    return {
        "stages": max(depths) if depths else 0,
        "microbatches": max(mbs) if mbs else 0,
        "kv_bytes_per_stage": _sum_metric(
            gauges, "serve.pp.kv_bytes_per_stage"),
        "sharded_dispatches": _sum_metric(
            counters, "serve.pp.sharded_dispatches"),
        "boundary_hops": _sum_metric(
            counters, "serve.pp.boundary_hops"),
    }


def _fleet_section(snap: dict) -> dict:
    """The ``serve.fleet`` health section: replicated-serve routing and
    failover counters summed across fleets (zeros when no fleet ever
    ran — always present so dashboards can alert unconditionally).
    ``routed`` is per replica index, summed across fleets."""
    counters, gauges = snap["counters"], snap["gauges"]
    return {
        "replicas_healthy": _sum_metric(
            gauges, "serve.fleet.replicas_healthy"),
        # add-only (autoscale round): healthy minus draining/retired —
        # the set the router admits NEW work to
        "replicas_routable": _sum_metric(
            gauges, "serve.fleet.replicas_routable"),
        "failovers": _sum_metric(counters, "serve.fleet.failovers"),
        "requeues": _sum_metric(counters, "serve.fleet.requeues"),
        "hedges": _sum_metric(counters, "serve.fleet.hedges"),
        "routed": _by_label(counters, "serve.fleet.routed", "replica"),
        # disaggregated serving (the disagg round): completed KV
        # ships, their host bytes, fleet-index warm hits, and
        # cold-but-correct fallbacks
        "ships": _sum_metric(counters, "serve.fleet.ships"),
        "ship_bytes": _sum_metric(counters, "serve.fleet.ship_bytes"),
        "shared_prefix_hits": _sum_metric(
            counters, "serve.fleet.shared_prefix_hits"),
        "ship_fallbacks": _sum_metric(
            counters, "serve.fleet.ship_fallbacks"),
    }


def _resilience_section(snap_counters: dict) -> dict:
    """The ``resilience`` health section: retry/fallback/restart
    counts published by singa_tpu_torch.resilience (zeros when the layer
    never armed — the section is always present so dashboards can
    alert on it unconditionally)."""
    return {
        "retries": _by_label(snap_counters, "resilience.retries",
                             "site"),
        "gave_up": _by_label(snap_counters, "resilience.gave_up",
                             "site"),
        "faults_injected": _by_label(
            snap_counters, "resilience.faults_injected", "site"),
        "checkpoint_saves": snap_counters.get(
            "resilience.checkpoint_saves", 0),
        "checkpoint_fallbacks": snap_counters.get(
            "resilience.checkpoint_fallbacks", 0),
        "checkpoint_async_failures": snap_counters.get(
            "checkpoint.async_failures", 0),
        "engine_failures": snap_counters.get(
            "resilience.engine_failures", 0),
        "engine_restarts": snap_counters.get(
            "resilience.engine_restarts", 0),
        # fleet restart accounting: service-level recovery actions on
        # top of the per-engine restarts above
        "fleet_failovers": _sum_metric(snap_counters,
                                       "serve.fleet.failovers"),
        "fleet_requeues": _sum_metric(snap_counters,
                                      "serve.fleet.requeues"),
        "shed_requests": _by_label(snap_counters,
                                   "serve.shed_requests", "reason"),
    }


def _windowed_section(reg) -> dict:
    """The top-level ``windowed`` section: every windowed family's
    per-window aggregates (observe.timeseries).  Always present;
    ``{"enabled": False}`` until the first
    ``registry.windowed(name, ...)`` registration — the same
    unconditional-assert shape as ``why_slow``."""
    fams = reg.windowed_families()
    if not fams:
        return {"enabled": False}
    return {"enabled": True,
            "families": {name: fams[name].section()
                         for name in sorted(fams)}}


def _autoscale_section(snap: dict) -> dict:
    """The ``serve.autoscale`` health section, derived from the
    ``serve.autoscale.*`` registry family (pure string work, like
    every serve section — observe never imports the serve layer).
    ``{"enabled": False}`` until an Autoscaler registers its gauges."""
    counters, gauges = snap["counters"], snap["gauges"]
    enabled = any(k == "serve.autoscale.replicas"
                  or k.startswith("serve.autoscale.replicas{")
                  for k in gauges)
    if not enabled:
        return {"enabled": False}
    return {
        "enabled": True,
        "replicas": _sum_metric(gauges, "serve.autoscale.replicas"),
        "min_replicas": _sum_metric(gauges,
                                    "serve.autoscale.min_replicas"),
        "max_replicas": _sum_metric(gauges,
                                    "serve.autoscale.max_replicas"),
        "draining": _sum_metric(gauges, "serve.autoscale.draining"),
        "scale_ups": _sum_metric(counters,
                                 "serve.autoscale.scale_ups"),
        "scale_downs": _sum_metric(counters,
                                   "serve.autoscale.scale_downs"),
        "decisions_failed": _sum_metric(
            counters, "serve.autoscale.decisions_failed"),
    }


def _step_time_sections(snap_hists: dict) -> dict:
    """Per-source step-time summaries keyed
    ``{source: {process: summary}}``, plus the named straggler (the
    process with the largest mean) per source — the multi-host "who is
    slow" answer."""
    out = {}
    for key, summ in snap_hists.items():
        if ".step_time{" not in key:
            continue
        source = key.split(".step_time{", 1)[0]
        proc = "0"
        for part in key[key.index("{") + 1:-1].split(","):
            k, _, v = part.partition("=")
            if k == "process":
                proc = v
        out.setdefault(source, {"per_process": {}})[
            "per_process"][proc] = summ
    for source, sec in out.items():
        procs = {p: s for p, s in sec["per_process"].items()
                 if s.get("count")}
        if procs:
            worst = max(procs, key=lambda p: procs[p]["mean"])
            sec["straggler"] = {"process": worst,
                                "mean_s": procs[worst]["mean"]}
        else:
            sec["straggler"] = None
    return out


def _why_slow_with_anatomy() -> dict:
    """The request ledger's why_slow section with the step profiler's
    host-vs-device verdict riding along.  The ledger decomposes WHICH
    requests are slow and in which lifecycle phase; the anatomy rider
    says whether the ENGINE's steps are host-bound or device-bound
    while they were — the two answers compose (a decode-phase p99
    regression plus ``culprit: "host"`` points at the step loop, not
    the model).  The rider only appears when ``stepprof`` is live AND
    has sealed at least one step, so the section's shape is unchanged
    for existing consumers when the profiler is off."""
    section = _requests.why_slow_section()
    if _stepprof._active:
        anatomy = _stepprof.why_slow_summary()
        if anatomy is not None:
            section = dict(section)
            section["step_anatomy"] = anatomy
    return section


def health_report(reg=None, engine_snapshots=(),
                  include_registry=True) -> dict:
    """Build the unified health dict.  ``engine_snapshots``: optional
    ``EngineStats.snapshot()`` dicts to embed under ``serve.engines``
    (goodput/uptime per engine); the registry-derived sections
    (violation counters, step-time summaries) need no arguments.
    ``include_registry=False`` omits the full registry snapshot — for
    callers (the benches) that already embed the snapshot elsewhere in
    the same document and should not duplicate it."""
    reg = reg if reg is not None else _registry()
    snap = reg.snapshot()
    wd = _monitor.watchdog()
    mfu = _monitor.mfu_meter()
    rec = _monitor.flight_recorder()
    engine_snapshots = list(engine_snapshots)

    train_steps = snap["counters"].get("train.steps", 0)
    # read(), not sample(): the report must not reset the meter's
    # rate window under the watchdog poll thread's feet
    mfu_sample = mfu.read() if mfu is not None else None
    report = {
        "schema": f"{SCHEMA_ROOT}.health/1",
        "host": _monitor._process_info(),
        "train": {
            "steps": train_steps,
            "mfu": mfu_sample["mfu"] if mfu_sample else float("nan"),
            "model_flops_per_s": (mfu_sample["model_flops_per_s"]
                                  if mfu_sample else float("nan")),
            "step_flops": (mfu_sample["step_flops"] if mfu_sample
                           else _monitor.step_flops()),
            "peak_flops_per_s": (mfu_sample["peak_flops_per_s"]
                                 if mfu_sample
                                 else _monitor.peak_flops()),
            "mfu_denominator": "bf16_peak",
        },
        "step_time": _step_time_sections(snap["histograms"]),
        "serve": {
            "engines": engine_snapshots,
            # summed across engines (they serve concurrently, so the
            # process-level rate is the sum) — same scope as the
            # cross-engine slo_violations totals next to it
            "goodput_tokens_per_s": (
                sum(s["throughput"]["goodput_tokens_per_s"]
                    for s in engine_snapshots)
                if engine_snapshots else None),
            "slo_violations": _slo_violations(snap["counters"]),
            "prefix": _prefix_section(snap),
            "paged": _paged_section(snap),
            "spec": _spec_section(snap),
            "tp": _tp_section(snap),
            "ep": _ep_section(snap),
            "pp": _pp_section(snap),
            "fleet": _fleet_section(snap),
            # tail-latency attribution from the request ledger
            # (observe.requests): always present; {"enabled": False}
            # until requests.enable() is called.  When live it
            # decomposes the TTFT/TPOT p99 population and the top-K
            # slowest requests into queue/prefill/decode/stall/hop
            # phase components — the "WHY did p99 regress" answer
            "why_slow": _why_slow_with_anatomy(),
            # per-step host/device decomposition (observe.stepprof):
            # always present; {"enabled": False} until
            # stepprof.enable().  When live it carries per-engine
            # segment fractions (summing to 1 — exact arithmetic over
            # one denominator, the ledger's seal-time idiom) and the
            # device-bubble fraction ROADMAP item 5 is measured by
            "step_anatomy": _stepprof.section(),
            # cross-host federation (observe.federate): always
            # present; {"enabled": False} until a federated DistFleet
            # installs its FleetTelemetry.  When live it carries
            # per-host clock/staleness status and the FLEET-wide
            # why_slow (worker hop detail merged in controller time,
            # straggler host named)
            "dist": _federate.dist_section(),
            # multi-window burn-rate alerting (observe.slo): always
            # present; {"enabled": False} until an SLOPolicy installs
            "slo_alerts": _slo.alerts_section(),
            # signal-driven fleet autoscaling (serve/autoscale.py):
            # always present; {"enabled": False} until an Autoscaler
            # registers — derived from the serve.autoscale.* family
            "autoscale": _autoscale_section(snap),
        },
        # windowed telemetry (observe.timeseries): rate/quantile over
        # the last N seconds next to the all-time registry truth —
        # always present, {"enabled": False} until the first
        # registry.windowed() registration
        "windowed": _windowed_section(reg),
        "resilience": _resilience_section(snap["counters"]),
        "watchdog": (
            {"active": True, **wd.summary()} if wd is not None
            else {"active": False, "hangs": 0, "sources": {}}),
        "flight_recorder": {
            "active": rec.active,
            "events": len(rec),
            "capacity": rec.capacity,
            "trace_dropped": _trace.dropped(),
        },
    }
    if include_registry:
        report["registry"] = snap
    return report
