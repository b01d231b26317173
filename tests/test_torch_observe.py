"""The port's host-side observability modules (``singa_tpu_torch/
observe/``: ``registry``, ``trace``, ``timeseries``, ``slo``,
``federate``, ``export``, the ledger and step-profiler units) against
the JAX package's ``singa_tpu/observe/``.

Each test drives one scripted sequence of metric writes, spans, ledger
hooks and clock readings through both packages under the same injected
clock, and compares what comes out exactly: registry dumps and
snapshots, Prometheus text (the ``build_info`` line, which names each
package's framework, and the uptime line, a wall clock, left out),
trace records, JSONL, Chrome-trace JSON, windowed rates and quantiles,
burn-rate alert states and their callbacks, the federation's merged
exposition and histograms, ledger entries and ``why_slow``.  The
modules are plain host code, so nothing here needs a device.
"""

import importlib
import json
import math

import pytest


def _mods(root):
    names = ("registry", "trace", "timeseries", "slo", "federate", "export",
             "requests", "stepprof", "health", "monitor")
    return {n: importlib.import_module(f"{root}.observe.{n}") for n in names}


PKGS = {"jax": "singa_tpu", "port": "singa_tpu_torch"}


@pytest.fixture(scope="module")
def mods():
    return {k: _mods(v) for k, v in PKGS.items()}


class Clock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def _both(mods, fn):
    """``fn`` run on each package's modules; (jax result, port result)."""
    return fn(mods["jax"]), fn(mods["port"])


def _prom(text):
    return [ln for ln in text.splitlines()
            if "build_info" not in ln and "process_uptime" not in ln]


def _fill(m, clock):
    """One scripted registry: counters, gauges, histograms on default and
    custom ladders, label sets, a windowed family."""
    reg = m["registry"].MetricsRegistry()
    wf = reg.windowed("serve.completed", windows=(10.0, 60.0), clock=clock,
                      capacity=64)
    for i in range(40):
        clock.t += 0.5
        reg.counter("serve.completed", help="done", engine="0").inc()
        if i % 3 == 0:
            reg.counter("serve.completed", help="done", engine="1").inc(2)
        reg.gauge("serve.queue_depth", help="q", engine="0").set(i % 7)
        reg.histogram("serve.ttft", help="ttft", engine="0").observe(
            0.0007 * (i + 1) ** 1.5)
        reg.histogram("serve.step.bubble_frac", help="b",
                      buckets=(0.1, 0.5, 0.9, 1.0),
                      engine="0").observe((i % 10) / 10)
    reg.gauge("serve.occupancy", engine="0").inc(3).dec(1)
    return reg, wf


def test_registry_dump_snapshot_and_windows_equal(mods):
    def run(m):
        clock = Clock()
        reg, wf = _fill(m, clock)
        out = {"dump": reg.dump(), "snap": reg.snapshot(),
               "rate10": wf.rate(10.0), "rate60": wf.rate(60.0),
               "sel": wf.rate(60.0, match={"engine": "1"}),
               "section": wf.section(),
               "buckets": reg.histogram("serve.ttft",
                                        engine="0").bucket_counts(),
               "kinds": [x.KIND for x in reg.metrics()]}
        with pytest.raises(TypeError):
            reg.gauge("serve.completed", engine="2")
        with pytest.raises(ValueError):
            reg.histogram("x.bad", buckets=(1.0, 0.5))
        reg.remove(reg.counter("serve.completed", engine="1"))
        out["after_remove"] = reg.snapshot()
        reg.unwindow("serve.completed")
        out["families"] = sorted(reg.windowed_families())
        return json.dumps(m["export"].json_sanitize(out), sort_keys=True)

    j, p = _both(mods, run)
    assert j == p


def test_prometheus_text_equal(mods):
    def run(m):
        clock = Clock()
        reg, _ = _fill(m, clock)
        return _prom(m["export"].prometheus_text(reg))

    j, p = _both(mods, run)
    assert j == p
    assert any(ln.startswith('singa_tpu_serve_ttft_bucket{engine="0",le=')
               for ln in p)
    assert any("_rate_10s" in ln for ln in p)


def _trace_script(m, clock):
    tr = m["trace"]
    tr.clear()
    tr.enable(clock=clock)
    try:
        with tr.span("train/step", cat="train", step=0) as sp:
            clock.t += 0.25
            with tr.span("opt/update", cat="train"):
                clock.t += 0.125
            sp.set(loss=1.5)
            tr.event("cache/miss", cat="train", key="k0")
        clock.t += 1.0

        @tr.traced(name="serve/prefill", cat="serve")
        def prefill(n):
            clock.t += 0.0625 * n
            return n

        prefill(3)
        tr.traced(lambda: None)()
        tr.set_max_events(6)
        for i in range(4):
            tr.event("serve/admit", cat="serve", i=i)
            clock.t += 0.01
        events, dropped = tr.events(), tr.dropped()
    finally:
        tr.set_max_events(1_000_000)
        tr.disable()
    tr.clear()
    return events, dropped


def test_trace_records_jsonl_and_chrome_trace_equal(mods):
    def run(m):
        events, dropped = _trace_script(m, Clock())
        ex = m["export"]
        chrome = ex.chrome_trace(events, metadata={"run": "t"})
        return {"events": events, "dropped": dropped,
                "jsonl": list(ex.jsonl_lines(events)),
                "chrome": json.dumps(chrome, sort_keys=True)}

    j, p = _both(mods, run)
    # the lambda's qualified name is its test module's, the same in both
    assert j == p
    assert p["dropped"] == 3 and len(p["events"]) == 6
    assert mods["port"]["trace"].span("x") is \
        mods["port"]["trace"].span("y")  # the shared disabled span


def _ledger_script(m, clock):
    """A ledger fed by hand: a queued, cold, chunked, preempted and
    resumed request, a warm one, a requeued one (supervisor hop), a shed
    one and a refused one."""
    led = m["requests"].RequestLedger(capacity=16)
    t = clock
    led.on_submit("a", engine="0", t=t(), prompt_len=40, max_new_tokens=4)
    led.annotate_hop("a", queue_depth_at_enqueue=0)
    led.on_submit("b", engine="0", t=t() + 0.5, prompt_len=9,
                  max_new_tokens=3)
    clock.t += 1.0
    led.on_admit("a", engine="0", t=t(), slot=0, step=1)
    led.on_prefix("a", hit_tokens=0)
    for off in (0, 8, 16, 24, 32):
        clock.t += 0.2
        led.on_prefill_chunk("a", engine="0", t=t(), offset=off)
    led.on_first_token("a", engine="0", t=t())
    led.on_admit("b", engine="0", t=t(), slot=1, step=2)
    led.on_prefix("b", hit_tokens=8)
    clock.t += 0.1
    led.on_first_token("b", engine="0", t=t())
    for k in range(3):
        clock.t += 0.05 if k < 2 else 2.0
        led.on_step("a", engine="0", t=t(), tokens=1)
        led.on_step("b", engine="0", t=t(), tokens=2, accepted=1,
                    drafted=3)
    led.on_preempt("a", engine="0", t=t())
    clock.t += 0.75
    led.on_resume("a", engine="0", t=t())
    led.on_retire("b", engine="0", t=t(), finish_reason="length",
                  tokens=7)
    clock.t += 0.05
    led.on_step("a", engine="0", t=t(), tokens=1)
    led.on_retire("a", engine="0", t=t(), finish_reason="stop", tokens=4)
    led.on_submit("c", engine="0", t=t(), prompt_len=5, max_new_tokens=2)
    led.on_reject("c", t=t() + 1, reason="engine_failed", engine="0",
                  started=False)
    led.on_submit("c", engine="1", t=t() + 2, prompt_len=5,
                  max_new_tokens=2)
    led.annotate_hop("c", via="supervisor_restart", restart=1)
    led.on_admit("c", engine="1", t=t() + 3, slot=0, step=0)
    led.on_first_token("c", engine="1", t=t() + 3.5)
    led.on_step("c", engine="1", t=t() + 3.75, tokens=1)
    led.on_retire("c", engine="1", t=t() + 3.75, finish_reason="length",
                  tokens=2)
    led.on_submit("d", engine="1", t=t() + 4, prompt_len=5,
                  max_new_tokens=2)
    led.on_reject("d", t=t() + 5, reason="shed:slo_pressure",
                  engine="1", started=False)
    led.on_reject("e", t=t() + 6, reason="shed:slo_admission",
                  started=False, prompt_len=3, max_new_tokens=1)
    return led


def test_ledger_entries_why_slow_and_request_trace_equal(mods):
    def run(m):
        led = _ledger_script(m, Clock())
        ex = m["export"]
        return json.dumps(ex.json_sanitize({
            "entries": led.entries(), "why": led.why_slow(top_k=3),
            "snap": led.snapshot(), "jsonl": list(led.jsonl_lines()),
            "tracks": ex.request_trace_events(led.entries())}),
            sort_keys=True)

    j, p = _both(mods, run)
    assert j == p
    e = {x["request_id"]: x for x in json.loads(p)["entries"]}
    assert e["c"]["outcome"] == "length" and len(e["c"]["hops"]) == 2
    assert e["d"]["outcome"] == "rejected"
    ph = e["a"]["phases"]
    # the phases sum to the request's latency exactly
    assert math.isclose(sum(ph.values()),
                        e["a"]["t_retire"] - e["a"]["t_submit"])


def _stepprof_script(m, clock):
    sp = m["stepprof"]
    reg = m["registry"].MetricsRegistry()
    prof = sp.enable(clock=clock, ring=8, reg=reg)
    try:
        for step in range(3):
            sp.begin("7", step)
            clock.t += 0.001
            sp.push("emit")
            clock.t += 0.002
            sp.push("ledger")
            clock.t += 0.0005
            sp.pop()
            sp.pop()
            sp.push("schedule")
            clock.t += 0.003 * (step + 1)
            sp.pop()
            sp.end()
        out = {"section": sp.section(), "records": sp.records(),
               "culprit": sp.culprit("serve.e7"),
               "snap": reg.snapshot(), "steps": prof.steps}
        sp.forget_engine("7")
        out["after_forget"] = reg.snapshot()
    finally:
        sp.disable()
    return out


def test_stepprof_anatomy_and_step_tracks_equal(mods):
    def run(m):
        out = _stepprof_script(m, Clock())
        out["tracks"] = m["export"].step_trace_events(out["records"])
        return json.dumps(m["export"].json_sanitize(out), sort_keys=True)

    j, p = _both(mods, run)
    assert j == p
    sec = json.loads(p)["section"]["engines"]["7"]
    assert sec["steps"] == 3
    assert math.isclose(sum(sec["fractions"].values()), 1.0)


def test_chrome_trace_with_request_and_step_tracks_equal(mods):
    def run(m):
        clock = Clock()
        events, _ = _trace_script(m, clock)
        led = _ledger_script(m, clock)
        steps = _stepprof_script(m, clock)["records"]
        doc = m["export"].chrome_trace(events, requests=led.entries(),
                                       steps=steps)
        return json.dumps(doc, sort_keys=True)

    j, p = _both(mods, run)
    assert j == p
    doc = json.loads(p)
    assert {e["pid"] for e in doc["traceEvents"]} >= {0, 1, 2}


@pytest.mark.parametrize("kind", ["counter", "event", "level"])
def test_window_ring_rates_and_quantiles_equal(mods, kind):
    def run(m):
        clock = Clock(0.0)
        r = m["timeseries"].WindowRing(kind=kind, capacity=16, clock=clock,
                                       baseline=2.0)
        out = []
        v = 2.0
        for i in range(30):
            clock.t += 0.7
            v += (i % 4) if kind == "counter" else 0
            r.append(v if kind == "counter" else (i * 37) % 11)
            if i % 5 == 4:
                out.append([r.rate(5.0), r.rate(60.0), len(r),
                            r.values(5.0)])
                if kind != "counter":
                    out[-1] += [r.mean(5.0), r.quantile(0.9, 60.0)]
        return json.dumps(m["export"].json_sanitize(out))

    j, p = _both(mods, run)
    assert j == p


def test_slo_burn_rate_alerts_fire_and_clear_equal(mods):
    """A policy over an injected clock: a violation burst fires the page
    rule (both windows past the threshold), a clean stretch clears it
    (hysteresis), with the same callbacks, sections and counters."""
    def run(m):
        clock = Clock(0.0)
        reg = m["registry"].MetricsRegistry()
        SLO = m["health"].SLO
        calls = []
        rules = (m["slo"].BurnRule("page", long_s=60.0, short_s=10.0,
                                   threshold=5.0),
                 m["slo"].BurnRule("ticket", long_s=300.0, short_s=60.0,
                                   threshold=2.0, clear_ratio=0.5))
        pol = m["slo"].SLOPolicy(
            SLO(ttft_p99_s=0.5), budget_frac=0.05, rules=rules, reg=reg,
            clock=clock, on_alert=lambda n, f, i: calls.append([n, f]),
            install=False)
        done = reg.counter("serve.completed", engine="0")
        bad = reg.counter("serve.slo_violations", engine="0", kind="ttft")
        sections = []
        for sec in range(240):
            clock.t += 1.0
            done.inc(4)
            if 30 <= sec < 90:
                bad.inc(2)
            if sec % 10 == 9:
                sections.append(pol.poll())
        out = {"sections": sections, "calls": calls,
               "firing": pol.firing(), "snap": reg.snapshot()}
        pol.close()
        return json.dumps(m["export"].json_sanitize(out), sort_keys=True)

    j, p = _both(mods, run)
    assert j == p
    calls = json.loads(p)["calls"]
    assert ["page", True] in calls and ["page", False] in calls


def test_federation_merge_equal(mods):
    """Two worker hosts' registry dumps, ledger entries and trace records
    merged by ``FleetTelemetry`` (clock offsets from ``ClockSync`` over a
    scripted probe): the merged exposition, histograms, entries,
    why_slow, Chrome trace and section equal; ``quantile_from_buckets``
    is Prometheus's ``histogram_quantile``."""
    def run(m):
        fed, ex = m["federate"], m["export"]
        clock = Clock(50.0)
        ft = fed.FleetTelemetry(clock=clock, fleet="f")
        payloads = []
        for h in range(2):
            wc = Clock(1000.0 * (h + 1))
            reg, _ = _fill(m, wc)
            events, _ = _trace_script(m, wc)
            led = _ledger_script(m, wc)
            payloads.append({"registry": fed.dump_registry(reg),
                             "ledger": led.entries(), "trace": events,
                             "pid": 10 + h})
        for h, pay in enumerate(payloads):
            peer = Clock(1000.0 * (h + 1))

            def probe(peer=peer):
                clock.t += 0.001
                peer.t += 0.002
                return peer.t

            cs = fed.ClockSync(clock=clock).sample(probe, samples=3)
            ft.host_online(f"w{h}", clock_sync=cs, pid=10 + h)
            ft.ingest(f"w{h}", pay)
            ft.ingest(f"w{h}", pay)  # idempotent
        ft.mark_stale("w1", "timeout")
        lad = payloads[0]["registry"]["metrics"]
        hist = next(x for x in lad if x["name"] == "serve.ttft")
        out = {
            "prom": _prom(ft.prometheus_text()),
            "hist": ft.merged_histogram("serve.ttft"),
            "entries": ft.merged_entries(local_entries=[]),
            "why": ft.why_slow(local_entries=[]),
            "trace": ft.chrome_trace(events=[], requests=None),
            "section": ft.section(),
            "q": [fed.quantile_from_buckets(hist["buckets"], q)
                  for q in (0.0, 0.5, 0.9, 0.99, 1.0)],
            "merged": fed.merge_bucket_counts(
                [hist["buckets"], hist["buckets"]]),
        }
        return json.dumps(ex.json_sanitize(out), sort_keys=True)

    j, p = _both(mods, run)
    assert j == p


def test_json_sanitize_and_health_shape_equal(mods):
    def run(m):
        ex = m["export"]
        obj = {"a": float("nan"), "b": [float("inf"), -float("inf"), 1.5],
               "c": {"d": (1, 2)}, "e": None}
        reg = m["registry"].MetricsRegistry()
        rep = m["health"].health_report(reg=reg, include_registry=True)
        shape = {k: sorted(v) if isinstance(v, dict) else type(v).__name__
                 for k, v in rep.items() if k not in ("host",)}
        return ex.json_sanitize(obj), shape, \
            sorted(rep["serve"]), m["health"].SLO(1.0, 0.1, 4).asdict()

    j, p = _both(mods, run)
    assert j == p
