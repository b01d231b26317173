"""The port's serve-engine observability hooks against the JAX engine's:
the request ledger (``observe/requests.py``) fed by the port's engine,
scheduler and prefix cache, the SLO violation counters
(``InferenceEngine(slo=)``), and the step profiler's anatomy
(``observe/stepprof.py``) on the CPU, where its device fence is a no-op.

``GPT2Config.tiny``, block size 8, float32, on the CPU; the JAX weights
carried into the port by a ``save_states`` zip; one JAX reference run
per scenario (module-scoped).  Both engines run under one fake clock
that only the test advances (one unit a step, half a unit between
submissions), so every ledger timestamp is a function of the step at
which the event happened: with greedy streams token-identical, the
entries (hops, phases, outcomes, steps, chunks, preemption intervals,
branch ids) must be equal, not just alike.
"""

import json

import numpy as np
import pytest

import torch

from singa_tpu import device as jdevice
from singa_tpu import tensor as jtensor
from singa_tpu.models.gpt2 import GPT2Config as JGPT2Config
from singa_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from singa_tpu.observe import requests as jreqs
from singa_tpu.observe import stepprof as jstepprof
from singa_tpu.observe.health import SLO as JSLO
from singa_tpu.observe.registry import registry as jregistry
from singa_tpu.serve import GenerationRequest as JRequest
from singa_tpu.serve import PagedConfig as JPagedConfig
from singa_tpu.serve import PrefixCacheConfig as JPrefixConfig
from singa_tpu_torch import device, tensor
from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from singa_tpu_torch.observe import export, health_report
from singa_tpu_torch.observe import requests as reqs
from singa_tpu_torch.observe import stepprof
from singa_tpu_torch.observe.health import SLO
from singa_tpu_torch.observe.registry import registry
from singa_tpu_torch.serve import (GenerationRequest, PagedConfig,
                                   PrefixCacheConfig)

B = 8
CPU = device.create_cpu_device()

JAX = dict(request=JRequest, paged=JPagedConfig, prefix=JPrefixConfig,
           reqs=jreqs, slo=JSLO, registry=jregistry)
PORT = dict(request=GenerationRequest, paged=PagedConfig,
            prefix=PrefixCacheConfig, reqs=reqs, slo=SLO,
            registry=registry)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX model, port model holding its weights)."""
    jdevice.get_default_device().SetRandSeed(0)
    jm = JGPT2LMHead(JGPT2Config.tiny(dropout=0.0))
    jm.compile([jtensor.from_numpy(np.zeros((1, 16), np.int32))],
               is_train=False, use_graph=False)
    tm = GPT2LMHead(GPT2Config.tiny(dropout=0.0))
    tm.compile([tensor.from_numpy(np.zeros((1, 16), np.int32), CPU)],
               is_train=False)
    path = str(tmp_path_factory.mktemp("ledger") / "m.zip")
    jm.save_states(path)
    tm.load_states(path)
    return jm, tm


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _prompts(n, lo=3, step=5, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, lo + step * i).astype(np.int32)
            for i in range(n)]


SYSTEM = (np.arange(20, dtype=np.int32) * 7) % 256

SCENARIOS = {
    # five plain requests and a best-of-2 whose branch 1 is pruned
    "fork_prune": dict(engine=dict(max_slots=4), pool=32,
                       reqs=[dict(prompt=p, max_new_tokens=4 + i)
                             for i, p in enumerate(_prompts(5))]
                       + [dict(prompt=np.arange(6, dtype=np.int32) + 2,
                               max_new_tokens=10, n=2)],
                       prune=True),
    # a shared system prompt: warm admissions through chunk passes
    "prefix": dict(engine=dict(max_slots=2, prefix=True), pool=48,
                   reqs=[dict(prompt=np.concatenate([SYSTEM, p]),
                              max_new_tokens=3 + i % 3)
                         for i, p in enumerate(_prompts(5, 2, 3, 1))]),
    # a pool too small for both waves: priority preemption and resume
    "preempt": dict(engine=dict(max_slots=3, scheduler="priority"), pool=6,
                    reqs=[dict(prompt=p, max_new_tokens=20, priority=0)
                          for p in _prompts(2, 9, 2, 2)]
                    + [dict(prompt=p, max_new_tokens=10, priority=5,
                            after=3) for p in _prompts(2, 8, 3, 3)]),
    # the chunked-prefill token budget: admissions across steps
    "budget": dict(engine=dict(max_slots=3, budget=16), pool=40,
                   reqs=[dict(prompt=p, max_new_tokens=5)
                         for p in _prompts(4, 7, 11, 4)]),
}


def _serve(model, api, name, slo=None):
    """Run scenario ``name`` on ``model``'s engine with the ledger on;
    returns (entries by id, greedy tokens by id, slo violations)."""
    sc = SCENARIOS[name]
    kw = dict(sc["engine"])
    pkw = dict(block_size=B, num_blocks=sc["pool"])
    if kw.pop("budget", None):
        pkw["prefill_token_budget"] = 16
    if kw.pop("prefix", None):
        kw["prefix_cache"] = api["prefix"](block_size=B)
    clock = Clock()
    api["reqs"].enable(capacity=64)
    try:
        eng = model.serve(paged=api["paged"](**pkw), clock=clock,
                          slo=slo, **kw)
        handles, later = {}, []
        for i, r in enumerate(sc["reqs"]):
            r = dict(r)
            if r.pop("after", None):
                later.append((i, r))
                continue
            clock.t += 0.5
            handles[f"q{i}"] = eng.submit(api["request"](
                r.pop("prompt"), request_id=f"q{i}", temperature=0.0, **r))
        pruned = not sc.get("prune")
        step = 0
        while eng.pending or later:
            if step == 3:
                for i, r in later:
                    clock.t += 0.5
                    handles[f"q{i}"] = eng.submit(api["request"](
                        r.pop("prompt"), request_id=f"q{i}",
                        temperature=0.0, **r))
                later = []
            clock.t += 1.0
            eng.step()
            step += 1
            fh = handles.get("q5")
            if not pruned and len(getattr(fh, "branches", None) or ()) > 1 \
                    and not fh.branches[1].done():
                fh.branches[1].prune()
                pruned = True
            assert step < 400
        toks = {}
        for rid, h in handles.items():
            for b in getattr(h, "branches", None) or [h]:
                res = b.result()
                toks[res.request_id] = np.asarray(res.tokens).tolist()
        snap = eng.stats.snapshot()
        viol = (snap.get("slo") or {}).get("violations")
        entries = {e["request_id"]: e
                   for e in api["reqs"].ledger().entries()}
        eng.close()
    finally:
        api["reqs"].disable()
    return entries, toks, viol


@pytest.fixture(scope="module")
def jax_runs(pair):
    jm = pair[0]
    return {name: _serve(jm, JAX, name) for name in SCENARIOS}


def _canon(entries):
    """JSON form of the entries; the engine label (a per-process count,
    different in the two packages) dropped from each hop."""
    out = json.loads(json.dumps(export.json_sanitize(entries),
                                sort_keys=True))
    for e in out.values():
        for h in e["hops"]:
            h.pop("engine")
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_ledger_entries_equal_jax(pair, jax_runs, name):
    """Entries, hops, phases and outcomes of every request equal the JAX
    engine's on the same traffic and clock."""
    j_entries, j_toks, _ = jax_runs[name]
    p_entries, p_toks, _ = _serve(pair[1], PORT, name)
    assert p_toks == j_toks
    assert sorted(p_entries) == sorted(j_entries)
    assert _canon(p_entries) == _canon(j_entries)
    for e in p_entries.values():
        ph = e["phases"]
        assert ph is not None and abs(
            sum(ph.values()) - (e["t_retire"] - e["t_submit"])) < 1e-9
    if name == "preempt":
        assert any(h.get("preemptions") for e in p_entries.values()
                   for h in e["hops"])
    if name == "prefix":
        assert any(h["admit_kind"] == "warm" for e in p_entries.values()
                   for h in e["hops"])


def test_ledger_branch_hops_and_pruned_seal(pair):
    """``tests/test_fork.py::test_ledger_branch_hops_and_pruned_seal`` on
    the port's engine: the forked branch's hop carries ``branch == 1``,
    zero queue and prefill phases, and seals ``pruned``."""
    tm = pair[1]
    reqs.enable(capacity=64)
    try:
        prompt = (np.arange(6, dtype=np.int32) + 2)
        eng = tm.serve(max_slots=4, paged=PagedConfig(block_size=B,
                                                      num_blocks=32))
        fh = eng.submit(GenerationRequest(
            prompt, max_new_tokens=10, temperature=0.9, seed=4, n=2))
        for _ in range(4):
            eng.step()
        fh.branches[1].prune()
        eng.run_until_complete()
        led = reqs.ledger()
        parent = led.entry(fh.request_id)
        child = led.entry(f"{fh.request_id}#1")
        assert parent["outcome"] in ("length", "stop")
        assert parent["hops"][0]["branch"] is None
        assert child["outcome"] == "pruned"
        assert child["hops"][0]["branch"] == 1
        assert child["phases"]["queue"] == 0.0
        assert child["phases"]["prefill"] == 0.0
        eng.check_block_accounting()
        eng.close()
    finally:
        reqs.disable()


def test_slo_violation_counters_equal_jax(pair):
    """``slo=SLO(...)`` on both engines, same traffic and clock: the same
    ``serve.slo_violations{kind=}`` counts (TTFT and TPOT per retiring
    request, queue depth per scheduling pass)."""
    jm, tm = pair
    targets = dict(ttft_p99_s=2.0, tpot_p50_s=1.0, queue_depth_max=1)
    _, jt, jv = _serve(jm, JAX, "fork_prune", slo=JSLO(**targets))
    _, pt, pv = _serve(tm, PORT, "fork_prune", slo=SLO(**targets))
    assert pt == jt
    assert pv == jv
    assert pv["ttft"] > 0 and pv["queue"] > 0


def _anatomy(model, api, sp):
    clock = Clock()
    prof = sp.enable()
    try:
        eng = model.serve(max_slots=2, paged=api["paged"](
            block_size=B, num_blocks=32, prefill_token_budget=16),
            clock=clock)
        for i, p in enumerate(_prompts(4, 9, 4, 5)):
            eng.submit(api["request"](p, max_new_tokens=4, temperature=0.0))
        steps = 0
        while eng.pending:
            clock.t += 1.0
            eng.step()
            steps += 1
        lbl = eng.stats.engine_label
        sec = sp.section()["engines"][lbl]
        recs = [r for r in sp.records() if r["engine"] == lbl]
        eng.close()
        snap = registry().snapshot()
    finally:
        sp.disable()
    return steps, sec, recs, prof, snap


def test_stepprof_anatomy_on_cpu(pair):
    """Every step is one record whose host segments and device windows
    sum to its wall exactly (``other`` takes the unfenced time); the
    segment names are the JAX engine's on the same traffic; the device
    windows are those of the dispatches (the decode step, a prefill, a
    chunk pass), near zero here, where the fence waits for nothing; the
    closed engine's ``serve.step.*`` series are gone."""
    jm, tm = pair
    steps, sec, recs, prof, snap = _anatomy(tm, PORT, stepprof)
    j_steps, j_sec, j_recs, _, _ = _anatomy(jm, JAX, jstepprof)
    assert steps == j_steps == sec["steps"] == len(recs)
    for r in recs:
        assert abs(sum(r["segments"].values()) - r["wall_s"]) < 1e-9
        assert r["device_s"] == sum(d for _, d in r["device_windows"])
        assert 0.0 <= r["bubble_frac"] <= 1.0
    assert abs(sum(sec["fractions"].values()) - 1.0) < 1e-9
    assert set(sec["fractions"]) == set(j_sec["fractions"])
    assert sum(len(r["device_windows"]) for r in recs) >= steps
    assert not any(k.startswith("serve.step.") for k in snap["histograms"])


def test_health_report_and_request_log(pair, tmp_path):
    """``health_report()`` with the ledger and the profiler on: the
    serve section's why_slow and step_anatomy filled; the request log
    is strict JSONL, one entry a request."""
    tm = pair[1]
    reqs.enable(capacity=16)
    stepprof.enable()
    try:
        eng = tm.serve(max_slots=2, paged=PagedConfig(block_size=B,
                                                      num_blocks=32),
                       slo=SLO(ttft_p99_s=10.0))
        for p in _prompts(3):
            eng.submit(GenerationRequest(p, max_new_tokens=3))
        eng.run_until_complete()
        rep = health_report(engine_snapshots=[eng.stats.snapshot()])
        n = reqs.write_request_log(str(tmp_path / "r.jsonl"))
        eng.close()
    finally:
        stepprof.disable()
        reqs.disable()
    assert rep["serve"]["why_slow"]["enabled"] is True
    assert rep["serve"]["step_anatomy"]["enabled"] is True
    assert rep["serve"]["goodput_tokens_per_s"] > 0
    assert rep["serve"]["slo_violations"] == {"ttft": 0, "tpot": 0,
                                              "queue": 0}
    lines = (tmp_path / "r.jsonl").read_text().splitlines()
    assert n == len(lines) == 3
    assert all(json.loads(ln)["outcome"] == "length" for ln in lines)
