"""The port's in-process serve fleet (``singa_tpu_torch/serve/fleet.py``)
against the JAX fleet: the cases of ``tests/test_fleet.py`` on the port,
and one JAX fleet run held token for token against the port's on the same
requests, greedy and seeded-sampled (both packages key a request's noise
``split(PRNGKey(seed), 1)[0]``, so a requeued, hedged or rerouted request
re-derives the same chain).

``GPT2Config.tiny`` (vocabulary 256), float32, on the CPU, one intra-op
thread; the JAX weights carried into the port by a ``save_states`` zip.
The port's oracle is its own single-prompt ``generate`` (held against the
JAX package's elsewhere); the fleet cases use greedy and sampled requests
alike.  Fleets of sharded replicas are ``test_torch_dist_sharded_fleet.py``'s.
"""

import numpy as np
import pytest

import torch

from singa_tpu import device as jdevice
from singa_tpu import tensor as jtensor
from singa_tpu.models.gpt2 import GPT2Config as JGPT2Config
from singa_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from singa_tpu.serve import GenerationRequest as JRequest
from singa_tpu_torch import device, tensor
from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from singa_tpu_torch.observe.health import SLO, health_report
from singa_tpu_torch.observe.registry import registry
from singa_tpu_torch.resilience import FailAfterN, FailOnce, faults
from singa_tpu_torch.serve import (EngineFailedError, FleetDownError,
                                   GenerationRequest, LoadShedError,
                                   PrefixCacheConfig, Router, ServeFleet)

CPU = device.create_cpu_device()
TEMP = 0.8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def make_pair(tmp_path_factory, name):
    """(JAX tiny GPT-2, the port's holding its weights)."""
    jdevice.get_default_device().SetRandSeed(0)
    jm = JGPT2LMHead(JGPT2Config.tiny(dropout=0.0))
    jm.compile([jtensor.from_numpy(np.zeros((1, 16), np.int32))],
               is_train=False, use_graph=False)
    path = str(tmp_path_factory.mktemp(name) / "m.zip")
    jm.save_states(path)
    m = GPT2LMHead(GPT2Config.tiny(dropout=0.0))
    m.compile([tensor.from_numpy(np.zeros((1, 16), np.int32), CPU)],
              is_train=False)
    m.load_states(path)
    return jm, m


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return make_pair(tmp_path_factory, "fleet")


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


def workload(n, seed=0, lo=3, hi=10, new_lo=2, new_hi=7):
    """``n`` (prompt, max_new_tokens, temperature, seed): every other
    request sampled at ``TEMP`` with a seed of its own."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        p = rng.randint(0, 256, rng.randint(lo, hi)).astype(np.int32)
        out.append((p, int(rng.randint(new_lo, new_hi)),
                    TEMP if i % 2 else 0.0, int(rng.randint(0, 2 ** 31 - 1))))
    return out


def request(w, pkg=GenerationRequest, **kw):
    p, n, t, s = w
    return pkg(p, max_new_tokens=n, temperature=t, seed=s, **kw)


def oracle(m, work):
    """Each request's single-prompt ``generate``: the engine's key chain
    at its seed."""
    return [np.asarray(m.generate(p, max_new_tokens=n, temperature=t,
                                  seed=[s]))
            for p, n, t, s in work]


def counter(name, **labels):
    snap = registry().snapshot()["counters"]
    key = name
    if labels:
        key += "{" + ",".join(f"{k}={v}"
                              for k, v in sorted(labels.items())) + "}"
    return snap.get(key, 0)


# ------------------------------------------------------ against the JAX fleet


def test_streams_match_the_jax_fleet(pair):
    """The same 8 requests (half sampled) through a 2-replica fleet of
    each package: every stream equal, and equal to the port's
    ``generate``."""
    jm, m = pair
    work = workload(8, seed=11)
    jf = jm.serve_fleet(replicas=2, max_slots=2)
    jhs = [jf.submit(request(w, JRequest)) for w in work]
    jf.run_until_complete(max_steps=500)
    want = [np.asarray(h.result().tokens) for h in jhs]
    jf.close()
    with m.serve_fleet(replicas=2, max_slots=2) as fleet:
        hs = [fleet.submit(request(w)) for w in work]
        fleet.run_until_complete(max_steps=500)
        for h, w, o in zip(hs, want, oracle(m, work)):
            np.testing.assert_array_equal(h.result().tokens, w)
            np.testing.assert_array_equal(w, o)


# ------------------------------------------------------------------ routing


def test_fleet_balances_and_streams_match_oracle(model):
    work = workload(8, seed=0)
    base = oracle(model, work)
    with model.serve_fleet(replicas=2, max_slots=2) as fleet:
        hs = [fleet.submit(request(w)) for w in work]
        fleet.run_until_complete(max_steps=500)
        for h, want in zip(hs, base):
            np.testing.assert_array_equal(h.result().tokens, want)
        snap = fleet.snapshot()
        assert snap["replicas"] == 2 and snap["replicas_healthy"] == 2
        assert snap["failovers"] == 0
        assert snap["routed"]["0"] > 0 and snap["routed"]["1"] > 0
        assert snap["routed"]["0"] + snap["routed"]["1"] == len(work)


def test_router_scores_pressure_and_tpot():
    r = Router()
    views = [
        {"replica": 0, "queue_depth": 0, "occupancy": 0.0,
         "tpot_ewma": 0.3, "queue_headroom": 4},
        {"replica": 1, "queue_depth": 0, "occupancy": 0.0,
         "tpot_ewma": 0.1, "queue_headroom": 4},
    ]
    assert r.rank(views)[0] == 1
    views[1]["queue_depth"] = 5
    assert r.rank(views)[0] == 0
    views[0]["queue_headroom"] = 0
    assert r.rank(views)[0] == 1
    assert r.rank([]) == []


def test_sticky_session_stays_replica_local(model):
    p = (np.arange(40) % 256).astype(np.int32)
    cachecfg = PrefixCacheConfig(block_size=8, num_blocks=32)
    with model.serve_fleet(replicas=2, max_slots=2,
                           prefix_cache=cachecfg) as fleet:
        h = fleet.submit(GenerationRequest(p, max_new_tokens=4,
                                           pin_session=True))
        fleet.run_until_complete(max_steps=300)
        sess = h.result().session
        assert sess is not None
        idx = fleet._sessions[sess]
        eng = fleet.supervisor(idx).engine
        hits0 = eng.prefix_cache._c_hits.value
        extra = [fleet.submit(request(w)) for w in workload(2, seed=3)]
        req2 = sess.request(np.asarray([7, 8, 9], np.int32),
                            max_new_tokens=3, temperature=TEMP, seed=5)
        assert req2.session_of is sess
        h2 = fleet.submit(req2)
        fleet.run_until_complete(max_steps=300)
        want = model.generate(req2.prompt_ids, max_new_tokens=3,
                              temperature=TEMP, seed=[5])
        np.testing.assert_array_equal(h2.result().tokens, want)
        assert eng.prefix_cache._c_hits.value > hits0
        for e in extra:
            e.result()
        sess.release()


# ----------------------------------------------------------------- failover


def test_failover_requeues_never_started_with_parity(model):
    """A replica dying past its restart budget mid-decode: started
    requests fail typed, never-started ones (sampled ones too) requeue
    onto the survivor with the uninterrupted streams."""
    work = workload(8, seed=1, new_lo=3)
    base = oracle(model, work)
    fleet = model.serve_fleet(replicas=2, max_slots=1, restart_budget=0)
    hs = [fleet.submit(request(w)) for w in work]
    pol = faults.inject("serve.decode_step", FailAfterN(2, times=1))
    fleet.run_until_complete(max_steps=1000)
    faults.clear()
    assert pol.fired == 1
    completed = typed = 0
    for h, want in zip(hs, base):
        assert h.done(), "wedged handle after failover"
        try:
            np.testing.assert_array_equal(h.result().tokens, want)
            completed += 1
        except EngineFailedError:
            typed += 1
    snap = fleet.snapshot()
    assert completed + typed == len(work)
    assert typed >= 1
    assert snap["failovers"] == 1 and snap["requeues"] >= 1
    assert snap["replicas_healthy"] == 1 == fleet.healthy_replicas
    h2 = fleet.submit(request(work[1]))
    fleet.run_until_complete(max_steps=300)
    np.testing.assert_array_equal(h2.result().tokens, base[1])
    fleet.close()


def test_all_replicas_down_is_typed_not_wedged(model):
    work = workload(6, seed=2, new_lo=3)
    fleet = model.serve_fleet(replicas=2, max_slots=1, restart_budget=0)
    hs = [fleet.submit(request(w)) for w in work]
    faults.inject("serve.decode_step", FailAfterN(1, times=2))
    fleet.run_until_complete(max_steps=1000)
    faults.clear()
    assert fleet.healthy_replicas == 0
    assert not fleet.pending
    for h in hs:
        assert h.done()
        with pytest.raises(EngineFailedError):
            h.result()
    with pytest.raises(FleetDownError):
        fleet.submit(GenerationRequest(work[0][0], max_new_tokens=2))
    fleet.close()


def test_revive_reenters_routing_set(model):
    fleet = model.serve_fleet(replicas=2, max_slots=1, restart_budget=0)
    fleet.submit(GenerationRequest(np.asarray([1, 2, 3], np.int32),
                                   max_new_tokens=6))
    faults.inject("serve.decode_step", FailAfterN(0, times=1))
    fleet.run_until_complete(max_steps=500)
    faults.clear()
    dead = [r.idx for r in fleet._replicas if not r.healthy]
    assert len(dead) == 1
    with pytest.raises(ValueError):
        fleet.revive(1 - dead[0])
    fleet.revive(dead[0])
    assert fleet.healthy_replicas == 2
    routed0 = fleet.snapshot()["routed"][str(dead[0])]
    work = workload(4, seed=4)
    base = oracle(model, work)
    hs = [fleet.submit(request(w)) for w in work]
    fleet.run_until_complete(max_steps=500)
    for h, want in zip(hs, base):
        np.testing.assert_array_equal(h.result().tokens, want)
    assert fleet.snapshot()["routed"][str(dead[0])] > routed0
    fleet.close()


def test_watchdog_hang_failover(model, monkeypatch):
    from singa_tpu_torch.serve import fleet as fleet_mod

    work = workload(4, seed=5)
    base = oracle(model, work)
    fleet = model.serve_fleet(replicas=2, max_slots=1)
    hs = [fleet.submit(request(w)) for w in work]
    hung_src = fleet.supervisor(0).engine._hb_source

    class _FakeWd:
        def beat(self, *a, **kw):
            pass

        def hang_latched(self, source):
            return source == hung_src

    monkeypatch.setattr(fleet_mod._monitor, "active", lambda: True)
    monkeypatch.setattr(fleet_mod._monitor, "watchdog", lambda: _FakeWd())
    monkeypatch.setattr(fleet_mod._monitor, "heartbeat",
                        lambda *a, **kw: None)
    fleet.run_until_complete(max_steps=500)
    monkeypatch.undo()
    assert fleet.healthy_replicas == 1 and not fleet._replicas[0].healthy
    completed = 0
    for h, want in zip(hs, base):
        assert h.done()
        try:
            np.testing.assert_array_equal(h.result().tokens, want)
            completed += 1
        except EngineFailedError as e:
            assert e.started is True
    assert completed >= 1
    assert fleet.snapshot()["failovers"] == 1
    fleet.close()


# ------------------------------------------------------ degradation, hedges


def test_fleet_wide_shed_lowest_priority(model):
    fleet = model.serve_fleet(replicas=2, max_slots=1,
                              slo=SLO(queue_depth_max=1),
                              shed_on_slo_pressure=True)
    p = np.asarray([1, 2, 3], np.int32)
    h_a = fleet.submit(GenerationRequest(p, max_new_tokens=2, priority=0))
    h_b = fleet.submit(GenerationRequest(p, max_new_tokens=2, priority=0))
    with pytest.raises(LoadShedError):
        fleet.submit(GenerationRequest(p, max_new_tokens=2, priority=0))
    h_hi = fleet.submit(GenerationRequest(p, max_new_tokens=2, priority=5))
    fleet.run_until_complete(max_steps=300)
    want = model.generate(p, max_new_tokens=2, temperature=0.0)
    np.testing.assert_array_equal(h_hi.result().tokens, want)
    outcomes = []
    for h in (h_a, h_b):
        try:
            np.testing.assert_array_equal(h.result().tokens, want)
            outcomes.append("ok")
        except LoadShedError:
            outcomes.append("shed")
    assert sorted(outcomes) == ["ok", "shed"]
    fleet.close()


def test_hedge_redispatches_stuck_admission(model):
    """Sampled requests too: the hedge twin draws the same chain."""
    work = workload(3, seed=6, new_lo=4, new_hi=8)
    base = oracle(model, work)
    fleet = model.serve_fleet(replicas=2, max_slots=1, hedge_after_steps=2)
    fleet.router.rank = lambda views: sorted(v["replica"] for v in views)
    hs = [fleet.submit(request(w)) for w in work]
    assert fleet.supervisor(0).engine.scheduler.queue_depth == 3
    fleet.run_until_complete(max_steps=500)
    for h, want in zip(hs, base):
        np.testing.assert_array_equal(h.result().tokens, want)
    assert fleet.snapshot()["hedges"] >= 1
    assert counter("serve.fleet.hedges", fleet=fleet.fleet_label,
                   replica="1") >= 1
    fleet.close()


def test_hedge_skips_streaming_and_sessions(model):
    fleet = model.serve_fleet(replicas=2, max_slots=1, hedge_after_steps=1)
    fleet.router.rank = lambda views: sorted(v["replica"] for v in views)
    p = np.asarray([4, 5, 6], np.int32)
    tokens = []
    hs = [fleet.submit(GenerationRequest(p, max_new_tokens=3)),
          fleet.submit(GenerationRequest(
              p, max_new_tokens=3, on_token=lambda r, t: tokens.append(t))),
          fleet.submit(GenerationRequest(p, max_new_tokens=3,
                                         pin_session=True))]
    fleet.run_until_complete(max_steps=500)
    for h in hs:
        h.result()
    assert len(tokens) == 3
    fleet.close()


# ------------------------------------------- fault site, observability


def test_serve_route_fault_site_is_synchronous_and_typed(model):
    from singa_tpu_torch.resilience.faults import SITES

    assert "serve.route" in SITES
    with model.serve_fleet(replicas=2, max_slots=1) as fleet:
        faults.inject("serve.route", FailOnce())
        p = np.asarray([1, 2], np.int32)
        with pytest.raises(Exception) as ei:
            fleet.submit(GenerationRequest(p, max_new_tokens=2))
        assert getattr(ei.value, "site", None) == "serve.route"
        faults.clear()
        h = fleet.submit(GenerationRequest(p, max_new_tokens=2))
        fleet.run_until_complete(max_steps=200)
        h.result()


def test_fleet_metrics_health_report_and_unregister(model):
    work = workload(4, seed=7)
    fleet = model.serve_fleet(replicas=2, max_slots=2)
    hs = [fleet.submit(request(w)) for w in work]
    fleet.run_until_complete(max_steps=500)
    for h in hs:
        h.result()
    lbl = fleet.fleet_label
    assert counter("serve.fleet.routed", fleet=lbl, replica="0") \
        + counter("serve.fleet.routed", fleet=lbl, replica="1") \
        == len(work)
    rep = health_report(include_registry=False)
    sec = rep["serve"]["fleet"]
    assert sec["replicas_healthy"] >= 2
    assert sec["failovers"] == 0
    assert sum(sec["routed"].values()) >= len(work)
    assert "fleet_failovers" in rep["resilience"]
    assert "fleet_requeues" in rep["resilience"]
    snap = fleet.snapshot()
    assert set(snap) == {"replicas", "replicas_healthy",
                         "replicas_routable", "replicas_draining",
                         "replicas_retired", "roles",
                         "failovers", "requeues", "hedges", "routed",
                         "ships", "ship_bytes", "shared_prefix_hits",
                         "ship_fallbacks", "engines"}
    assert len(snap["engines"]) == 2
    assert snap["replicas_routable"] == 2
    assert snap["replicas_draining"] == snap["replicas_retired"] == 0
    fleet.close()
    gkey = "serve.fleet.replicas_healthy{fleet=%s}" % lbl
    assert gkey not in registry().snapshot()["gauges"]
    with pytest.raises(RuntimeError, match="closed"):
        fleet.submit(GenerationRequest(work[0][0], max_new_tokens=2))


def test_fleet_validates_config(model):
    with pytest.raises(ValueError, match="replicas"):
        ServeFleet(model, replicas=0)
    with pytest.raises(ValueError, match="hedge_after_steps"):
        ServeFleet(model, replicas=1, hedge_after_steps=0)
    with pytest.raises(ValueError, match="budget_reset_after_s"):
        ServeFleet(model, replicas=1, budget_reset_after_s=-1.0)


def test_replicas_capture_once_at_warm_up(model):
    """Each replica captures its decode widths at its warm-up and none
    after: a second batch of the same widths captures nothing, and a
    revived replica captures its own anew."""
    from singa_tpu_torch.serve import jit_cache_size

    base = jit_cache_size()
    with model.serve_fleet(replicas=2, max_slots=2) as fleet:
        work = workload(6, seed=8)
        for w in work:
            fleet.submit(request(w))
        fleet.run_until_complete(max_steps=500)
        warm = jit_cache_size() - base
        assert warm > 0
        for w in workload(6, seed=9):
            fleet.submit(request(w))
        fleet.run_until_complete(max_steps=500)
        assert jit_cache_size() - base == warm
