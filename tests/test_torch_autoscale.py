"""Fleet autoscaling on the port (``singa_tpu_torch/serve/autoscale.py`` and
the fleet's elastic surface): the cases of ``tests/test_autoscale.py``.
The decision table runs threadless under a fake clock and a fake fleet
through both packages' ``Autoscaler`` side by side, and their
``scaling_events`` ledgers (action, replica, reason, the signal snapshot)
must be equal; the live-fleet cases (spawn, drain and retire, the
leaked-gauge audit, the ``serve.autoscale`` fault site) run on port
fleets of ``GPT2Config.tiny`` on the CPU, their streams (greedy and
seeded-sampled) against the port's ``generate``.  Sharded fleets are
refused at construction (``test_torch_fleet.py``).
"""

import numpy as np
import pytest

import torch

from singa_tpu.observe.registry import MetricsRegistry as JMetricsRegistry
from singa_tpu.resilience import FailOnce as JFailOnce
from singa_tpu.resilience import faults as jfaults
from singa_tpu.serve import AutoscaleConfig as JAutoscaleConfig
from singa_tpu.serve import Autoscaler as JAutoscaler
from singa_tpu_torch import device, tensor
from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from singa_tpu_torch.observe import health_report
from singa_tpu_torch.observe.registry import MetricsRegistry, registry
from singa_tpu_torch.resilience import FailOnce, faults
from singa_tpu_torch.serve import (AutoscaleConfig, Autoscaler,
                                   GenerationRequest, ServeFleet)

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
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def model():
    device.create_cpu_device().SetRandSeed(0)
    m = GPT2LMHead(GPT2Config.tiny(dropout=0.0))
    m.compile([tensor.from_numpy(np.zeros((1, 16), np.int32),
                                 device.create_cpu_device())],
              is_train=False)
    return m


#: the two packages' autoscaler surfaces: the port's and the JAX one
PKGS = {"port": (Autoscaler, AutoscaleConfig, MetricsRegistry, faults,
                 FailOnce),
        "jax": (JAutoscaler, JAutoscaleConfig, JMetricsRegistry, jfaults,
                JFailOnce)}
class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class _FakeReplica:
    def __init__(self, idx):
        self.idx = idx
        self.healthy = True
        self.draining = False
        self.retired = False


class _FakePolicy:
    """Just the .alerts surface the autoscaler reads."""

    def __init__(self):
        self.alerts = {"page": {"firing": False}}

    def fire(self, on=True):
        self.alerts["page"]["firing"] = on


class FakeFleet:
    """Duck-typed ServeFleet surface the Autoscaler consumes — the
    decision table runs with zero engines."""

    def __init__(self, n=1, load=None):
        self.fleet_label = "t"
        self._clock = None
        self._replicas = [_FakeReplica(i) for i in range(n)]
        self.load = load if load is not None else {}
        self.log = []
        self.drained_set = set()

    @property
    def replicas(self):
        return len(self._replicas)

    def load_views(self):
        out = []
        for r in self._replicas:
            if not (r.healthy and not r.retired):
                continue
            v = {"replica": r.idx, "role": "mixed",
                 "draining": r.draining, "queue_depth": 0,
                 "occupancy": 0.0, "tpot_ewma": None,
                 "queue_headroom": None, "blocks_used_frac": None}
            v.update(self.load.get(r.idx, {}))
            out.append(v)
        return out

    def add_replica(self, role="mixed"):
        idx = len(self._replicas)
        self._replicas.append(_FakeReplica(idx))
        self.log.append(("add", idx))
        return idx

    def revive(self, idx):
        r = self._replicas[idx]
        r.healthy, r.retired, r.draining = True, False, False
        self.log.append(("revive", idx))

    def start_drain(self, idx):
        self._replicas[idx].draining = True
        self.log.append(("drain", idx))

    def cancel_drain(self, idx):
        self._replicas[idx].draining = False
        self.log.append(("cancel", idx))

    def drained(self, idx):
        return idx in self.drained_set

    def retire_replica(self, idx):
        r = self._replicas[idx]
        r.retired, r.healthy, r.draining = True, False, False
        self.log.append(("retire", idx))


def _scaler(fleet, clk, reg=None, policy=None, pkg="port", **kw):
    scaler_cls, cfg_cls, reg_cls = PKGS[pkg][:3]
    cfg = dict(min_replicas=1, max_replicas=3,
               scale_up_cooldown_s=10.0, scale_down_cooldown_s=30.0,
               queue_high=4.0, queue_low=0.5, occupancy_high=0.85,
               occupancy_low=0.35, blocks_high=0.85)
    cfg.update(kw)
    return scaler_cls(fleet, cfg_cls(**cfg), slo_policy=policy, clock=clk,
                      reg=reg if reg is not None else reg_cls())


def _events(sc):
    return [dict(e) for e in sc.scaling_events]


@pytest.fixture(params=["port", "jax"])
def pkg(request):
    """Each decision-table case runs on both packages' autoscaler; the
    port's ledger must equal the JAX one's (``test_decision_ledgers_
    match_jax``)."""
    return request.param


# ---------------------------------------------------------------------------
# decision table (threadless, fake fleet)
# ---------------------------------------------------------------------------

def test_scale_up_on_burn_alert(pkg):
    clk, pol = FakeClock(), _FakePolicy()
    fleet = FakeFleet(1)
    sc = _scaler(fleet, clk, policy=pol, pkg=pkg)
    assert sc.check() is None           # quiet + at min: hold
    pol.fire()
    ev = sc.check()
    assert ev["action"] == "scale_up"
    assert ev["reason"].startswith("slo_burn:page")
    assert fleet.log == [("add", 1)]
    # the ledger carries the signal snapshot that justified it
    assert ev["signals"]["alerts_firing"] == ["page"]


def test_scale_up_on_load_signals_and_cooldown_no_flap(pkg):
    clk = FakeClock()
    fleet = FakeFleet(1, load={0: {"queue_depth": 9}})
    sc = _scaler(fleet, clk, pkg=pkg)
    assert sc.check()["action"] == "scale_up"
    fleet.load[1] = {"queue_depth": 9}
    # still hot, but inside the up-cooldown: no flapping
    clk.advance(5.0)
    assert sc.check() is None
    clk.advance(5.0)
    assert sc.check()["action"] == "scale_up"
    # at max_replicas: never scales past the ceiling
    fleet.load[2] = {"queue_depth": 9}
    clk.advance(20.0)
    assert sc.check() is None
    assert fleet.replicas == 3


def test_scale_up_prefers_reviving_a_retired_slot(pkg):
    clk = FakeClock()
    fleet = FakeFleet(2)
    fleet._replicas[1].retired = True
    fleet._replicas[1].healthy = False
    fleet.load = {0: {"queue_depth": 9}}
    sc = _scaler(fleet, clk, pkg=pkg)
    ev = sc.check()
    assert ev["action"] == "scale_up" and "via=revive" in ev["reason"]
    assert fleet.log == [("revive", 1)]


def test_scale_up_on_kv_block_pressure(pkg):
    clk = FakeClock()
    fleet = FakeFleet(1, load={0: {"blocks_used_frac": 0.95}})
    sc = _scaler(fleet, clk, pkg=pkg)
    ev = sc.check()
    assert ev["action"] == "scale_up" and "kv_blocks" in ev["reason"]


def test_scale_down_only_when_quiet_and_drained(pkg):
    clk, pol = FakeClock(), _FakePolicy()
    fleet = FakeFleet(2)
    sc = _scaler(fleet, clk, policy=pol, pkg=pkg, max_replicas=2)
    # a firing alert blocks scale-down (and at max_replicas there is
    # no up to take either — the fleet holds)
    pol.fire()
    assert sc.check() is None
    pol.fire(False)
    ev = sc.check()
    assert ev["action"] == "drain_begin"
    idx = ev["replica"]
    assert fleet._replicas[idx].draining
    # NOT retired until the replica actually drains
    assert sc.check() is None
    assert not any(r.retired for r in fleet._replicas)
    fleet.drained_set.add(idx)
    ev = sc.check()
    assert ev["action"] == "drain_done"
    assert fleet._replicas[idx].retired
    # one drain at a time + down-cooldown: the second replica holds
    assert sc.check() is None


def test_scale_down_blocked_by_cooldowns_and_min(pkg):
    clk = FakeClock()
    fleet = FakeFleet(2, load={0: {"queue_depth": 9}})
    sc = _scaler(fleet, clk, pkg=pkg, min_replicas=2)
    sc.check()  # scale_up at t=0 -> 3 serving
    fleet.load = {}
    # quiet immediately after a scale-up: the down-embargo holds
    clk.advance(10.0)
    assert sc.check() is None
    clk.advance(30.0)
    ev = sc.check()
    assert ev is not None and ev["action"] == "drain_begin"
    fleet.drained_set.add(ev["replica"])
    sc.check()  # drain_done -> back to 2 serving
    # min_replicas floor: 2 serving == min, no further drain however
    # long it stays quiet
    clk.advance(100.0)
    assert sc.check() is None
    assert sum(1 for r in fleet._replicas
               if r.healthy and not r.retired) == 2  # 3 - 1 retired


def test_burst_during_drain_cancels_it(pkg):
    clk = FakeClock()
    fleet = FakeFleet(2)
    sc = _scaler(fleet, clk, pkg=pkg)
    ev = sc.check()
    assert ev["action"] == "drain_begin"
    idx = ev["replica"]
    fleet.load = {i: {"queue_depth": 9} for i in (0, 1)}
    ev = sc.check()
    assert ev["action"] == "drain_cancelled" and ev["replica"] == idx
    assert not fleet._replicas[idx].draining
    # the cancel counted as the scale-up (cooldown armed)
    assert sc.check() is None


def test_autoscale_fault_site_abandons_decision_typed(pkg):
    clk = FakeClock()
    _, _, reg_cls, pkg_faults, fail_once = PKGS[pkg]
    reg = reg_cls()
    fleet = FakeFleet(1, load={0: {"queue_depth": 9}})
    sc = _scaler(fleet, clk, reg=reg, pkg=pkg)
    pkg_faults.inject("serve.autoscale", fail_once())
    ev = sc.check()
    assert ev["action"] == "scale_up_failed" and "error" in ev
    assert fleet.replicas == 1 and fleet.log == []
    assert reg.counter("serve.autoscale.decisions_failed",
                       fleet="t").value == 1
    # no cooldown was spent: the next check retries and succeeds
    ev = sc.check()
    assert ev["action"] == "scale_up"
    assert fleet.replicas == 2


def test_config_validation(pkg):
    fleet = FakeFleet(1)
    with pytest.raises(ValueError):
        _scaler(fleet, FakeClock(), pkg=pkg, min_replicas=0)
    with pytest.raises(ValueError):
        _scaler(fleet, FakeClock(), pkg=pkg, min_replicas=3, max_replicas=2)
    with pytest.raises(ValueError):
        _scaler(fleet, FakeClock(), pkg=pkg, queue_low=5.0, queue_high=4.0)
    with pytest.raises(ValueError):
        _scaler(fleet, FakeClock(), pkg=pkg, blocks_high=0.0)
    with pytest.raises(ValueError):
        _scaler(fleet, FakeClock(), pkg=pkg, scale_up_cooldown_s=-1.0)
    with pytest.raises(ValueError):
        # fleet narrower than the floor
        _scaler(FakeFleet(1), FakeClock(), pkg=pkg, min_replicas=2,
                max_replicas=3)


def _scenario_burst_then_quiet(pkg):
    """A burst, a cooldown, a second replica, then quiet: drain and
    retire; an alert; the fault site once."""
    clk, pol = FakeClock(), _FakePolicy()
    fleet = FakeFleet(1, load={0: {"queue_depth": 9}})
    _, _, _, pkg_faults, fail_once = PKGS[pkg]
    sc = _scaler(fleet, clk, policy=pol, pkg=pkg)
    for step in range(40):
        if step == 3:
            pkg_faults.inject("serve.autoscale", fail_once())
        if step == 12:
            fleet.load = {}
        if step == 20:
            pol.fire()
        if step == 22:
            pol.fire(False)
        for r in fleet._replicas:
            if r.draining and step % 3 == 0:
                fleet.drained_set.add(r.idx)
        sc.check()
        clk.advance(4.0)
    pkg_faults.clear()
    return _events(sc), fleet.log


def test_decision_ledgers_match_jax():
    """One scripted scenario through both autoscalers: equal decisions,
    reasons and signal snapshots, event for event."""
    port, jax_ = (_scenario_burst_then_quiet(p) for p in ("port", "jax"))
    assert port == jax_
    actions = [e["action"] for e in port[0]]
    assert {"scale_up", "scale_up_failed", "drain_begin",
            "drain_done"} <= set(actions), actions


# ---------------------------------------------------------------------------
# live fleet integration
# ---------------------------------------------------------------------------

def _work(n, seed=0):
    """(prompt, max_new_tokens, temperature, seed): every other request
    sampled."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 256, rng.randint(3, 10)).astype(np.int32),
             int(rng.randint(2, 6)), TEMP if i % 2 else 0.0,
             int(rng.randint(0, 2 ** 31 - 1))) for i in range(n)]


def _req(w):
    p, n, t, s = w
    return GenerationRequest(p, max_new_tokens=n, temperature=t, seed=s)


def _oracle(m, work):
    return [np.asarray(m.generate(p, max_new_tokens=n, temperature=t,
                                  seed=[s])) for p, n, t, s in work]


def test_live_scale_up_serves_with_parity_and_drains_down(model):
    """The full loop on a real fleet: queue pressure spawns a replica
    (token parity held), all-quiet drains it back, the retired
    engine's metrics leave the registry (the leaked-gauge audit) and
    the health report drops its per-replica row."""
    work = _work(12, seed=3)
    base = _oracle(model, work)
    clk = FakeClock()
    fleet = ServeFleet(model, replicas=1, max_slots=2,
                       clock=clk)
    sc = Autoscaler(fleet, AutoscaleConfig(
        min_replicas=1, max_replicas=2, scale_up_cooldown_s=1.0,
        scale_down_cooldown_s=2.0, queue_high=2.0, queue_low=0.5,
        occupancy_high=1.5, occupancy_low=0.6), clock=clk)
    hs = [fleet.submit(_req(w)) for w in work]
    ev = sc.check()
    assert ev is not None and ev["action"] == "scale_up"
    assert fleet.replicas == 2
    while fleet.pending:
        fleet.step()
        clk.advance(0.5)
        sc.check()
    for h, want in zip(hs, base):
        np.testing.assert_array_equal(h.result().tokens, want)
    # all-quiet: drain + retire
    for _ in range(12):
        if any(e["action"] == "drain_done"
               for e in sc.scaling_events):
            break
        clk.advance(1.0)
        sc.check()
    assert any(e["action"] == "drain_done"
               for e in sc.scaling_events)
    retired = [r for r in fleet._replicas if r.retired]
    assert len(retired) == 1
    # leaked-gauge audit: nothing keyed to the retired engine's label
    lbl = f"engine={retired[0].sup.engine.stats.engine_label}"
    snap = registry().snapshot()
    leaked = [k for sec in snap.values() for k in sec if lbl in k]
    assert leaked == [], leaked
    # health: the per-replica row is gone, the autoscale section live
    assert retired[0].idx not in fleet.health()
    rep = health_report(include_registry=False)
    assert rep["serve"]["autoscale"]["enabled"] is True
    assert rep["serve"]["autoscale"]["scale_ups"] >= 1
    assert rep["serve"]["autoscale"]["scale_downs"] >= 1
    snap_f = fleet.snapshot()
    assert snap_f["replicas"] == 1 and snap_f["replicas_retired"] == 1
    sc.close()
    fleet.close()
    # close released the autoscale gauges too
    assert health_report(include_registry=False)["serve"][
        "autoscale"] == {"enabled": False}


def test_live_draining_replica_finishes_then_retires(model):
    """start_drain stops NEW routing but the replica completes its
    live work first; retire_replica refuses while work remains."""
    clk = FakeClock()
    fleet = ServeFleet(model, replicas=2, max_slots=2, clock=clk)
    work = _work(6, seed=4)
    hs = [fleet.submit(_req(w)) for w in work]
    busy = next(i for i in range(2)
                if fleet.supervisor(i).pending)
    fleet.start_drain(busy)
    with pytest.raises(RuntimeError):
        fleet.retire_replica(busy)
    # new submissions route AWAY from the draining replica
    before = fleet.snapshot()["routed"][str(busy)]
    extra = _work(3, seed=5)
    hs += [fleet.submit(_req(w)) for w in extra]
    assert fleet.snapshot()["routed"][str(busy)] == before
    fleet.run_until_complete(max_steps=500)
    for h in hs:
        h.result()
    assert fleet.drained(busy)
    fleet.retire_replica(busy)
    assert fleet.snapshot()["replicas"] == 1
    # retire without drain refuses typed
    with pytest.raises(ValueError):
        fleet.retire_replica(1 - busy)
    fleet.close()


def test_live_revive_reuses_retired_slot_and_add_replica_grows(model):
    clk = FakeClock()
    fleet = ServeFleet(model, replicas=1, max_slots=2, clock=clk)
    idx = fleet.add_replica()
    assert idx == 1 and fleet.replicas == 2
    fleet.start_drain(idx)
    assert fleet.drained(idx)
    fleet.retire_replica(idx)
    assert fleet.routable_replicas == 1
    fleet.revive(idx)
    assert fleet.routable_replicas == 2
    work = _work(4, seed=6)
    hs = [fleet.submit(_req(w)) for w in work]
    fleet.run_until_complete(max_steps=500)
    for h in hs:
        h.result()
    # a symmetric fleet refuses role-typed growth
    with pytest.raises(ValueError):
        fleet.add_replica(role="prefill")
    with pytest.raises(ValueError):
        fleet.add_replica(role="nonsense")
    fleet.close()
    with pytest.raises(RuntimeError):
        fleet.add_replica()


def test_live_sharded_fleet_refuses_add_replica(model):
    """A fleet built with the ``tp=`` knob pins its replicas' rank groups
    at construction and cannot grow, as the JAX fleet's (at ``tp=1``
    here: one process; the tp = 2 fleet's refusal runs on a rank group in
    ``test_torch_dist_sharded_fleet.py``)."""
    from singa_tpu_torch.serve import PagedConfig

    fleet = ServeFleet(model, replicas=2, max_slots=2, tp=1,
                       paged=PagedConfig(block_size=8, num_blocks=32))
    with pytest.raises(ValueError, match="sharded"):
        fleet.add_replica()
    fleet.run_until_complete(max_steps=50)
    fleet.close()


def test_live_add_replica_streams_match_oracle(model):
    """A replica added to a running fleet serves with the same streams:
    it captures its own decode steps at its warm-up."""
    clk = FakeClock()
    fleet = ServeFleet(model, replicas=1, max_slots=2, clock=clk)
    work = _work(6, seed=8)
    base = _oracle(model, work)
    hs = [fleet.submit(_req(w)) for w in work[:3]]
    fleet.step()
    fleet.add_replica()
    hs += [fleet.submit(_req(w)) for w in work[3:]]
    fleet.run_until_complete(max_steps=500)
    for h, want in zip(hs, base):
        np.testing.assert_array_equal(h.result().tokens, want)
    assert fleet.snapshot()["routed"]["1"] >= 1
    fleet.close()
