"""The port's supervised recovery (``serve/supervisor.py``) and typed
engine failure, the counterparts of ``tests/test_supervisor.py``'s ten
tests on the port's engine, plus the JAX supervisor on the same
traffic: the greedy streams of the requests a restart requeued, the
restart count, which requests failed typed, and the SLO-pressure
shedding (which request was shed, ``serve.shed_requests{reason=}``)
equal the JAX package's.

``GPT2Config.tiny`` on the CPU, the JAX weights carried into the port
by a ``save_states`` zip; faults from the seeded injection registries
of both packages (``serve.decode_step``), scheduling on a fake clock
where a test needs one.
"""

import numpy as np
import pytest

import torch

from singa_tpu import device as jdevice
from singa_tpu import tensor as jtensor
from singa_tpu.models.gpt2 import GPT2Config as JGPT2Config
from singa_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from singa_tpu.observe.health import SLO as JSLO
from singa_tpu.observe.registry import registry as jregistry
from singa_tpu.resilience import FailAfterN as JFailAfterN
from singa_tpu.resilience import faults as jfaults
from singa_tpu.serve import EngineFailedError as JEngineFailedError
from singa_tpu.serve import EngineSupervisor as JSupervisor
from singa_tpu.serve import GenerationRequest as JRequest
from singa_tpu.serve import LoadShedError as JLoadShedError
from singa_tpu_torch import device, tensor
from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from singa_tpu_torch.observe.health import SLO, health_report
from singa_tpu_torch.observe.registry import registry
from singa_tpu_torch.resilience import FailAfterN, FailRate, faults
from singa_tpu_torch.serve import (EngineFailedError, EngineSupervisor,
                                   FIFOScheduler, GenerationRequest,
                                   LoadShedError, QueueFullError,
                                   RestartBudgetExceededError)

CPU = device.create_cpu_device()


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


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
    path = str(tmp_path_factory.mktemp("sup") / "m.zip")
    jm.save_states(path)
    tm.load_states(path)
    return jm, tm


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


_PROMPTS = [np.arange(9) % 256, (np.arange(4) + 3) % 256,
            np.asarray([5, 1, 200]), (np.arange(7) + 40) % 256]
_NEWS = [6, 3, 5, 4]


def _key(name, labels):
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}"
                                 for k, v in sorted(labels.items())) + "}"


def _counter(name, reg=registry, **labels):
    return reg().snapshot()["counters"].get(_key(name, labels), 0)


# -- typed engine failure ------------------------------------------------

def test_decode_fault_fails_all_requests_typed(model):
    """One raising decode step: in-flight requests reject with
    started=True, queued ones with started=False, the engine marks itself
    failed, and close() still releases its resources."""
    eng = model.serve(max_slots=2)
    hs = [eng.submit(GenerationRequest(p, max_new_tokens=n))
          for p, n in zip(_PROMPTS[:3], _NEWS[:3])]
    eng.step()  # admit two rows (the third stays queued)
    before = _counter("resilience.engine_failures")
    faults.inject("serve.decode_step", FailAfterN(0, times=1))
    with pytest.raises(EngineFailedError):
        eng.step()
    faults.clear()
    assert not eng.pending
    started = []
    for h in hs:
        assert h.done()
        with pytest.raises(EngineFailedError) as ei:
            h.result()
        assert ei.value.request_id == h.request.request_id
        started.append(ei.value.started)
    assert started == [True, True, False]
    with pytest.raises(EngineFailedError):
        eng.step()
    with pytest.raises(EngineFailedError):
        eng.submit(GenerationRequest(_PROMPTS[0]))
    eng.close()
    assert _counter("resilience.engine_failures") == before + 1


# -- supervised recovery ---------------------------------------------------

def _supervised(model, sup_cls, req_cls, fault, inject, reg, err, **kw):
    """Run the four requests greedy under a supervisor with ``fault``
    armed at ``serve.decode_step``; (outcomes, restarts, restart count
    delta) where an outcome is the token list or ``("failed",
    started)``."""
    r0 = _counter("resilience.engine_restarts", reg=reg)
    sup = sup_cls(model, max_slots=2, restart_budget=2, **kw)
    hs = [sup.submit(req_cls(p, max_new_tokens=n, temperature=0.0))
          for p, n in zip(_PROMPTS, _NEWS)]
    inject("serve.decode_step", fault)
    sup.run_until_complete(max_steps=500)
    out = []
    for i, h in enumerate(hs):
        assert h.done(), f"handle {i} left dangling"
        try:
            out.append(np.asarray(h.result().tokens).tolist())
        except err as e:
            out.append(("failed", e.started))
    sup.close()
    return out, sup.restarts, \
        _counter("resilience.engine_restarts", reg=reg) - r0


def test_supervisor_restart_requeue_parity(pair):
    """A mid-stream injected fault and a restart: the requeued (never
    started) requests complete with the streams of an uninterrupted run,
    those in flight fail typed, one restart a fault; and all of it equals
    the JAX supervisor's on the same traffic and fault."""
    jm, model = pair
    base = [np.asarray(model.generate(p, max_new_tokens=n,
                                      temperature=0.0)).tolist()
            for p, n in zip(_PROMPTS, _NEWS)]
    out, restarts, delta = _supervised(
        model, EngineSupervisor, GenerationRequest, FailAfterN(2, times=1),
        faults.inject, registry, EngineFailedError)
    faults.clear()
    completed = [i for i, o in enumerate(out) if isinstance(o, list)]
    failed = [i for i, o in enumerate(out) if not isinstance(o, list)]
    assert completed and failed
    for i in completed:
        assert out[i] == base[i]
    assert all(out[i] == ("failed", True) for i in failed)
    assert restarts == 1 and delta == 1
    assert health_report()["resilience"]["engine_restarts"] >= 1
    j_out, j_restarts, _ = _supervised(
        jm, JSupervisor, JRequest, JFailAfterN(2, times=1), jfaults.inject,
        jregistry, JEngineFailedError)
    assert out == j_out and restarts == j_restarts


def test_supervisor_restart_budget_exhausts_typed(model):
    """An engine that fails on every decode burns the budget; every
    outstanding handle resolves typed and the supervisor refuses new
    work."""
    sup = EngineSupervisor(model, max_slots=2, restart_budget=1)
    hs = [sup.submit(GenerationRequest(p, max_new_tokens=n))
          for p, n in zip(_PROMPTS, _NEWS)]
    faults.inject("serve.decode_step", FailRate(1.0, seed=0))
    with pytest.raises(RestartBudgetExceededError):
        sup.run_until_complete(max_steps=500)
    faults.clear()
    assert sup.restarts == 2
    for h in hs:
        assert h.done()
        with pytest.raises(EngineFailedError):
            h.result()
    with pytest.raises(RestartBudgetExceededError):
        sup.submit(GenerationRequest(_PROMPTS[0]))
    assert not sup.pending


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def test_restart_budget_resets_after_healthy_uptime(model):
    """``budget_reset_after_s``: failures separated by more healthy uptime
    than the window forgive the spent budget; failures inside it still
    exhaust it; the default (None) counts every restart."""
    clk = FakeClock()
    sup = EngineSupervisor(model, max_slots=2, restart_budget=1,
                           budget_reset_after_s=10.0, clock=clk)

    def crash_once_and_drain():
        h = sup.submit(GenerationRequest(_PROMPTS[0], max_new_tokens=3))
        faults.inject("serve.decode_step", FailAfterN(0, times=1))
        sup.run_until_complete(max_steps=200)
        faults.clear()
        assert h.done()

    for _ in range(3):
        crash_once_and_drain()
        assert sup.restarts == 1
        clk.advance(11.0)
    crash_once_and_drain()
    h = sup.submit(GenerationRequest(_PROMPTS[1], max_new_tokens=3))
    faults.inject("serve.decode_step", FailAfterN(0, times=1))
    with pytest.raises(RestartBudgetExceededError):
        sup.run_until_complete(max_steps=200)
    faults.clear()
    assert h.done()
    with pytest.raises(EngineFailedError):
        h.result()

    clk2 = FakeClock()
    sup2 = EngineSupervisor(model, max_slots=2, restart_budget=1,
                            clock=clk2)
    for i in range(2):
        hi = sup2.submit(GenerationRequest(_PROMPTS[0], max_new_tokens=3))
        faults.inject("serve.decode_step", FailAfterN(0, times=1))
        if i == 0:
            sup2.run_until_complete(max_steps=200)
        else:
            with pytest.raises(RestartBudgetExceededError):
                sup2.run_until_complete(max_steps=200)
        faults.clear()
        clk2.advance(100.0)
        assert hi.done()
    with pytest.raises(ValueError, match="budget_reset_after_s"):
        EngineSupervisor(model, budget_reset_after_s=0)


def test_supervisor_clean_run_has_no_restarts(model):
    base = [np.asarray(model.generate(p, max_new_tokens=n,
                                      temperature=0.0))
            for p, n in zip(_PROMPTS[:2], _NEWS[:2])]
    with EngineSupervisor(model, max_slots=2) as sup:
        hs = [sup.submit(GenerationRequest(p, max_new_tokens=n,
                                           temperature=0.0))
              for p, n in zip(_PROMPTS[:2], _NEWS[:2])]
        sup.run_until_complete(max_steps=200)
        assert sup.restarts == 0
        for h, b in zip(hs, base):
            np.testing.assert_array_equal(h.result().tokens, b)


def test_requeued_streaming_has_no_duplicate_tokens(model):
    """A requeued request's on_token stream matches its result: queued
    work never streamed, so the restart emits each token once."""
    streams = {}

    def on_token(req, tok):
        streams.setdefault(req.request_id, []).append(tok)

    sup = EngineSupervisor(model, max_slots=1, restart_budget=1)
    reqs = [GenerationRequest(p, max_new_tokens=n, temperature=0.0,
                              on_token=on_token)
            for p, n in zip(_PROMPTS[:3], _NEWS[:3])]
    hs = [sup.submit(r) for r in reqs]
    faults.inject("serve.decode_step", FailAfterN(1, times=1))
    sup.run_until_complete(max_steps=500)
    faults.clear()
    assert sup.restarts == 1
    n_ok = 0
    for r, h in zip(reqs, hs):
        if h._error is not None:
            continue
        toks = h.result().tokens
        np.testing.assert_array_equal(np.asarray(streams[r.request_id]),
                                      toks[len(r.prompt_ids):])
        n_ok += 1
    assert n_ok >= 2
    sup.close()


def test_raising_on_token_callback_fails_only_that_request(model):
    def bad_cb(req, tok):
        raise KeyError("client bug")

    eng = model.serve(max_slots=2)
    h_bad = eng.submit(GenerationRequest(_PROMPTS[0], max_new_tokens=4,
                                         on_token=bad_cb))
    h_ok = eng.submit(GenerationRequest(_PROMPTS[1], max_new_tokens=3,
                                        temperature=0.0))
    eng.run_until_complete(max_steps=100)
    with pytest.raises(KeyError):
        h_bad.result()
    want = np.asarray(model.generate(_PROMPTS[1], max_new_tokens=3,
                                     temperature=0.0))
    np.testing.assert_array_equal(h_ok.result().tokens, want)
    assert not eng._failed
    eng.close()


# -- load shedding ---------------------------------------------------------

def test_queue_full_error_names_depth_and_max():
    sched = FIFOScheduler(max_queue_depth=2)
    sched.enqueue(GenerationRequest(np.asarray([1])))
    sched.enqueue(GenerationRequest(np.asarray([2])))
    with pytest.raises(QueueFullError) as ei:
        sched.enqueue(GenerationRequest(np.asarray([3])))
    assert "depth 2" in str(ei.value)
    assert "max 2" in str(ei.value)


def test_scheduler_shed_lowest_priority_and_counter():
    before = _counter("serve.shed_requests", reason="test")
    sched = FIFOScheduler()
    lo = GenerationRequest(np.asarray([1]), priority=0)
    hi = GenerationRequest(np.asarray([2]), priority=5)
    lo2 = GenerationRequest(np.asarray([3]), priority=0)
    for r in (lo, hi, lo2):
        sched.enqueue(r)
    assert sched.shed_lowest("test") is lo2
    assert sched.queue_depth == 2
    assert _counter("serve.shed_requests", reason="test") == before + 1
    assert sched.shed_lowest("test", below_priority=0) is None
    assert sched.shed_lowest("test", below_priority=99) is lo


def _shedding(model, sup_cls, req_cls, slo, reg, shed_err):
    """The SLO-pressure scenario; (which handles were shed, the second
    low arrival refused, counter deltas, the high request's result)."""
    p0 = _counter("serve.shed_requests", reg=reg, reason="slo_pressure")
    a0 = _counter("serve.shed_requests", reg=reg, reason="slo_admission")
    sup = sup_cls(model, max_slots=1, shed_on_slo_pressure=True, slo=slo)
    hs = [sup.submit(req_cls(_PROMPTS[0], max_new_tokens=2, priority=0,
                             temperature=0.0))]
    sup.step()
    hs += [sup.submit(req_cls(p, max_new_tokens=2, priority=0,
                              temperature=0.0))
           for p in _PROMPTS[1:3]]
    h_hi = sup.submit(req_cls(_PROMPTS[3], max_new_tokens=2, priority=9,
                              temperature=0.0))
    shed = [i for i, h in enumerate(hs) if h.done()]
    for i in shed:
        with pytest.raises(shed_err):
            hs[i].result()
    with pytest.raises(shed_err):
        sup.submit(req_cls(_PROMPTS[0], max_new_tokens=2, priority=0))
    sup.run_until_complete(max_steps=300)
    res = h_hi.result()
    out = (shed, _counter("serve.shed_requests", reg=reg,
                          reason="slo_pressure") - p0,
           _counter("serve.shed_requests", reg=reg,
                    reason="slo_admission") - a0,
           res.finish_reason, np.asarray(res.tokens).tolist(),
           [np.asarray(h.result().tokens).tolist()
            for i, h in enumerate(hs) if i not in shed])
    sup.close()
    return out


def test_slo_pressure_sheds_lowest_priority_queued(pair):
    """Admission under SLO queue pressure: a high-priority arrival evicts
    the lowest-priority queued request (typed ``LoadShedError``), a
    low-priority arrival is refused itself; the same request is shed, the
    same counts land in ``serve.shed_requests{reason=}`` and the same
    streams come out as from the JAX supervisor."""
    jm, model = pair
    out = _shedding(model, EngineSupervisor, GenerationRequest,
                    SLO(queue_depth_max=2), registry, LoadShedError)
    shed, n_pressure, n_admission, reason, _, _ = out
    assert len(shed) == 1 and n_pressure == 1 and n_admission == 1
    assert reason == "length"
    assert health_report()["resilience"]["shed_requests"].get(
        "slo_pressure", 0) >= 1
    assert out == _shedding(jm, JSupervisor, JRequest,
                            JSLO(queue_depth_max=2), jregistry,
                            JLoadShedError)
