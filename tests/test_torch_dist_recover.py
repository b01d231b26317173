"""Controller survivability on the port (``singa_tpu_torch/serve/dist``):
the cases of ``tests/test_dist_recover.py`` — reconnect-with-resume
transport, worker request journaling, fenced fleet adoption — against
the port's single-model oracle (its ``generate``, held against the JAX
package's elsewhere).

* a transient NETWORK BLIP severs the controller-side socket: the worker
  redials inside a bounded window with full-jitter backoff, the session
  resumes (same seq space, same fencing epoch), and the one unacked CALL
  replays exactly once against the worker's reply cache;
* a CONTROLLER CRASH orphans live workers: they keep stepping, journal
  per-request progress, PARK finished results under a TTL, and a
  successor ADOPTS them — epoch bumped, journals reconciled, parked
  results re-delivered exactly once, never-started work requeued;
* the DEPOSED controller's frames carry its stale epoch and are refused
  typed (:class:`StaleEpochError`) before dispatch.

Unit tests drive the transport/worker protocol over socketpairs (no
engine); integration tests run the thread-mode fleet on
``GPT2Config.tiny`` (float32, CPU, one intra-op thread, weights from a
JAX ``save_states`` zip).
"""

import socket
import threading
import time

import numpy as np
import pytest
import torch

from singa_tpu import device as jdevice
from singa_tpu import tensor as jtensor
from singa_tpu.models.gpt2 import GPT2Config as JGPT2Config
from singa_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from singa_tpu_torch import device, tensor
from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from singa_tpu_torch.observe import trace
from singa_tpu_torch.serve import DistFleet, GenerationRequest, gpt2_spec
from singa_tpu_torch.serve.autoscale import AutoscaleConfig, Autoscaler
from singa_tpu_torch.serve.dist.transport import (
    IDEMPOTENT_OPS, MSG_CALL, MSG_HELLO, MSG_ONEWAY, MSG_REPLY,
    MSG_RESUME, PROTO_VERSION, Conn, Listener,
    NonIdempotentReplayError, PeerGoneError, PeerTimeoutError,
    StaleEpochError, TransportError, _full_jitter, resume_auth)
from singa_tpu_torch.serve.dist.worker import _Worker, load_exc

CPU = device.create_cpu_device()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """The port's tiny GPT-2 holding the JAX model's weights."""
    jdevice.get_default_device().SetRandSeed(0)
    jm = JGPT2LMHead(JGPT2Config.tiny(dropout=0.0))
    jm.compile([jtensor.from_numpy(np.zeros((1, 16), np.int32))],
               is_train=False, use_graph=False)
    path = str(tmp_path_factory.mktemp("dist_recover") / "m.zip")
    jm.save_states(path)
    m = GPT2LMHead(GPT2Config.tiny(dropout=0.0))
    m.compile([tensor.from_numpy(np.zeros((1, 16), np.int32), CPU)],
              is_train=False)
    m.load_states(path)
    return m


@pytest.fixture(scope="module")
def spec(model):
    return gpt2_spec(model)


def _prompts(n, seed=0, lo=4, hi=9):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, rng.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _oracle(model, prompts, new):
    return [[int(t) for t in model.generate(p, max_new_tokens=new,
                                            temperature=0.0)]
            for p in prompts]


# ---------------------------------------------------------------------------
# backoff + handshake auth (satellites a, c)
# ---------------------------------------------------------------------------

def test_full_jitter_bounds_and_cap():
    """Backoff draws are uniform in [0, min(base*2^a, cap)): bounded
    below the exponential ceiling early, clamped at the cap late, and
    never negative — the decorrelating shape N redialing workers need
    to not thunder in lockstep."""
    import random

    rng = random.Random(7)
    base, cap = 0.1, 2.0
    for attempt in range(10):
        hi = min(base * 2.0 ** attempt, cap)
        draws = [_full_jitter(rng, base, attempt, cap)
                 for _ in range(400)]
        assert all(0.0 <= d < hi for d in draws), (attempt, hi)
        # full jitter, not equal-jitter: draws span most of the range
        assert max(draws) > 0.8 * hi
        assert min(draws) < 0.2 * hi
    # deep attempts are cap-clamped, not exponential
    assert max(_full_jitter(rng, base, 30, cap)
               for _ in range(100)) < cap


def test_resume_auth_binds_every_field():
    """The RESUME HMAC commits to (nonce, idx, epoch, last_seq) under
    the fleet token: flipping any field — or the token — changes the
    digest, and str/bytes tokens agree (the wire carries both)."""
    base = resume_auth(b"tok", "n0", 3, 2, 17)
    assert base == resume_auth(b"tok", "n0", 3, 2, 17)  # deterministic
    assert base == resume_auth("tok", "n0", 3, 2, 17)   # str == bytes
    assert base != resume_auth(b"tok", "n1", 3, 2, 17)
    assert base != resume_auth(b"tok", "n0", 4, 2, 17)
    assert base != resume_auth(b"tok", "n0", 3, 3, 17)
    assert base != resume_auth(b"tok", "n0", 3, 2, 18)
    assert base != resume_auth(b"other", "n0", 3, 2, 17)


def test_hello_token_and_nonce_replay_refused():
    """HELLO hardening: a wrong token is refused (constant-time
    compare), a valid handshake is accepted once, and REPLAYING the
    same session nonce — even with the right token — is refused."""
    lst = Listener(token=b"secret")
    try:
        def dial(frame):
            s = socket.create_connection((lst.host, lst.port),
                                         timeout=5.0)
            c = Conn(s, "test")
            c.send(MSG_HELLO, frame)
            return c

        bad = dial({"token": b"wrong", "idx": 0,
                    "proto": PROTO_VERSION, "nonce": "n-bad"})
        with pytest.raises(TransportError, match="refused"):
            lst.accept_worker(timeout=5.0)
        bad.close()

        ok = dial({"token": b"secret", "idx": 0,
                   "proto": PROTO_VERSION, "nonce": "n-once"})
        idx, conn = lst.accept_worker(timeout=5.0)
        assert idx == 0
        conn.close()
        ok.close()

        replay = dial({"token": b"secret", "idx": 0,
                       "proto": PROTO_VERSION, "nonce": "n-once"})
        with pytest.raises(TransportError, match="nonce"):
            lst.accept_worker(timeout=5.0)
        replay.close()
    finally:
        lst.close()


def test_resume_auth_verified_and_nonce_single_use():
    """RESUME handshakes verify the HMAC over the listener's token:
    a forged auth is refused, a valid one lands as MSG_RESUME, and its
    nonce is burned — the same frame replayed is refused."""
    lst = Listener(token=b"tok")
    try:
        def dial(frame):
            s = socket.create_connection((lst.host, lst.port),
                                         timeout=5.0)
            c = Conn(s, "test")
            c.send(MSG_RESUME, frame)
            return c

        forged = dial({"idx": 1, "proto": PROTO_VERSION,
                       "nonce": "r0", "epoch": 1, "last_seq": 5,
                       "auth": "not-an-hmac"})
        with pytest.raises(TransportError, match="auth"):
            lst.accept_any(timeout=5.0)
        forged.close()

        frame = {"idx": 1, "proto": PROTO_VERSION, "nonce": "r1",
                 "epoch": 1, "last_seq": 5,
                 "auth": resume_auth(b"tok", "r1", 1, 1, 5)}
        good = dial(frame)
        kind, got, conn = lst.accept_any(timeout=5.0)
        assert kind == MSG_RESUME
        assert got["last_seq"] == 5 and got["epoch"] == 1
        conn.close()
        good.close()

        replayed = dial(dict(frame))
        with pytest.raises(TransportError, match="nonce"):
            lst.accept_any(timeout=5.0)
        replayed.close()
    finally:
        lst.close()


# ---------------------------------------------------------------------------
# replay protocol: finish_pending over a scripted peer
# ---------------------------------------------------------------------------

def _echo_responder(conn):
    """Replies to every CALL with ok + the op name, until peer loss."""
    try:
        while True:
            kind, msg = conn.recv(timeout=5.0)
            if kind == MSG_CALL:
                conn.send(MSG_REPLY, {"seq": msg["seq"], "ok": True,
                                      "value": {"op": msg["op"]}})
    except (PeerGoneError, PeerTimeoutError, TransportError, OSError):
        pass


def _conn_pair():
    sa, sb = socket.socketpair()
    a, b = Conn(sa, "ctl"), Conn(sb, "wrk")
    t = threading.Thread(target=_echo_responder, args=(b,),
                         daemon=True)
    t.start()
    return a, b


def test_finish_pending_resends_same_seq():
    """Reply lost (or call never arrived): the pending CALL resends
    under its ORIGINAL seq — the worker either answers from its reply
    cache or treats it as first delivery; either way exactly-once."""
    a, b = _conn_pair()
    try:
        seq = a.send_call("step")
        assert a._pending is not None
        # the reply exists but we "lost" it: replay instead of reading
        msg = a.finish_pending(peer_last_seq=seq)
        assert msg["seq"] == seq and msg["ok"]
        assert a._pending is None
    finally:
        a.close()
        b.close()


def test_finish_pending_first_delivery_case():
    a, b = _conn_pair()
    try:
        a._seq = 4
        a._pending = (4, "telemetry", None)  # sent, never arrived
        msg = a.finish_pending(peer_last_seq=3)  # seq == last+1
        assert msg["seq"] == 4 and msg["ok"]
    finally:
        a.close()
        b.close()


def test_finish_pending_divergence_idempotent_reissues():
    """Seq divergence on an idempotent op: safe to re-issue under a
    fresh seq (a double ping cannot corrupt anything)."""
    a, b = _conn_pair()
    try:
        assert "ping" in IDEMPOTENT_OPS
        a._seq = 4
        a._pending = (4, "ping", None)
        msg = a.finish_pending(peer_last_seq=1)   # 4 > 1+1: diverged
        assert msg["ok"] and msg["seq"] == 5      # fresh seq
        assert a._pending is None
    finally:
        a.close()
        b.close()


def test_finish_pending_divergence_non_idempotent_aborts_typed():
    """Seq divergence on submit/step: the worker may have executed it
    once already — re-issuing could double-admit, so the replay aborts
    typed into the existing failover path (NonIdempotentReplayError
    IS a PeerGoneError)."""
    a, b = _conn_pair()
    try:
        assert "submit" not in IDEMPOTENT_OPS
        a._seq = 4
        a._pending = (4, "submit", {"request": {}})
        with pytest.raises(NonIdempotentReplayError):
            a.finish_pending(peer_last_seq=1)
        assert a._pending is None
        assert issubclass(NonIdempotentReplayError, PeerGoneError)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# worker loop: seq dedupe and epoch fencing (no engine needed)
# ---------------------------------------------------------------------------

def _worker_pair(epoch=0):
    """A live _Worker loop over a socketpair, engine-less: clock/ping
    ops exercise the dispatch, cache, and fence without a model."""
    sa, sb = socket.socketpair()
    ctl = Conn(sa, "r0")
    ticks = [0]

    def fake_clock():
        ticks[0] += 1
        return float(ticks[0])

    w = _Worker(Conn(sb, "fleet"), clock=fake_clock)
    w._epoch = epoch
    t = threading.Thread(target=w.run, daemon=True)
    t.start()
    return ctl, w, t


def test_worker_seq_dedupe_answers_from_cache():
    """A replayed seq (the post-resume case) answers from the reply
    cache WITHOUT re-executing: the cached clock value is returned
    verbatim, and the next fresh seq proves the worker still
    executes."""
    ctl, w, t = _worker_pair()
    try:
        ctl.send(MSG_CALL, {"seq": 1, "op": "clock"})
        _, r1 = ctl.recv(timeout=5.0)
        ctl.send(MSG_CALL, {"seq": 1, "op": "clock"})   # replay
        _, r2 = ctl.recv(timeout=5.0)
        assert r1["ok"] and r2["ok"]
        assert r2["value"]["t"] == r1["value"]["t"], \
            "replayed seq re-executed instead of hitting the cache"
        ctl.send(MSG_CALL, {"seq": 2, "op": "clock"})   # fresh seq
        _, r3 = ctl.recv(timeout=5.0)
        assert r3["value"]["t"] > r1["value"]["t"]
    finally:
        ctl.send(MSG_ONEWAY, {"op": "die"})
        t.join(timeout=5.0)
        ctl.close()


def test_worker_fences_stale_epoch_typed_before_dispatch():
    """Frames from a deposed controller (epoch below the worker's):
    CALLs are refused typed with StaleEpochError — which reconstructs
    to its own class controller-side — and stale ONE-WAYS are dropped,
    BEFORE dispatch, so even a ``die`` from the stale side is inert.
    The refusal is never cached: the same seq under the current epoch
    executes normally."""
    ctl, w, t = _worker_pair(epoch=3)
    try:
        ctl.send(MSG_CALL, {"seq": 1, "op": "ping", "epoch": 2})
        _, r = ctl.recv(timeout=5.0)
        assert not r["ok"]
        err = load_exc(r["err"])
        assert isinstance(err, StaleEpochError)
        # a stale die is DROPPED, not obeyed: the worker still answers
        ctl.send(MSG_ONEWAY, {"op": "die", "epoch": 2})
        ctl.send(MSG_CALL, {"seq": 1, "op": "ping", "epoch": 3})
        _, r2 = ctl.recv(timeout=5.0)
        assert r2["ok"], "stale refusal polluted the reply cache"
    finally:
        ctl.send(MSG_ONEWAY, {"op": "die", "epoch": 3})
        t.join(timeout=5.0)
        ctl.close()


# ---------------------------------------------------------------------------
# journal: TTL tombstones and exactly-once claims
# ---------------------------------------------------------------------------

def _journal_worker(now=(0.0,)):
    clockbox = list(now)
    w = _Worker(object(), clock=lambda: clockbox[0])
    return w, clockbox


def test_journal_ttl_expiry_leaves_typed_tombstone():
    """A parked result nobody claims within the TTL is dropped, but a
    tombstone remains: a LATE adopter gets a typed ``expired`` verdict
    (with the token cursor, so it can refuse started work) instead of
    silence."""
    w, clock = _journal_worker()
    w._park_ttl = 10.0
    w._journal["a"] = {"state": "done", "req": None, "cursor": 2,
                       "order": 1, "out": {"result": "X"}, "t": 0.0}
    clock[0] = 5.0
    w._sweep_journal()
    assert w._journal["a"]["state"] == "done"   # inside the TTL
    clock[0] = 11.0
    w._sweep_journal()
    ent = w._journal["a"]
    assert ent["state"] == "expired"
    assert ent["out"] is None                    # the result is gone
    assert ent["cursor"] == 2                    # the verdict survives
    got = w.op_claim({"rid": "a"})
    assert got == {"status": "expired", "cursor": 2}


def test_parked_claim_is_exactly_once():
    """Claiming a parked result deletes it: the first adopter gets the
    payload, a second claim gets ``gone`` — and the streamed-token
    backlog for the claimed rid is purged so it cannot ride a later
    step reply into a controller that never submitted it."""
    w, _ = _journal_worker()
    payload = {"result": {"tokens": [1, 2, 3]}}
    w._journal["b"] = {"state": "done", "req": {"request_id": "b"},
                       "cursor": 3, "order": 1, "out": payload,
                       "t": 0.0}
    w._tokens = [("b", 7), ("c", 9)]
    got = w.op_claim({"rid": "b"})
    assert got["status"] == "parked"
    assert got["out"] is payload and got["cursor"] == 3
    assert w._tokens == [("c", 9)]
    assert w.op_claim({"rid": "b"}) == {"status": "gone"}
    assert w.op_claim({"rid": "never-seen"}) == {"status": "gone"}


def test_journal_cap_evicts_oldest_non_live():
    w, _ = _journal_worker()
    w._journal_cap = 3
    for i in range(5):
        st = "live" if i == 0 else "done"
        w._journal[f"r{i}"] = {"state": st, "req": None, "cursor": 0,
                               "order": i, "out": None, "t": 0.0}
    w._trim_journal()
    assert len(w._journal) == 3
    assert "r0" in w._journal   # live entries are never evicted


# ---------------------------------------------------------------------------
# autoscaler: reconnect grace gates replace_dead (satellite b)
# ---------------------------------------------------------------------------

def test_in_reconnect_grace_predicate():
    class R:
        pass

    r = R()
    assert Autoscaler._in_reconnect_grace(r) is False   # no attr
    r.reconnect_deadline = None
    assert Autoscaler._in_reconnect_grace(r) is False
    r.reconnect_deadline = time.monotonic() + 30.0
    assert Autoscaler._in_reconnect_grace(r) is True
    r.reconnect_deadline = time.monotonic() - 1.0
    assert Autoscaler._in_reconnect_grace(r) is False


def test_replace_dead_waits_out_reconnect_grace(model, spec):
    """The replace_dead/reconnect race, pinned: a replica whose
    transport is inside its reconnect (+grace) window must NOT be
    respawned — the worker may be about to resume — and once the
    window lapses the autoscaler heals the fleet as before."""
    with DistFleet(spec, replicas=2, spawn="thread",
                   max_slots=2) as fleet:
        fleet.kill_worker(0)
        rep = fleet._replicas[0]
        fleet._mark_down(rep, PeerGoneError("test: worker lost",
                                            started=None))
        rep.needs_failover = False     # no routes to reconcile
        rep.reconnect_deadline = time.monotonic() + 30.0
        sc = Autoscaler(fleet, AutoscaleConfig(
            min_replicas=2, max_replicas=2,
            scale_up_cooldown_s=0.0, scale_down_cooldown_s=0.0))
        try:
            ev = sc.check()
            assert ev is None or ev["action"] != "replace_dead", ev
            assert fleet.healthy_replicas == 1
            # the window lapses: the same dead replica is now fair game
            rep.reconnect_deadline = time.monotonic() - 0.001
            ev = sc.check()
            assert ev is not None and ev["action"] == "replace_dead"
            assert fleet.healthy_replicas == 2
            assert rep.reconnect_deadline is None   # revive cleared it
        finally:
            sc.close()


# ---------------------------------------------------------------------------
# integration: blip-resume, fenced adoption, stale-controller refusal
# ---------------------------------------------------------------------------

def test_blip_resumes_without_failover_byte_parity(model, spec):
    """A severed controller-side socket mid-decode: the worker redials
    and the session resumes — zero failovers, zero requeues, the fleet
    stays at full width, the epoch never moves, and every stream is
    byte-identical to the single-model oracle."""
    prompts = _prompts(5, seed=0)
    want = _oracle(model, prompts, new=5)
    with DistFleet(spec, replicas=2, spawn="thread",
                   max_slots=2) as fleet:
        hs = [fleet.submit(GenerationRequest(
            p, max_new_tokens=5, request_id=f"b{i}"))
            for i, p in enumerate(prompts)]
        for _ in range(3):
            fleet.step()
        fleet.blip_worker(0)
        fleet.run_until_complete(max_steps=800)
        got = [[int(t) for t in h.result().tokens] for h in hs]
        snap = fleet.snapshot()
        assert fleet.healthy_replicas == 2
    assert got == want, (got, want)
    d = snap["dist"]
    assert d["reconnects"] >= 1
    assert d["resumed_calls"] >= 1
    assert d["epoch"] == 1            # a resume is not an adoption
    assert snap["failovers"] == 0
    assert snap["requeues"] == 0


def test_resume_and_failover_leave_their_trace_events(model, spec):
    """The fleet's own instants of a blip's resume and of a kill's
    failover (what ``chip_smoke.py`` reads its recovery seconds from):
    ``serve/dist_resume`` with its seconds (the kill's too, unresumed
    when the window closes), one ``serve/fleet_failover``
    at the replica down, a ``serve/fleet_requeue`` a requeued request and
    ``serve/fleet_failover_done`` after them; the streams stay equal."""
    prompts = _prompts(8, seed=3)
    want = _oracle(model, prompts, new=6)
    trace.clear()
    trace.enable()
    try:
        with DistFleet(spec, replicas=2, spawn="thread", max_slots=2,
                       reconnect_window_s=0.5) as fleet:
            hs = [fleet.submit(GenerationRequest(
                p, max_new_tokens=6, request_id=f"t{i}"))
                for i, p in enumerate(prompts)]
            fleet.step()
            fleet.blip_worker(0)
            fleet.step()
            fleet.kill_worker(0)
            fleet.run_until_complete(max_steps=800)
            got = [[int(t) for t in h.result().tokens] for h in hs]
    finally:
        trace.disable()
        events = trace.drain()
    assert got == want, (got, want)
    ev = {}
    for e in events:
        ev.setdefault(e["name"], []).append(e)
    # the blip's session resumed; the kill's redial never came, and its
    # window closed before the replica went down (the failover's abandon
    # waits out one more)
    blip, *kill = ev["serve/dist_resume"]
    assert blip["args"]["resumed"] and blip["args"]["seconds"] >= 0
    assert kill and not any(e["args"]["resumed"] for e in kill)
    (down,) = ev["serve/fleet_failover"]
    (done,) = ev["serve/fleet_failover_done"]
    requeues = ev["serve/fleet_requeue"]
    assert down["args"]["replica"] == done["args"]["replica"] == 0
    assert requeues and all(e["args"]["src"] == 0 for e in requeues)
    assert down["ts"] <= min(e["ts"] for e in requeues)
    assert max(e["ts"] for e in requeues) <= done["ts"]
    assert blip["ts"] <= kill[0]["ts"] <= down["ts"]


def test_crash_adopt_reconciles_exactly_once_parity(model, spec):
    """Controller crash + fenced adoption: the successor attaches to
    the live workers, bumps the epoch to 2, reconciles every journaled
    request (resumed / delivered / requeued — nothing rejected), and
    every stream finishes byte-identical to the oracle: zero lost,
    zero duplicated tokens across the controller boundary."""
    prompts = _prompts(5, seed=3)
    want = _oracle(model, prompts, new=5)
    A = DistFleet(spec, replicas=2, spawn="thread", max_slots=2)
    port, token = A._listener.port, A._token
    hs = [A.submit(GenerationRequest(
        p, max_new_tokens=5, request_id=f"c{i}"))
        for i, p in enumerate(prompts)]
    for _ in range(2):
        A.step()
    assert not any(h.done() for h in hs), \
        "crash must land mid-flight for the test to mean anything"
    A.crash()

    B = DistFleet.adopt(spec, port=port, token=token, replicas=2,
                        spawn="thread", max_slots=2)
    try:
        rep = B.adoption
        assert rep["rejected"] == {}, rep["rejected"]
        handles = dict(rep["resumed"])
        handles.update(rep["delivered"])
        handles.update(rep["requeued"])
        assert sorted(handles) == [f"c{i}" for i in range(5)]
        B.run_until_complete(max_steps=800)
        got = [[int(t) for t in handles[f"c{i}"].result().tokens]
               for i in range(5)]
        snap = B.snapshot()
        assert B.healthy_replicas == 2
    finally:
        B.close()
    assert got == want, (got, want)
    assert snap["dist"]["epoch"] == 2


def test_stale_controller_refused_typed_on_every_op(model, spec):
    """The fence, controller-side: a conn stamping an older epoch (the
    deposed controller's view of the world) is refused typed on EVERY
    op — ping, snapshot, submit, and the overlapped step path — and
    the refusal is StaleEpochError, never a silent drop or a wrong
    answer.  Restoring the current epoch restores service: the fence
    rejected the EPOCH, not the connection."""
    prompts = _prompts(1, seed=9)
    with DistFleet(spec, replicas=2, spawn="thread",
                   max_slots=2) as fleet:
        sup = fleet.supervisor(0)
        sup.ping()                      # baseline: the conn is healthy
        sup._conn.epoch = 0             # impersonate a deposed epoch
        with pytest.raises(StaleEpochError):
            sup.ping()
        with pytest.raises(StaleEpochError):
            sup._rpc("snapshot")
        with pytest.raises(StaleEpochError):
            sup.submit(GenerationRequest(
                prompts[0], max_new_tokens=3, request_id="stale"))
        with pytest.raises(StaleEpochError):
            sup.step()
        sup._conn.epoch = fleet._epoch
        sup.ping()                      # fenced out, not condemned
        assert fleet.healthy_replicas == 2
