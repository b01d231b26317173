"""The port's multi-host fleet (``singa_tpu_torch/serve/dist``) against the
JAX package's: the wire itself, one thread-mode ``DistFleet`` run held
token for token against the JAX ``DistFleet`` on the same requests
(greedy and seeded-sampled), and the cases of ``tests/test_dist_fleet.py``
on the port, where a ``DistFleet`` must stream and resolve exactly as the
port's in-process ``ServeFleet`` does on the same requests.

The wire: frames the port's ``Conn.send`` writes are byte-equal to the
JAX ``Conn.send``'s for the same dicts and numpy payloads, each package
decodes the other's frames, and a frame that names a global outside the
port's wire types raises ``TransportError`` without calling it.

``GPT2Config.tiny`` (vocabulary 256), float32, on the CPU, one intra-op
thread; the JAX weights carried into the port by a ``save_states`` zip.
Workers run as threads of the test process (same sockets, same framing),
except in the one process-mode case.
"""

import os
import pickle
import socket
import struct
import threading
import time
import zlib

import numpy as np
import pytest
import torch

from singa_tpu import device as jdevice
from singa_tpu import tensor as jtensor
from singa_tpu.models.gpt2 import GPT2Config as JGPT2Config
from singa_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from singa_tpu.serve import DistFleet as JDistFleet
from singa_tpu.serve import GenerationRequest as JRequest
from singa_tpu.serve import gpt2_spec as jgpt2_spec
from singa_tpu.serve.dist import transport as jtransport
from singa_tpu_torch import device, tensor
from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from singa_tpu_torch.resilience import FailOnce, faults
from singa_tpu_torch.serve import (DistFleet, GenerationRequest, KVImage,
                                   KVImageError, PagedConfig,
                                   PrefixCacheConfig, ServeFleet, gpt2_spec)
from singa_tpu_torch.serve.autoscale import AutoscaleConfig, Autoscaler
from singa_tpu_torch.serve.dist import DistSession
from singa_tpu_torch.serve.dist.transport import (MSG_CALL, MSG_ONEWAY,
                                                  Conn, PeerGoneError,
                                                  PeerTimeoutError,
                                                  TransportError,
                                                  resume_auth)
from singa_tpu_torch.serve.kvimage import KVIMAGE_VERSION, pack_image

CPU = device.create_cpu_device()
BLOCK = 8
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


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX tiny GPT-2, the port's holding its weights)."""
    jdevice.get_default_device().SetRandSeed(0)
    jm = JGPT2LMHead(JGPT2Config.tiny(dropout=0.0))
    jm.compile([jtensor.from_numpy(np.zeros((1, 16), np.int32))],
               is_train=False, use_graph=False)
    path = str(tmp_path_factory.mktemp("dist_fleet") / "m.zip")
    jm.save_states(path)
    m = GPT2LMHead(GPT2Config.tiny(dropout=0.0))
    m.compile([tensor.from_numpy(np.zeros((1, 16), np.int32), CPU)],
              is_train=False)
    m.load_states(path)
    return jm, m


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


@pytest.fixture(scope="module")
def spec(model):
    return gpt2_spec(model)


def _disagg_kw(roles=("prefill", "decode"), num_blocks=48):
    return dict(roles=roles, max_slots=2,
                paged=PagedConfig(block_size=BLOCK,
                                  num_blocks=num_blocks),
                prefix_cache=PrefixCacheConfig(block_size=BLOCK))


def _prompts(n, seed=0, lo=4, hi=9):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, rng.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _long(seed, n=40):
    return np.random.RandomState(seed).randint(
        0, 256, n).astype(np.int32)


def _run(fleet, prompts, new=5, prefix="q", max_steps=800):
    hs = [fleet.submit(GenerationRequest(
        p, max_new_tokens=new, request_id=f"{prefix}{i}"))
        for i, p in enumerate(prompts)]
    fleet.run_until_complete(max_steps=max_steps)
    return [[int(t) for t in h.result().tokens] for h in hs]


def _leaks(fleet):
    """Wire-level leak check: the step reply carries both
    ``blocks_used`` and ``cached_blocks``, so used minus tree-cached on
    each healthy replica must be zero after a drain."""
    out = []
    for i in range(fleet.replicas):
        eng = fleet.supervisor(i).engine
        if eng._closed or eng.paged_arena is None:
            continue
        out.append(eng.paged_arena.blocks_used
                   - eng.prefix_cache.cached_blocks)
    return out


# ------------------------------------------------------------- the wire


def _raw_frame(conn_cls, kind, obj):
    """The bytes ``conn_cls.send(kind, obj)`` puts on a socket."""
    sa, sb = socket.socketpair()
    try:
        conn_cls(sa, "a").send(kind, obj)
        sa.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = sb.recv(1 << 16)
            if not chunk:
                return out
            out += chunk
    finally:
        sa.close()
        sb.close()


WIRE_PAYLOADS = [
    {"seq": 3, "op": "submit", "epoch": 1, "payload": {"request": {
        "prompt_ids": np.arange(7, dtype=np.int32), "max_new_tokens": 5,
        "temperature": 0.8, "seed": 11, "deadline_rel": None,
        "priority": 0, "pin_session": False, "stop_token": None,
        "request_id": "q0", "stream": True}}},
    {"seq": 4, "ok": True, "value": {
        "resolved": {"q0": {"result": {
            "request_id": "q0", "tokens": np.arange(12, dtype=np.int32),
            "finish_reason": "length", "ttft": 0.25, "tpot": None,
            "queue_time": 0.0, "admitted_step": 1, "finished_step": 6,
            "session": None}}},
        "tokens": [("q0", 17), ("q1", 3)],
        "view": {"queue_depth": 0, "live_slots": 1, "tpot_ewma": None,
                 "blocks_used": 4, "cached_blocks": 2,
                 "live_rids": ["q1"], "restarts": 0},
        "budget": None}},
    {"op": "ship_frame", "payload": {
        "ship_id": "s1-q0", "leaf": 1, "layer": 0, "lo": 8, "hi": 16,
        "bytes": np.arange(64, dtype=np.float32).tobytes()}},
    {"token": b"\x01" * 16, "idx": 1, "proto": 1, "nonce": "ab" * 16},
]


@pytest.mark.parametrize("i", range(len(WIRE_PAYLOADS)))
def test_frames_equal_the_jax_transports_byte_for_byte(i):
    """The same dict through each package's ``Conn.send``: one byte
    string, and each package decodes the other's frame to the same
    object."""
    obj = WIRE_PAYLOADS[i]
    ours = _raw_frame(Conn, MSG_CALL, obj)
    theirs = _raw_frame(jtransport.Conn, jtransport.MSG_CALL, obj)
    assert ours == theirs
    for send_cls, recv_cls in ((Conn, jtransport.Conn),
                               (jtransport.Conn, Conn)):
        sa, sb = socket.socketpair()
        a, b = send_cls(sa, "a"), recv_cls(sb, "b")
        try:
            a.send(MSG_CALL, obj)
            kind, got = b.recv(timeout=5.0)
        finally:
            a.close()
            b.close()
        assert kind == MSG_CALL
        assert pickle.dumps(got, protocol=pickle.HIGHEST_PROTOCOL) \
            == pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def test_resume_auth_equals_the_jax_digest():
    for args in ((b"tok", "n0", 3, 2, 17), ("tok", "nonce", 0, 1, 0),
                 (os.urandom(16), os.urandom(16).hex(), 7, 9, 12345)):
        assert resume_auth(*args) == jtransport.resume_auth(*args)


_CALLED = []


def _planted(*args):
    _CALLED.append(args)
    return {}


class _Planted:
    def __reduce__(self):
        return (_planted, ("ran",))


@pytest.mark.parametrize("obj", [_Planted(), {"payload": [_Planted()]},
                                 {"cfg": os.getcwd}])
def test_frame_naming_a_foreign_global_is_refused(obj):
    """A well-framed payload (magic, proto, crc all right) that names a
    global outside the wire types: ``TransportError``, and the global
    is never called."""
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    frame = struct.pack("!4sBBIQ", b"STPU", 1, MSG_CALL,
                        zlib.crc32(payload) & 0xFFFFFFFF,
                        len(payload)) + payload
    sa, sb = socket.socketpair()
    b = Conn(sb, "b")
    try:
        sa.sendall(frame)
        with pytest.raises(TransportError, match="not a wire type"):
            b.recv(timeout=5.0)
    finally:
        sa.close()
        b.close()
    assert _CALLED == []


def test_model_spec_crosses_the_wire(spec):
    """The INIT payload (a ``ModelSpec``: factory, config, numpy
    states, device) decodes through the restricted unpickler."""
    sa, sb = socket.socketpair()
    a, b = Conn(sa, "a"), Conn(sb, "b")
    # the frame outgrows the socket buffer: send from a thread
    t = threading.Thread(target=a.send, args=(MSG_CALL, {
        "seq": 1, "op": "init", "payload": {"spec": spec}}))
    t.start()
    try:
        _, got = b.recv(timeout=30.0)
    finally:
        t.join(timeout=30.0)
        a.close()
        b.close()
    assert not t.is_alive()
    back = got["payload"]["spec"]
    assert back.factory is spec.factory
    assert vars(back.factory_kw["cfg"]) == vars(spec.factory_kw["cfg"])
    assert back.device == "cpu"
    assert sorted(back.states) == sorted(spec.states)
    for k, v in spec.states.items():
        np.testing.assert_array_equal(back.states[k], v)


def test_spec_naming_the_card_raises_without_one(spec):
    """A worker without a GPU refuses a spec that names the card; the
    CPU serves only where the spec names it."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    import copy

    gpu = copy.copy(spec)
    gpu.device = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpu.build()


# ---------------------------------------------- against the JAX package


def test_thread_streams_match_the_jax_dist_fleet(pair, tmp_path):
    """The same 8 requests, every other one sampled with a seed of its
    own, through a 2-worker thread-mode DistFleet of each package: every
    stream equal, and equal to the port's in-process fleet."""
    jm, m = pair
    rng = np.random.RandomState(21)
    work = [(rng.randint(0, 256, rng.randint(3, 10)).astype(np.int32),
             int(rng.randint(2, 7)), TEMP if i % 2 else 0.0,
             int(rng.randint(0, 2 ** 31 - 1))) for i in range(8)]
    with JDistFleet(jgpt2_spec(jm), replicas=2, spawn="thread",
                    max_slots=2) as jf:
        jhs = [jf.submit(JRequest(p, max_new_tokens=n, temperature=t,
                                  seed=s)) for p, n, t, s in work]
        jf.run_until_complete(max_steps=500)
        want = [np.asarray(h.result().tokens) for h in jhs]
    with DistFleet(gpt2_spec(m), replicas=2, spawn="thread",
                   max_slots=2) as f:
        hs = [f.submit(GenerationRequest(p, max_new_tokens=n,
                                         temperature=t, seed=s))
              for p, n, t, s in work]
        f.run_until_complete(max_steps=500)
        got = [np.asarray(h.result().tokens) for h in hs]
    with ServeFleet(m, replicas=2, max_slots=2) as f1:
        hs = [f1.submit(GenerationRequest(p, max_new_tokens=n,
                                          temperature=t, seed=s))
              for p, n, t, s in work]
        f1.run_until_complete(max_steps=500)
        local = [np.asarray(h.result().tokens) for h in hs]
    for g, w, lo in zip(got, want, local):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, lo)


# ---------------------------------- kvimage wire codec across the boundary


def _fake_rows(width=16):
    kc = torch.arange(2 * 4 * width * 8, dtype=torch.float32).reshape(
        (2, 1, 4, width, 8))
    return kc, kc.clone()


def test_kvimage_wire_roundtrip():
    kc, vc = _fake_rows()
    img = pack_image(kc, vc, block_size=BLOCK, n_data=2, quant=False)
    back = KVImage.from_bytes(img.to_bytes())
    assert back.version == KVIMAGE_VERSION
    assert back.checksum == img.checksum
    assert back.header == img.header
    assert back.n_data == 2 and back.block_size == BLOCK
    back.validate(BLOCK, False)
    np.testing.assert_array_equal(back.kc.numpy(), img.kc.numpy())


def test_kvimage_wire_rejects_corruption_typed():
    """Every way a socket can mangle a frame is a typed KVImageError:
    bit-flip (crc), mid-leaf truncation, short framing, foreign magic,
    version skew, and trailing bytes."""
    kc, vc = _fake_rows()
    img = pack_image(kc, vc, block_size=BLOCK, n_data=2, quant=False)
    buf = img.to_bytes()

    flip = bytearray(buf)
    flip[len(flip) // 2] ^= 0xFF
    with pytest.raises(KVImageError, match="crc32"):
        KVImage.from_bytes(bytes(flip))
    with pytest.raises(KVImageError, match="mid-leaf"):
        KVImage.from_bytes(buf[: len(buf) // 2])
    with pytest.raises(KVImageError, match="truncated"):
        KVImage.from_bytes(b"KVIM")
    with pytest.raises(KVImageError, match="magic"):
        KVImage.from_bytes(b"NOPE" + buf[4:])
    skew = bytearray(buf)
    skew[4:6] = (KVIMAGE_VERSION + 1).to_bytes(2, "big")
    with pytest.raises(KVImageError, match="version"):
        KVImage.from_bytes(bytes(skew))
    with pytest.raises(KVImageError, match="beyond its header"):
        KVImage.from_bytes(buf + b"\x00")


# ------------------------------------------- framing and typed failures


def test_transport_frames_and_typed_failures():
    sa, sb = socket.socketpair()
    a, b = Conn(sa, "a"), Conn(sb, "b")
    try:
        a.send(MSG_ONEWAY, {"op": "ping", "payload": 7})
        kind, obj = b.recv(timeout=5.0)
        assert kind == MSG_ONEWAY and obj["payload"] == 7
        with pytest.raises(PeerTimeoutError):
            b.recv(timeout=0.05)
        sa.sendall(b"XXXX" + b"\x00" * 14)
        with pytest.raises(TransportError):
            b.recv(timeout=5.0)
    finally:
        a.close()
        b.close()


def test_transport_peer_close_is_peer_gone():
    sa, sb = socket.socketpair()
    a, b = Conn(sa, "a"), Conn(sb, "b")
    a.close()
    with pytest.raises(PeerGoneError):
        b.recv(timeout=5.0)
    b.close()


# ------------------------------------------- parity: the wire is invisible


def test_dist_thread_parity_and_token_streams(model, spec):
    """Greedy decode through worker threads equals the in-process fleet,
    and on_token delivers exactly the generated tail parent-side, in
    order, per request."""
    prompts = _prompts(6, seed=0)
    with ServeFleet(model, replicas=2, max_slots=2) as f1:
        want = _run(f1, prompts, new=6)
    seen = []
    with DistFleet(spec, replicas=2, spawn="thread", max_slots=2) as f2:
        hs = [f2.submit(GenerationRequest(
            p, max_new_tokens=6, request_id=f"q{i}",
            on_token=lambda req, tok: seen.append(
                (req.request_id, int(tok)))))
            for i, p in enumerate(prompts)]
        f2.run_until_complete(max_steps=500)
        got = [[int(t) for t in h.result().tokens] for h in hs]
        snap = f2.snapshot()
    assert got == want, (got, want)
    for i, toks in enumerate(got):
        tail = toks[len(prompts[i]):]
        assert [t for rid, t in seen if rid == f"q{i}"] == tail
    d = snap["dist"]
    assert d["spawn"] == "thread"
    assert d["rpcs"] > 0 and d["rpc_errors"] == 0


def test_dist_disagg_streamed_ship_parity_no_leaks(model, spec):
    """Prefill builds stream layer-wise frames to the decode peer, the
    landed image admits warm, and the streams equal the single-host
    disaggregated fleet's, with zero leaked blocks after the drain."""
    prompts = [_long(s) for s in (3, 4, 5)]
    kw = _disagg_kw()
    with ServeFleet(model, replicas=2, **kw) as f1:
        want = _run(f1, prompts, new=5)
    with DistFleet(spec, replicas=2, spawn="thread", **kw) as f2:
        got = _run(f2, prompts, new=5)
        snap = f2.snapshot()
        leaks = _leaks(f2)
    assert got == want, (got, want)
    assert snap["ships"] >= 1
    assert snap["ship_fallbacks"] == 0
    assert snap["dist"]["frames"] > 0
    assert snap["dist"]["frame_bytes"] > 0
    assert all(x == 0 for x in leaks), leaks


def test_dist_sticky_session_parity(model, spec):
    """A pinned session's continuation round-trips the wire: the handle
    lands parent-side as a DistSession over host tokens, the next turn
    routes sticky, and both turns match the in-process fleet."""
    p = (np.arange(40) % 256).astype(np.int32)
    extra = np.asarray([7, 3, 11, 2], np.int32)
    cache = dict(max_slots=2,
                 prefix_cache=PrefixCacheConfig(block_size=BLOCK))

    def turns(fleet):
        h = fleet.submit(GenerationRequest(p, max_new_tokens=4,
                                           pin_session=True))
        fleet.run_until_complete(max_steps=300)
        sess = h.result().session
        assert sess is not None
        h2 = fleet.submit(sess.request(extra, max_new_tokens=3))
        fleet.run_until_complete(max_steps=300)
        out = ([int(t) for t in h.result().tokens],
               [int(t) for t in h2.result().tokens])
        return sess, out

    with ServeFleet(model, replicas=2, **cache) as f1:
        _, want = turns(f1)
    with DistFleet(spec, replicas=2, spawn="thread", **cache) as f2:
        sess, got = turns(f2)
        assert isinstance(sess, DistSession)
        np.testing.assert_array_equal(sess.tokens, got[0])
        sess.release()
        sess.release()
    assert got == want, (got, want)


# ------------------------- distance failures: severed, partitioned, halved


def test_dist_kill_worker_failover_requeue_parity(model, spec):
    """A worker severed mid-flight: its requests requeue onto the
    survivor and finish equal to an undisturbed run."""
    prompts = _prompts(4, seed=2)
    with ServeFleet(model, replicas=2, max_slots=2) as f1:
        want = _run(f1, prompts, new=6, prefix="k")
    with DistFleet(spec, replicas=2, spawn="thread", max_slots=2) as f2:
        hs = [f2.submit(GenerationRequest(
            p, max_new_tokens=6, request_id=f"k{i}"))
            for i, p in enumerate(prompts)]
        f2.step()
        f2.kill_worker(0)
        f2.run_until_complete(max_steps=800)
        got = [[int(t) for t in h.result().tokens] for h in hs]
        snap = f2.snapshot()
        assert f2.healthy_replicas == 1
    assert got == want, (got, want)
    assert snap["failovers"] >= 1


def test_dist_partition_then_autoscaler_replaces(model, spec):
    """An injected RPC partition (``serve.dist.rpc``) marks the peer down
    through the PeerGone failover path; in-flight work drains on the
    survivor, and the autoscaler's replace_dead heals the fleet back to
    width with a fresh worker that then serves traffic."""
    prompts = _prompts(3, seed=4)
    with DistFleet(spec, replicas=2, spawn="thread",
                   max_slots=2) as fleet:
        hs = [fleet.submit(GenerationRequest(
            p, max_new_tokens=4, request_id=f"p{i}"))
            for i, p in enumerate(prompts)]
        faults.inject("serve.dist.rpc", FailOnce())
        fleet.run_until_complete(max_steps=800)
        for h in hs:
            assert len(h.result().tokens) > 0
        assert fleet.healthy_replicas == 1
        sc = Autoscaler(fleet, AutoscaleConfig(
            min_replicas=2, max_replicas=2,
            scale_up_cooldown_s=0.0, scale_down_cooldown_s=0.0))
        try:
            ev = sc.check()
            assert ev is not None and ev["action"] == "replace_dead"
            assert "role" in ev
            assert fleet.healthy_replicas == 2
            h = fleet.submit(GenerationRequest(
                prompts[0], max_new_tokens=3, request_id="post"))
            fleet.run_until_complete(max_steps=300)
            assert len(h.result().tokens) > 0
        finally:
            sc.close()


def test_dist_halfship_falls_back_cold(model, spec):
    """A frame lost mid-relay (``serve.dist.frame``): the destination's
    staging is aborted, the build falls back cold, neither peer is
    condemned, and the streams stay equal with zero leaked blocks."""
    prompts = [_long(s) for s in (6, 7)]
    kw = _disagg_kw()
    with ServeFleet(model, replicas=2, **kw) as f1:
        want = _run(f1, prompts, new=4, prefix="h")
    with DistFleet(spec, replicas=2, spawn="thread", **kw) as f2:
        faults.inject("serve.dist.frame", FailOnce())
        got = _run(f2, prompts, new=4, prefix="h")
        snap = f2.snapshot()
        leaks = _leaks(f2)
        assert f2.healthy_replicas == 2
    assert got == want, (got, want)
    assert snap["ship_fallbacks"] >= 1
    assert all(x == 0 for x in leaks), leaks


def test_dist_stale_hint_prunes_and_serves_cold(model, spec):
    """The residency directory lies: the verify hook asks the live tree
    over the wire, the hint is pruned, and the request serves cold."""
    p = _long(11)
    toks = [int(t) for t in p]
    n_blocks = len(toks) // BLOCK
    kw = _disagg_kw()
    with ServeFleet(model, replicas=2, **kw) as f1:
        want = _run(f1, [p], new=4, prefix="s")
    with DistFleet(spec, replicas=2, spawn="thread", **kw) as f2:
        f2._prefix_index.register(toks, n_blocks, 1)
        assert f2._prefix_index.holders(toks, n_blocks) == [1]
        got = _run(f2, [p], new=4, prefix="s")
        assert 1 not in f2._prefix_index.holders(toks, n_blocks) \
            or f2.snapshot()["ships"] >= 1
        leaks = _leaks(f2)
    assert got == want, (got, want)
    assert all(x == 0 for x in leaks), leaks


def test_thread_workers_run_their_ops_one_at_a_time(spec, monkeypatch):
    """Worker threads of one process share its CUDA context, the launch
    counts a capture records and torch's default capture stream, so
    their ops run one at a time: a decode step captured in one worker
    thread never sees another thread's launches.  The fleet sends every
    step before it reads a reply, so unserialized steps would overlap."""
    from singa_tpu_torch.serve.dist import worker

    inside, seen = [0], []
    step = worker._Worker.op_step

    def slow_step(self, p):
        inside[0] += 1
        seen.append(inside[0])
        time.sleep(0.01)
        try:
            return step(self, p)
        finally:
            inside[0] -= 1

    monkeypatch.setattr(worker._Worker, "op_step", slow_step)
    with DistFleet(spec, replicas=2, spawn="thread", max_slots=2) as f:
        _run(f, _prompts(4, seed=6), new=4)
    assert len(seen) > 4 and max(seen) == 1, seen


# ------------------------------------------- true multi-process parity


def test_dist_process_mode_parity(model, spec):
    """Two spawned worker processes (their own torch, their own engine
    and captured steps): the streams equal the in-process fleet's, and
    the kernel counts come back on the telemetry pull."""
    prompts = _prompts(3, seed=1)
    with ServeFleet(model, replicas=2, max_slots=2) as f1:
        want = _run(f1, prompts, new=4)
    with DistFleet(spec, replicas=2, spawn="process",
                   max_slots=2) as f2:
        got = _run(f2, prompts, new=4)
        pids = [f2.supervisor(i).pid for i in range(2)]
        counts = f2.kernel_launches()
    assert got == want, (got, want)
    assert all(p and p != os.getpid() for p in pids), pids
    # each worker's own counts; the CPU runs the plain versions
    assert sorted(counts) == [0, 1]
    assert all(c["paged_attn.launches"] == 0 for c in counts.values())


# ---------------------------------------------------- telemetry federation


@pytest.fixture()
def _observing():
    from singa_tpu_torch import observe

    observe.clear()
    observe.enable()
    led = observe.requests.enable(capacity=1024)
    yield led
    observe.requests.disable()
    observe.disable()
    observe.clear()


def test_dist_federation_hosts_health_and_peer_metrics(
        model, spec, _observing):
    """Every sealed hop carries a host id, the dist health section names
    the straggler host and decomposes latency with the ``ship`` phase
    (fractions summing to 1), and the per-peer transport metrics are
    registered while the fleet lives and gone when it closes."""
    from singa_tpu_torch.observe import health_report
    from singa_tpu_torch.observe.registry import registry

    prompts = _prompts(4, seed=3)
    with DistFleet(spec, replicas=2, spawn="thread", max_slots=2,
                   telemetry_interval_s=0.0) as fleet:
        _run(fleet, prompts, new=4, prefix="f")
        fleet._maybe_pull_telemetry(force=True)
        entries = _observing.entries()
        assert entries
        for e in entries:
            assert e["hops"][-1]["host"] in ("w0", "w1"), e
        ds = health_report()["serve"]["dist"]
        assert ds["enabled"] is True
        assert sorted(ds["hosts"]) == ["w0", "w1"]
        assert ds["stale_hosts"] == []
        assert all(h["pulls"] >= 1 for h in ds["hosts"].values())
        ws = ds["why_slow"]
        lat = ws["latency_p99_attribution"]
        assert set(lat) == {"queue", "prefill", "ship", "decode",
                            "stall", "preempted", "hops"}
        assert sum(p["frac"] for p in lat.values()) \
            == pytest.approx(1.0)
        assert "ship" in ws["ttft_p99_attribution"]
        assert ws["straggler_host"]["host"] in ("w0", "w1")
        assert set(ws["per_host"]) <= {"w0", "w1", "local"}
        snap = registry().snapshot()
        for peer in ("w0", "w1"):
            assert snap["counters"][
                f"serve.dist.frames{{peer={peer}}}"] > 0
            assert snap["counters"][
                f"serve.dist.bytes{{peer={peer}}}"] > 0
            assert f"serve.dist.rtt_s{{peer={peer}}}" \
                in snap["histograms"]
        dist = fleet.snapshot()["dist"]
        assert dist["retries"] == 0
        assert "ship_overlap_efficiency" in dist
        assert dist["telemetry"]["w0"]["pulls"] >= 1
    snap = registry().snapshot()
    assert not any("peer=" in k for k in snap["counters"])
    assert health_report()["serve"]["dist"] == {"enabled": False}


def test_dist_telemetry_death_degrades_stale_serving_unaffected(
        model, spec, _observing):
    """A lost telemetry pull degrades its host to a typed ``stale``
    marker while serving continues, the next pull clears it, and a pull
    never consumes a fault injected on the RPC site."""
    from singa_tpu_torch.observe import health_report

    prompts = _prompts(4, seed=5)
    with DistFleet(spec, replicas=2, spawn="thread", max_slots=2,
                   telemetry_interval_s=0.0) as fleet:
        hs = [fleet.submit(GenerationRequest(
            p, max_new_tokens=5, request_id=f"t{i}"))
            for i, p in enumerate(prompts)]
        fleet.step()
        faults.inject("serve.dist.telemetry", FailOnce())
        fleet._maybe_pull_telemetry(force=True)
        ds = health_report()["serve"]["dist"]
        assert ds["stale_hosts"] == ["w0"]
        assert ds["hosts"]["w0"]["stale_reason"]
        fleet.run_until_complete(max_steps=800)
        for h in hs:
            assert h.result().finish_reason == "length"
        assert fleet.healthy_replicas == 2
        assert _observing.snapshot()["open"] == 0
        fleet._maybe_pull_telemetry(force=True)
        assert health_report()["serve"]["dist"]["stale_hosts"] == []
        prom = fleet.telemetry.prometheus_text()
        assert 'singa_tpu_federation_stale{host="w0"} 0' in prom
        faults.inject("serve.dist.rpc", FailOnce())
        fleet._maybe_pull_telemetry(force=True)
        assert health_report()["serve"]["dist"]["stale_hosts"] == []
        with pytest.raises(PeerGoneError):
            fleet.supervisor(0).ping()


def test_dist_peer_loss_rejections_are_observable(
        model, spec, _observing):
    """A worker lost mid-flight leaves a ``serve/request_rejected``
    instant and a ledger hop reject with reason ``peer_lost`` and the
    delivery-started verdict (False: the requeue serves the caller)."""
    from singa_tpu_torch import observe

    prompts = _prompts(4, seed=2)
    with DistFleet(spec, replicas=2, spawn="thread",
                   max_slots=2) as fleet:
        hs = [fleet.submit(GenerationRequest(
            p, max_new_tokens=4, request_id=f"x{i}"))
            for i, p in enumerate(prompts)]
        fleet.step()
        fleet.kill_worker(0)
        fleet.run_until_complete(max_steps=800)
        for h in hs:
            assert h.result().finish_reason == "length"
    inst = [e for e in observe.events()
            if e["name"] == "serve/request_rejected"
            and (e["args"] or {}).get("reason") == "peer_lost"]
    assert inst, "no serve/request_rejected instant for the lost peer"
    assert inst[0]["args"]["started"] is False
    rejects = [
        (e["request_id"], h["reject"])
        for e in _observing.entries() for h in e["hops"]
        if h["reject"] is not None
        and h["reject"]["reason"] == "peer_lost"]
    assert rejects, "peer_lost never landed in the ledger"
    assert all(r["started"] is False for _, r in rejects)
    done = {e["request_id"]: e["outcome"] for e in _observing.entries()}
    for rid, _ in rejects:
        assert done[rid] == "length"


def test_dist_retire_and_revive_federation_lifecycle(
        model, spec, _observing):
    """Retire unregisters the worker's federated series (telemetry host
    slot and per-peer transport metrics); revive registers both fresh."""
    from singa_tpu_torch.observe.registry import registry

    with DistFleet(spec, replicas=2, spawn="thread", max_slots=2,
                   telemetry_interval_s=0.0) as fleet:
        _run(fleet, _prompts(2, seed=7), new=3, prefix="r")
        fleet._maybe_pull_telemetry(force=True)
        assert sorted(fleet.telemetry.hosts) == ["w0", "w1"]
        fleet.start_drain(1)
        for _ in range(50):
            if fleet.drained(1):
                break
            fleet.step()
        fleet.retire_replica(1)
        assert sorted(fleet.telemetry.hosts) == ["w0"]
        snap = registry().snapshot()
        assert not any("peer=w1" in k for k in snap["counters"])
        assert any("peer=w0" in k for k in snap["counters"])
        assert 'host="w1"' not in fleet.telemetry.prometheus_text()
        fleet.revive(1)
        assert sorted(fleet.telemetry.hosts) == ["w0", "w1"]
        assert fleet.telemetry.hosts["w1"].pulls == 0
        snap = registry().snapshot()
        assert any("peer=w1" in k for k in snap["counters"])
        h = fleet.submit(GenerationRequest(
            _prompts(1, seed=8)[0], max_new_tokens=3,
            request_id="post-revive"))
        fleet.run_until_complete(max_steps=300)
        assert h.result().finish_reason == "length"
