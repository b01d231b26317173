"""Disaggregated prefill/decode on the port's fleet: role-typed replicas,
KV ships through the versioned host image and its wire codec, the fleet
prefix index, and the router's least-recently-routed tie-break: the
cases of ``tests/test_serve_disagg.py`` on the port, plus the JAX fleet
held token for token against the port's on the same requests (greedy and
seeded-sampled) and the wire bytes of both codecs compared.

A prefill specialist's build is the chunked admission's canonical K/V,
the image a byte copy of those blocks and the decode replica's admission
a local warm hit, so a shipped stream equals the request served by one
engine (greedy and sampled, dense and int8 pools), and every failure
mode requeues cold with no block leaked on either replica.

``GPT2Config.tiny``, float32, block size 8, on the CPU, one intra-op
thread; the JAX weights carried into the port by a ``save_states`` zip.
"""

import os
import pickle

import numpy as np
import pytest

import torch

from singa_tpu.serve import GenerationRequest as JRequest
from singa_tpu.serve import PagedConfig as JPagedConfig
from singa_tpu.serve import PrefixCacheConfig as JPrefixCacheConfig
from singa_tpu.serve import kvimage as jkvimage
from singa_tpu_torch.observe import requests as reqtrace
from singa_tpu_torch.resilience import FailOnce, faults
from singa_tpu_torch.serve import (GenerationRequest, KVImage, KVImageError,
                                   PagedConfig, PrefixCacheConfig, Router,
                                   ServeFleet)
from singa_tpu_torch.serve import kvimage as kvimage_mod
from singa_tpu_torch.serve.kvimage import KVIMAGE_VERSION, pack_image
from singa_tpu_torch.serve.prefix import FleetPrefixIndex

from test_torch_fleet import make_pair

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
    return make_pair(tmp_path_factory, "disagg")


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


def _disagg_kw(num_blocks=48, **extra):
    return dict(paged=PagedConfig(block_size=BLOCK, num_blocks=num_blocks),
                prefix_cache=PrefixCacheConfig(block_size=BLOCK), **extra)


def _long(seed, n=40):
    return np.random.RandomState(seed).randint(0, 256, n).astype(np.int32)


def _chats(n, seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 256, rng.randint(3, 7)).astype(np.int32),
             int(rng.randint(2, 5))) for _ in range(n)]


def _gen(m, p, n, temperature=0.0, seed=0):
    return np.asarray(m.generate(p, max_new_tokens=n,
                                 temperature=temperature, seed=[seed]))


def _leaks(fleet):
    """Blocks unaccounted for on each open replica after a drain."""
    out = []
    for i in range(fleet.replicas):
        eng = fleet.supervisor(i).engine
        if not eng._closed:
            out.append(eng.paged_arena.blocks_used
                       - eng.prefix_cache.cached_blocks)
    return out


def _fleet(m, **kw):
    return m.serve_fleet(replicas=2, roles=("prefill", "decode"),
                         max_slots=2, **dict(_disagg_kw(), **kw))


# ----------------------------------------------------------- kvimage codec


def _fake_rows(width=16, quant=False):
    if quant:
        kc = (torch.zeros((2, 1, 4, width, 8), dtype=torch.int8),
              torch.zeros((2, 1, 4, width)))
        vc = tuple(a.clone() for a in kc)
    else:
        kc = torch.zeros((2, 1, 4, width, 8))
        vc = kc.clone()
    return kc, vc


def test_kvimage_pack_validate_roundtrip():
    kc, vc = _fake_rows()
    img = pack_image(kc, vc, block_size=8, n_data=2, quant=False)
    assert img.version == KVIMAGE_VERSION
    assert img.width == 16 and img.nbytes > 0
    img.validate(8, False)
    nar = img.narrowed(1)
    assert nar.width == 8 and nar.n_data == 1
    nar.validate(8, False)


def test_kvimage_mismatches_fail_typed():
    kc, vc = _fake_rows()
    img = pack_image(kc, vc, block_size=8, n_data=2, quant=False)
    with pytest.raises(KVImageError):
        img.validate(16, False)
    with pytest.raises(KVImageError):
        img.validate(8, True)
    bad = KVImage(KVIMAGE_VERSION + 1, 8, 2, False, img.header, img.kc,
                  img.vc, img.checksum)
    with pytest.raises(KVImageError):
        bad.validate(8, False)
    lies = KVImage(KVIMAGE_VERSION, 8, 3, False, img.header, img.kc,
                   img.vc, img.checksum)
    with pytest.raises(KVImageError):
        lies.validate(8, False)
    with pytest.raises(KVImageError):
        img.narrowed(3)


def test_kvimage_truncation_detected_by_header():
    kc, vc = _fake_rows()
    img = pack_image(kc, vc, block_size=8, n_data=2, quant=False)
    img.kc = img.kc[:, :, :, :8]
    with pytest.raises(KVImageError):
        img.validate(8, False)


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_wire_bytes_equal_the_jax_codec(quant):
    """One image's frame is the JAX codec's byte for byte, narrowed
    too; each package decodes the other's frame back to the same
    bytes."""
    rng = np.random.RandomState(0)
    if quant:
        host = [(rng.randint(-127, 128, (2, 1, 3, 16, 4)).astype(np.int8),
                 rng.rand(2, 1, 3, 16).astype(np.float32))
                for _ in range(2)]
        tor = [tuple(torch.from_numpy(a) for a in t) for t in host]
    else:
        host = [rng.randn(2, 1, 3, 16, 4).astype(np.float32)
                for _ in range(2)]
        tor = [torch.from_numpy(a) for a in host]
    jimg = jkvimage.pack_image(host[0], host[1], 8, 2, quant)
    timg = pack_image(tor[0], tor[1], 8, 2, quant)
    assert timg.to_bytes() == jimg.to_bytes()
    assert timg.narrowed(1).to_bytes() == jimg.narrowed(1).to_bytes()
    back = KVImage.from_bytes(jimg.to_bytes())
    back.validate(8, quant)
    assert back.to_bytes() == jimg.to_bytes()
    assert jkvimage.KVImage.from_bytes(timg.to_bytes()).to_bytes() \
        == jimg.to_bytes()


def test_wire_codec_refuses_bad_frames_typed():
    """Short, bad-magic, version-skewed, trailing-byte and bit-flipped
    frames raise ``KVImageError``; a bf16 image round-trips exactly."""
    kc = torch.randn(2, 1, 3, 16, 4).to(torch.bfloat16)
    img = pack_image(kc, kc.clone(), 8, 2)
    buf = img.to_bytes()
    back = KVImage.from_bytes(buf)
    back.validate(8)
    assert torch.equal(back.kc, kc)
    flip = bytearray(buf)
    flip[-10] ^= 1
    skew = bytearray(buf)
    skew[5] += 1
    for bad in (buf[:5], b"XXXX" + buf[4:], bytes(skew), buf + b"\0",
                bytes(flip), buf[:-20]):
        with pytest.raises(KVImageError):
            KVImage.from_bytes(bad)


def test_wire_codec_refuses_a_pickled_global():
    """Metadata that names a global (here ``os.system``, called on
    load by a plain ``pickle.loads``) is refused typed before anything
    is called; the frame is otherwise well formed."""
    kc = torch.zeros(1, 1, 1, 8, 2)
    buf = pack_image(kc, kc.clone(), 8, 1).to_bytes()
    head = kvimage_mod._WIRE_HEAD
    magic, version, quant, meta_len = head.unpack_from(buf, 0)

    class _Evil:
        def __reduce__(self):
            return (os.system, ("exit 3",))

    meta = pickle.dumps({"block_size": 8, "n_data": 1, "header": _Evil(),
                         "k_leaves": 1})
    evil = (head.pack(magic, version, quant, len(meta)) + meta
            + buf[head.size + meta_len:])
    with pytest.raises(KVImageError, match="global"):
        KVImage.from_bytes(evil)


def test_swap_roundtrips_through_image_and_rejects_mismatch(model):
    eng = model.serve(max_slots=2, **_disagg_kw())
    arena = eng.paged_arena
    blocks = arena.alloc(2)
    img = arena.swap_out(blocks, 2)
    before_k, _ = arena.gather_row(blocks, n_used=2)
    dst = arena.alloc(2)
    arena.swap_in(img, dst)
    after_k, _ = arena.gather_row(dst, n_used=2)
    assert torch.equal(before_k, after_k)
    alien = pack_image(img.kc, img.vc, block_size=BLOCK * 2, n_data=1)
    with pytest.raises(KVImageError):
        arena.swap_in(alien, dst)
    arena.free(blocks)
    arena.free(dst)
    eng.close()


# --------------------------------------------------------- router, index


def test_router_tiebreak_least_recently_routed():
    r = Router()
    views = [{"replica": i, "queue_depth": 0, "occupancy": 0.0,
              "tpot_ewma": None, "queue_headroom": None}
             for i in range(3)]
    assert r.rank(views) == [0, 1, 2]
    r.note_routed(0)
    assert r.rank(views) == [1, 2, 0]
    r.note_routed(1)
    assert r.rank(views) == [2, 0, 1]
    r.note_routed(2)
    r.note_routed(1)
    assert r.rank(views) == [0, 2, 1]
    views[0]["queue_depth"] = 3
    assert r.rank(views)[-1] == 0


def test_router_prefill_scoring_by_build_depth():
    r = Router()
    views = [{"replica": 0, "prefill_depth": 2},
             {"replica": 1, "prefill_depth": 0}]
    assert r.rank_prefill(views) == [1, 0]


def test_fleet_prefix_index_register_lookup_drop():
    idx = FleetPrefixIndex(4)
    toks = np.arange(12, dtype=np.int32)
    idx.register(toks, 3, replica=0)
    idx.register(toks, 2, replica=1)
    assert idx.holders(toks, 3) == [0]
    assert idx.holders(toks, 2) == [0, 1]
    assert idx.holders(np.arange(1, 13, dtype=np.int32), 2) == []
    idx.unregister(toks, 3, replica=0)
    assert idx.holders(toks, 3) == []
    assert idx.holders(toks, 2) == [1]
    idx.drop_replica(1)
    assert idx.holders(toks, 2) == []
    assert idx.snapshot()["indexed_blocks"] == 0


def test_fleet_prefix_index_bounded():
    idx = FleetPrefixIndex(4, max_blocks=6)
    prompts = [np.arange(i * 100, i * 100 + 12, dtype=np.int32)
               for i in range(4)]
    for p in prompts:
        idx.register(p, 3, replica=0)
        assert idx.snapshot()["indexed_blocks"] <= 6
    assert idx.holders(prompts[-1], 3) == [0]
    assert idx.holders(prompts[0], 3) == []


def test_roles_validation(model):
    with pytest.raises(ValueError, match="one role per replica"):
        ServeFleet(model, replicas=2, roles=("prefill",), max_slots=2,
                   **_disagg_kw())
    with pytest.raises(ValueError, match="unknown role"):
        ServeFleet(model, replicas=2, roles=("prefill", "verifier"),
                   max_slots=2, **_disagg_kw())
    with pytest.raises(ValueError, match="paged= AND prefix_cache="):
        ServeFleet(model, replicas=2, roles=("prefill", "decode"),
                   max_slots=2)


# ------------------------------------------------------- parity and ships


def test_disagg_streams_match_the_jax_disagg_fleet(pair):
    """Two long documents (shipped) and two chats (direct), half of them
    sampled, through a 1-prefill / 1-decode fleet of each package: the
    streams are equal and the ship counts too."""
    jm, m = pair
    work = [(_long(3), 4, 0.0, 1), (_long(4), 3, TEMP, 2)] + [
        (p, n, TEMP if i else 0.0, 10 + i)
        for i, (p, n) in enumerate(_chats(2))]
    jf = jm.serve_fleet(replicas=2, roles=("prefill", "decode"),
                        max_slots=2,
                        paged=JPagedConfig(block_size=BLOCK, num_blocks=48),
                        prefix_cache=JPrefixCacheConfig(block_size=BLOCK))
    jhs = [jf.submit(JRequest(p, max_new_tokens=n, temperature=t, seed=s))
           for p, n, t, s in work]
    jf.run_until_complete(max_steps=800)
    want = [np.asarray(h.result().tokens) for h in jhs]
    jships = jf.snapshot()["ships"]
    jf.close()
    with _fleet(m) as fleet:
        hs = [fleet.submit(GenerationRequest(p, max_new_tokens=n,
                                             temperature=t, seed=s))
              for p, n, t, s in work]
        fleet.run_until_complete(max_steps=800)
        for h, w in zip(hs, want):
            np.testing.assert_array_equal(h.result().tokens, w)
        assert fleet.snapshot()["ships"] == jships >= 2


def test_disagg_greedy_parity_ships_and_no_leaks(model):
    docs = [(_long(3), 4), (_long(4), 3)]
    work = docs + _chats(2)
    base = [_gen(model, p, n) for p, n in work]
    with _fleet(model) as fleet:
        hs = [fleet.submit(GenerationRequest(p, max_new_tokens=n,
                                             temperature=0.0))
              for p, n in work]
        fleet.run_until_complete(max_steps=800)
        for h, want in zip(hs, base):
            np.testing.assert_array_equal(h.result().tokens, want)
        snap = fleet.snapshot()
        assert snap["ships"] >= 2, snap
        assert snap["ship_bytes"] > 0
        assert snap["ship_fallbacks"] == 0
        assert snap["routed"]["0"] == 0
        assert snap["routed"]["1"] == len(work)
        dec = fleet.supervisor(1).engine.stats.snapshot()["prefix"]
        assert dec["hits"] >= 2
        assert all(n == 0 for n in _leaks(fleet)), _leaks(fleet)


def test_disagg_seeded_sampling_parity(model):
    p = _long(7, n=37)
    want = model.generate(p, max_new_tokens=6, temperature=TEMP,
                          rng=np.random.RandomState(21))
    seed = int(np.random.RandomState(21).randint(0, 2 ** 31 - 1))
    with _fleet(model) as fleet:
        h = fleet.submit(GenerationRequest(p, max_new_tokens=6,
                                           temperature=TEMP, seed=seed))
        fleet.run_until_complete(max_steps=400)
        np.testing.assert_array_equal(h.result().tokens, want)
        assert fleet.snapshot()["ships"] == 1


def test_disagg_int8_parity(model):
    p = _long(9, n=33)
    eng = model.serve(max_slots=2, cache_dtype="int8", **_disagg_kw())
    h0 = eng.submit(GenerationRequest(p, max_new_tokens=5,
                                      temperature=TEMP, seed=3))
    eng.run_until_complete(max_steps=300)
    want = h0.result().tokens
    eng.close()
    with _fleet(model, cache_dtype="int8") as fleet:
        h = fleet.submit(GenerationRequest(p, max_new_tokens=5,
                                           temperature=TEMP, seed=3))
        fleet.run_until_complete(max_steps=400)
        np.testing.assert_array_equal(h.result().tokens, want)
        assert fleet.snapshot()["ships"] == 1
        assert all(n == 0 for n in _leaks(fleet))


def test_warm_via_ship_equals_local_warm(model):
    p = _long(11, n=41)
    cold = _gen(model, p, 5)
    eng = model.serve(max_slots=2, **_disagg_kw())
    ha = eng.submit(GenerationRequest(p, max_new_tokens=5, temperature=0.0))
    eng.run_until_complete(max_steps=300)
    hb = eng.submit(GenerationRequest(p, max_new_tokens=5, temperature=0.0))
    eng.run_until_complete(max_steps=300)
    assert eng.stats.snapshot()["prefix"]["hits"] >= 1
    local_warm = hb.result().tokens
    eng.close()
    with _fleet(model) as fleet:
        hc = fleet.submit(GenerationRequest(p, max_new_tokens=5,
                                            temperature=0.0))
        fleet.run_until_complete(max_steps=400)
        shipped = hc.result().tokens
    np.testing.assert_array_equal(ha.result().tokens, cold)
    np.testing.assert_array_equal(local_warm, cold)
    np.testing.assert_array_equal(shipped, cold)


def test_shared_prefix_hits_across_replicas(model):
    p = _long(13, n=40)
    want = _gen(model, p, 4)
    with _fleet(model) as fleet:
        h1 = fleet.submit(GenerationRequest(p, max_new_tokens=4,
                                            temperature=0.0))
        fleet.run_until_complete(max_steps=400)
        h2 = fleet.submit(GenerationRequest(p, max_new_tokens=4,
                                            temperature=0.0))
        fleet.run_until_complete(max_steps=400)
        np.testing.assert_array_equal(h1.result().tokens, want)
        np.testing.assert_array_equal(h2.result().tokens, want)
        snap = fleet.snapshot()
        assert snap["shared_prefix_hits"] >= 1, snap
        assert snap["ships"] <= 2


def test_ship_queue_backpressure_falls_through_to_classic(model):
    docs = [(_long(31), 3), (_long(32), 3)]
    base = [_gen(model, p, n) for p, n in docs]
    with _fleet(model) as fleet:
        fleet._ship_queue_max = lambda: 1
        hs = [fleet.submit(GenerationRequest(p, max_new_tokens=n,
                                             temperature=0.0))
              for p, n in docs]
        assert len(fleet._ship_jobs) == 1
        fleet.run_until_complete(max_steps=500)
        for h, want in zip(hs, base):
            np.testing.assert_array_equal(h.result().tokens, want)
        snap = fleet.snapshot()
        assert snap["ships"] == 1
        assert snap["routed"]["1"] == 2


def test_short_prompt_routes_direct(model):
    p = np.arange(6, dtype=np.int32)
    want = _gen(model, p, 4)
    with _fleet(model) as fleet:
        h = fleet.submit(GenerationRequest(p, max_new_tokens=4,
                                           temperature=0.0))
        fleet.run_until_complete(max_steps=200)
        np.testing.assert_array_equal(h.result().tokens, want)
        snap = fleet.snapshot()
        assert snap["ships"] == 0
        assert snap["routed"]["1"] == 1 and snap["routed"]["0"] == 0


def test_degenerate_fleet_mixed_fallback(model):
    work = _chats(3, seed=5) + [(_long(15), 3)]
    base = [_gen(model, p, n) for p, n in work]
    with ServeFleet(model, replicas=1, roles=("prefill",), max_slots=2,
                    **_disagg_kw()) as fleet:
        hs = [fleet.submit(GenerationRequest(p, max_new_tokens=n,
                                             temperature=0.0))
              for p, n in work]
        fleet.run_until_complete(max_steps=600)
        for h, want in zip(hs, base):
            np.testing.assert_array_equal(h.result().tokens, want)
        assert fleet.snapshot()["ships"] == 0


def test_session_sticky_skips_ship(model):
    p = _long(17, n=40)
    with _fleet(model) as fleet:
        h = fleet.submit(GenerationRequest(p, max_new_tokens=4,
                                           temperature=0.0,
                                           pin_session=True))
        fleet.run_until_complete(max_steps=400)
        sess = h.result().session
        assert sess is not None
        req2 = sess.request(np.arange(4, dtype=np.int32), max_new_tokens=4,
                            temperature=0.0)
        h2 = fleet.submit(req2)
        fleet.run_until_complete(max_steps=400)
        np.testing.assert_array_equal(h2.result().tokens,
                                      _gen(model, req2.prompt_ids, 4))
        assert fleet.snapshot()["ships"] == 1
        sess.release()


# ------------------------------------------------------------ failure modes


def test_ship_fault_requeues_cold_with_parity(model):
    """An injected ``serve.kv_ship`` fault: the request (sampled) is
    requeued cold with the same stream, the fallback counted, no block
    leaked."""
    p = _long(19, n=40)
    want = _gen(model, p, 4, TEMP, 8)
    with _fleet(model) as fleet:
        pol = faults.inject("serve.kv_ship", FailOnce())
        h = fleet.submit(GenerationRequest(p, max_new_tokens=4,
                                           temperature=TEMP, seed=8))
        fleet.run_until_complete(max_steps=400)
        faults.clear()
        assert pol.fired == 1
        np.testing.assert_array_equal(h.result().tokens, want)
        snap = fleet.snapshot()
        assert snap["ships"] == 0 and snap["ship_fallbacks"] == 1
        assert snap["replicas_healthy"] == 2
        assert all(n == 0 for n in _leaks(fleet)), _leaks(fleet)


def test_prefill_specialist_killed_mid_ship(model):
    """A chunk fault with a zero restart budget kills the prefill
    specialist mid-build: the fleet fails it over and serves the
    mid-ship request and the chats after it cold on the decode replica.
    The chats arrive after the build's first step: the port's engines
    with a prefix cache admit cold prompts by chunk passes too, which
    check the same fault site (the JAX engine prefills them whole)."""
    work = [(_long(23), 3)] + _chats(3, seed=7)
    base = [_gen(model, p, n) for p, n in work]
    with ServeFleet(model, replicas=2, roles=("prefill", "decode"),
                    max_slots=2, restart_budget=0, **_disagg_kw()) as fleet:
        arena0 = fleet.supervisor(0).engine.paged_arena
        pol = faults.inject("serve.prefill_chunk", FailOnce())
        p, n = work[0]
        hs = [fleet.submit(GenerationRequest(p, max_new_tokens=n,
                                             temperature=0.0))]
        fleet.step()
        assert pol.fired == 1 and not fleet._replicas[0].healthy
        hs += [fleet.submit(GenerationRequest(p, max_new_tokens=n,
                                              temperature=0.0))
               for p, n in work[1:]]
        fleet.run_until_complete(max_steps=600)
        faults.clear()
        assert pol.fired == 1
        for h, want in zip(hs, base):
            assert h.done()
            np.testing.assert_array_equal(h.result().tokens, want)
        snap = fleet.snapshot()
        assert snap["replicas_healthy"] == 1 and snap["failovers"] == 1
        assert snap["ships"] == 0 and snap["ship_fallbacks"] == 1
        assert arena0.blocks_used == 0, arena0.blocks_used
        eng1 = fleet.supervisor(1).engine
        assert eng1.paged_arena.blocks_used \
            == eng1.prefix_cache.cached_blocks


def test_ledger_kv_ship_hop_and_ship_phase(model):
    p = _long(29, n=40)
    reqtrace.enable(capacity=64)
    try:
        with _fleet(model) as fleet:
            h = fleet.submit(GenerationRequest(p, max_new_tokens=4,
                                               temperature=0.0,
                                               request_id="shipped"))
            fleet.run_until_complete(max_steps=400)
            h.result()
        e = reqtrace.ledger().entry("shipped")
        vias = [hop["via"] for hop in e["hops"]]
        assert vias == ["prefill", "kv_ship"], vias
        final = e["hops"][e["final_hop"]]
        assert final["via"] == "kv_ship"
        assert final["src_replica"] == 0 and final["replica"] == 1
        assert final["ship_bytes"] > 0 and final["ship_blocks"] >= 1
        assert final["admit_kind"] == "warm"
        ph = e["phases"]
        assert ph["ship"] > 0
        assert ph["hops"] + ph["ship"] + ph["queue"] + ph["prefill"] \
            == pytest.approx(e["ttft_s"], abs=1e-9)
        assert sum(ph.values()) == pytest.approx(
            e["t_retire"] - e["t_submit"], abs=1e-9)
    finally:
        reqtrace.disable()
