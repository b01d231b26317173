"""The port's radix prefix cache and sessions (``serve/prefix.py``, the
engine's ``prefix_cache=`` and ``pin_session``) against offline
``generate``, the engine without a cache and the JAX engine with one,
from the same weights: the counterparts of ``tests/test_prefix.py``'s
tests of what the port brings, on ``GPT2Config.tiny`` (2 layers, 64
wide), block size 8, on both arenas (``paged=None``, the slot arena with
the cache's own pool, and the paged arena, whose tree shares the
arena's blocks).

Every engine here is driven step by step through ``_drain``, which
checks the block accounting (``used == cached + live_referenced``)
after every step.

Token streams are compared for identity: greedy float32 streams with
the cache (warm, and the cold chunked admissions that filled it) equal
offline ``generate`` and the cache-less engine whole, and equal the JAX
engine's warm streams (weights carried by ``save_states``); a sampled
warm stream equals the port's own seeded ``generate`` (the same
threefry key chain).  On int8 KV,
where the chunked prefill attends dequantized keys and the full prefill
float ones, warm streams equal the same engine's cold ones.
``prefill_chunk`` itself is held against the JAX function at atol 1e-5
(dense) and its int8 rows exactly in values, scales rtol 1e-6.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU: tests/conftest.py)
import jax.numpy as jnp
import torch

from singa_tpu import tensor as jtensor
from singa_tpu.models import gpt2_decode as jgd
from singa_tpu.models.gpt2 import GPT2Config as JGPT2Config
from singa_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from singa_tpu.serve import GenerationRequest as JRequest
from singa_tpu.serve import PrefixCacheConfig as JPrefixCacheConfig
from singa_tpu_torch import device, tensor
from singa_tpu_torch.models import gpt2_decode as gd
from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from singa_tpu_torch.serve import (GenerationRequest, PagedConfig,
                                   PrefixCacheConfig, SessionHandle,
                                   jit_cache_size)

BS = 8
CPU = device.create_cpu_device()
ARENAS = {"slots": None, "paged": dict(block_size=BS, num_blocks=64)}


def _port_model(jm=None, tmp_path=None, **kw):
    m = GPT2LMHead(GPT2Config.tiny(dropout=0.0, **kw))
    m.compile([tensor.from_numpy(np.zeros((1, 16), np.int32), CPU)],
              is_train=False)
    if jm is not None:
        path = str(tmp_path / "jax_gpt2.zip")
        jm.save_states(path)
        m.load_states(path)
    return m


@pytest.fixture(scope="module")
def model():
    CPU.SetRandSeed(0)
    return _port_model()


def _prompts(vocab=256, n_shared_blocks=3, n_tails=4, seed=0):
    """A shared system prompt of whole blocks plus ragged tails."""
    rng = np.random.RandomState(seed)
    system = rng.randint(0, vocab, n_shared_blocks * BS).astype(np.int32)
    return [np.concatenate([system, rng.randint(
        0, vocab, rng.randint(3, 2 * BS)).astype(np.int32)])
        for _ in range(n_tails)]


def _serve(m, arena, num_blocks=64, cache=True, **kw):
    paged = ARENAS[arena]
    if paged is not None:
        paged = PagedConfig(**paged)
    if cache:
        kw["prefix_cache"] = PrefixCacheConfig(block_size=BS,
                                               num_blocks=num_blocks)
    return m.serve(paged=paged, **kw)


def _drain(eng, max_steps=500):
    for _ in range(max_steps):
        if not eng.pending:
            break
        eng.step()
        eng.check_block_accounting()
    assert not eng.pending


def _run(eng, prompts, news, **kw):
    hs = [eng.submit(GenerationRequest(p, max_new_tokens=n, **kw))
          for p, n in zip(prompts, news)]
    _drain(eng)
    return [h.result().tokens for h in hs]


def _generate(m, prompts, news, **kw):
    return [m.generate(p, max_new_tokens=n, temperature=0, **kw)
            for p, n in zip(prompts, news)]


@pytest.fixture(scope="module")
def jax_warm(tmp_path_factory):
    """The JAX engine with a prefix cache: its model, and its round-2
    (warm) greedy streams of ``_prompts()``."""
    jm = JGPT2LMHead(JGPT2Config.tiny(dropout=0.0))
    jm.compile([jtensor.from_numpy(np.zeros((1, 16), np.int32))],
               is_train=False, use_graph=False)
    eng = jm.serve(max_slots=2, prefix_cache=JPrefixCacheConfig(
        block_size=BS, num_blocks=64))
    prompts, news = _prompts(), [5, 3, 5, 3]
    for _ in range(2):
        hs = [eng.submit(JRequest(p, max_new_tokens=n))
              for p, n in zip(prompts, news)]
        eng.run_until_complete(max_steps=500)
    assert eng.stats.snapshot()["prefix"]["hits"] >= len(prompts)
    streams = [np.asarray(h.result().tokens) for h in hs]
    eng.close()
    return jm, streams, tmp_path_factory.mktemp("prefix")


@pytest.mark.parametrize("arena", ARENAS)
def test_warm_streams_equal_cold_generate_and_jax(jax_warm, arena):
    """Round 2 over a populated cache: the warm streams equal offline
    ``generate``, the engine without a cache and the JAX engine's warm
    streams; no decode step is prepared in round 2 that round 1 did not
    prepare (a warm slot changes only its block table's contents)."""
    jm, jax_streams, tmp = jax_warm
    m = _port_model(jm, tmp)
    prompts, news = _prompts(), [5, 3, 5, 3]
    eng = _serve(m, arena, max_slots=2)
    cold = _run(eng, prompts, news)
    census = jit_cache_size()
    widths = set(eng._steps)
    warm = _run(eng, prompts, news)
    assert jit_cache_size() == census and set(eng._steps) == widths
    snap = eng.stats.snapshot()["prefix"]
    assert snap["hits"] >= len(prompts) and snap["hit_tokens"] > 0
    assert snap["lookup_tokens"] >= 2 * sum(len(p) for p in prompts)
    assert snap["hit_rate_tokens"] > 0.3, snap
    assert eng.stats.snapshot()["latency"]["admission"]["warm"]["count"] \
        >= len(prompts)
    plain = _serve(m, arena, cache=False, max_slots=2)
    uncached = _run(plain, prompts, news)
    for c, w, u, g, j in zip(cold, warm, uncached,
                             _generate(m, prompts, news), jax_streams):
        np.testing.assert_array_equal(w, g)
        np.testing.assert_array_equal(c, g)
        np.testing.assert_array_equal(u, g)
        np.testing.assert_array_equal(w, j)
    if arena == "paged":
        assert eng.check_block_accounting() == \
            eng.prefix_cache.cached_blocks > 0
        assert plain.check_block_accounting() == 0
    eng.close()
    plain.close()


@pytest.mark.parametrize("arena", ARENAS)
def test_warm_sampled_stream_matches_seeded_generate(model, arena):
    prompts = _prompts()
    eng = _serve(model, arena, max_slots=2)
    _run(eng, prompts[:1], [3])
    h = eng.submit(GenerationRequest(prompts[1], max_new_tokens=8,
                                     temperature=0.8, seed=1234))
    _drain(eng)
    assert eng.stats.snapshot()["prefix"]["hits"] >= 1
    want = model.generate(prompts[1], max_new_tokens=8, temperature=0.8,
                          seed=1234)
    np.testing.assert_array_equal(h.result().tokens, want)
    eng.close()


@pytest.mark.parametrize("arena", ARENAS)
def test_warm_gqa_stream_matches_generate(arena):
    CPU.SetRandSeed(1)
    m = _port_model(n_kv_head=2)
    prompts, news = _prompts()[:3], [4, 4, 4]
    eng = _serve(m, arena, max_slots=1)
    got = _run(eng, prompts, news)
    assert eng.stats.snapshot()["prefix"]["hits"] >= 2
    for g, w in zip(got, _generate(m, prompts, news)):
        np.testing.assert_array_equal(g, w)
    eng.close()


@pytest.mark.parametrize("arena", ARENAS)
def test_refcounts_pin_matched_path_across_flight(model, arena):
    """Matched nodes hold a reference while the request is in flight and
    drop it at retire; on the paged arena the slot's table points at the
    tree's blocks (shared, one reference each from the slot)."""
    prompts = _prompts()
    eng = _serve(model, arena, max_slots=1)
    _run(eng, prompts[:1], [2])
    cache = eng.prefix_cache
    assert cache.cached_blocks >= 3
    h2 = eng.submit(GenerationRequest(prompts[1], max_new_tokens=4))
    eng.step()
    eng.check_block_accounting()
    slot = next(s for s in eng._slots if s is not None)
    assert slot.prefix_nodes, "warm admission matched no blocks"
    assert all(n.refs == 1 for n in slot.prefix_nodes)
    if arena == "paged":
        k = len(slot.prefix_nodes)
        assert slot.n_shared == k
        assert slot.blocks[:k] == [n.block for n in slot.prefix_nodes]
        assert all(eng.paged_arena.ref_count(b) == 2
                   for b in slot.blocks[:k])
        assert eng._block_tables([0])[0, :k].tolist() == slot.blocks[:k]
    _drain(eng)
    assert all(n.refs == 0 for n in slot.prefix_nodes)
    assert h2.result().finish_reason == "length"
    if arena == "paged":
        assert eng.paged_arena.snapshot()["shared_blocks"] == 0
    eng.close()


@pytest.mark.parametrize("arena", ARENAS)
def test_lru_eviction_never_frees_referenced_blocks(model, arena):
    """Under pool pressure eviction takes unreferenced leaves only: a
    pinned session's path survives churn; pressure with nothing
    evictable degrades to skipped donations (the slot arena) or to
    admissions that evict (the paged arena), never an error."""
    rng = np.random.RandomState(3)
    pinned_prompt = rng.randint(0, 256, 3 * BS).astype(np.int32)
    if arena == "paged":
        eng = model.serve(max_slots=1, paged=PagedConfig(
            block_size=BS, num_blocks=8), prefix_cache=PrefixCacheConfig(
                block_size=BS))
    else:
        eng = _serve(model, arena, num_blocks=4, max_slots=1)
    h = eng.submit(GenerationRequest(pinned_prompt, max_new_tokens=2,
                                     pin_session=True))
    _drain(eng)
    sess = h.result().session
    cache = eng.prefix_cache
    pinned = {n.block for n in sess._nodes}
    assert sess.pinned_blocks >= 3
    for _ in range(4):
        p = rng.randint(0, 256, 2 * BS + 3).astype(np.int32)
        got = _run(eng, [p], [2])
        np.testing.assert_array_equal(got[0], _generate(model, [p], [2])[0])
    snap = eng.stats.snapshot()["prefix"]
    if arena == "slots":
        assert snap["donate_skipped"] > 0, snap
    else:
        assert snap["evictions"] > 0, snap
    assert {n.block for n in sess._nodes} == pinned
    assert all(n.refs >= 1 for n in sess._nodes)
    assert len(cache.lookup(pinned_prompt)) == 3
    sess.release()
    assert sess.pinned_blocks == 0
    before = eng.stats.snapshot()["prefix"]["evictions"]
    for _ in range(3):
        _run(eng, [rng.randint(0, 256, 2 * BS + 3).astype(np.int32)], [2])
    assert eng.stats.snapshot()["prefix"]["evictions"] > before
    eng.close()


@pytest.mark.parametrize("arena", ARENAS)
def test_session_continuation_parity_multi_turn(model, arena):
    """Turn 2 re-sends the whole turn-1 conversation: equal to the cold
    oracle, nearly all of its prompt from cached blocks (the generated
    region was recomputed through ``prefill_chunk`` at retire); turn 3
    chains from turn 2."""
    prompts = _prompts()
    eng = _serve(model, arena, max_slots=2)
    h = eng.submit(GenerationRequest(prompts[0], max_new_tokens=9,
                                     pin_session=True))
    _drain(eng)
    sess = h.result().session
    assert isinstance(sess, SessionHandle)
    np.testing.assert_array_equal(sess.tokens, h.result().tokens)
    before = eng.stats.snapshot()["prefix"]["hit_tokens"]
    req2 = sess.request(np.asarray([7, 3, 11, 2], np.int32),
                        max_new_tokens=5, pin_session=True)
    assert req2.session_of is sess
    h2 = eng.submit(req2)
    _drain(eng)
    np.testing.assert_array_equal(
        h2.result().tokens, _generate(model, [req2.prompt_ids], [5])[0])
    gained = eng.stats.snapshot()["prefix"]["hit_tokens"] - before
    assert gained >= (len(sess.tokens) // BS - 1) * BS, gained
    sess2 = h2.result().session
    assert len(sess2.tokens) > len(sess.tokens)
    req3 = sess2.request([5, 5], max_new_tokens=4)
    h3 = eng.submit(req3)
    _drain(eng)
    np.testing.assert_array_equal(
        h3.result().tokens, _generate(model, [req3.prompt_ids], [4])[0])
    assert h3.result().session is None
    sess.release()
    sess2.release()
    eng.close()


@pytest.mark.parametrize("arena", ARENAS)
def test_session_continues_on_a_rebuilt_engine(model, arena):
    """A session handle owns host tokens: on a new engine (an empty
    cache) and on one without a cache, the next turn runs cold with the
    bytes an uninterrupted conversation would give."""
    prompts = _prompts()
    eng = _serve(model, arena, max_slots=2)
    h = eng.submit(GenerationRequest(prompts[0], max_new_tokens=6,
                                     pin_session=True))
    _drain(eng)
    sess = h.result().session
    eng.close()
    rebuilt = _serve(model, arena, max_slots=2)
    assert rebuilt.prefix_cache.cached_blocks == 0
    req2 = sess.request(np.asarray([9, 9, 4], np.int32), max_new_tokens=5)
    want = _generate(model, [req2.prompt_ids], [5])[0]
    h2 = rebuilt.submit(req2)
    _drain(rebuilt)
    np.testing.assert_array_equal(h2.result().tokens, want)
    rebuilt.close()
    plain = _serve(model, arena, cache=False, max_slots=1)
    h3 = plain.submit(GenerationRequest(prompts[1], max_new_tokens=3,
                                        pin_session=True))
    _drain(plain)
    s3 = h3.result().session
    assert s3 is not None and s3.pinned_blocks == 0
    np.testing.assert_array_equal(s3.tokens, h3.result().tokens)
    plain.close()


@pytest.mark.parametrize("arena", ARENAS)
def test_pool_pressure_falls_back_to_cold_prefill(model, arena):
    """A pool that can cache almost nothing: every request still
    completes with exact parity, cold, and nothing raises."""
    prompts, news = _prompts(), [3, 3, 3, 3]
    if arena == "paged":
        # two requests' blocks fill the pool: admissions evict what the
        # tree took from the earlier ones
        eng = model.serve(max_slots=2, paged=PagedConfig(
            block_size=BS, num_blocks=6), prefix_cache=PrefixCacheConfig(
                block_size=BS))
    else:
        eng = _serve(model, arena, num_blocks=1, max_slots=2)
    got = _run(eng, prompts, news)
    got2 = _run(eng, prompts, news)
    for a, b, w in zip(got, got2, _generate(model, prompts, news)):
        np.testing.assert_array_equal(a, w)
        np.testing.assert_array_equal(b, w)
    snap = eng.stats.snapshot()["prefix"]
    if arena == "slots":
        assert snap["donate_skipped"] > 0 and snap["cached_blocks"] <= 1
    else:
        assert snap["evictions"] > 0
    eng.close()


def test_prefix_cache_config_validation(model):
    with pytest.raises(ValueError, match="multiple"):
        model.serve(max_slots=1,
                    prefix_cache=PrefixCacheConfig(block_size=13))
    with pytest.raises(ValueError, match="block_size"):
        PrefixCacheConfig(block_size=0)
    with pytest.raises(ValueError, match="num_blocks"):
        PrefixCacheConfig(num_blocks=0)
    with pytest.raises(ValueError, match="prefix_cache"):
        model.serve(max_slots=1, prefix_cache="yes")
    with pytest.raises(ValueError, match="paged block_size"):
        model.serve(max_slots=1, paged=PagedConfig(block_size=8),
                    prefix_cache=PrefixCacheConfig(block_size=16))
    # an empty kwargs dict means "enable with defaults", not "off"
    eng = model.serve(max_slots=1, prefix_cache={})
    assert eng.prefix_cache is not None
    assert eng.prefix_cache.block_size == 64
    eng.close()
    eng = model.serve(max_slots=1, prefix_cache=True,
                      paged=PagedConfig(block_size=64, num_blocks=8))
    assert eng.prefix_cache.num_blocks == 8
    eng.close()


@pytest.mark.parametrize("arena", ARENAS)
def test_int8_pools_with_a_cache(model, arena):
    """int8 KV with a cache: every admission prefills in chunks over the
    quantized row, so the warm streams equal the same engine's cold
    ones, the int8 pools carry (values, scales) pairs through the tree,
    and sessions continue warm."""
    prompts, news = _prompts(), [5, 3, 5, 3]
    eng = _serve(model, arena, max_slots=2, cache_dtype="int8")
    cold = _run(eng, prompts, news)
    warm = _run(eng, prompts, news)
    assert eng.stats.snapshot()["prefix"]["hits"] >= len(prompts)
    for c, w in zip(cold, warm):
        np.testing.assert_array_equal(c, w)
    pool = eng.prefix_cache._pool_k if arena == "slots" \
        else eng.paged_arena.pool_k
    assert isinstance(pool, tuple) and pool[0].dtype == torch.int8
    h = eng.submit(GenerationRequest(prompts[0], max_new_tokens=6,
                                     pin_session=True))
    _drain(eng)
    sess = h.result().session
    req = sess.request([1, 2, 3], max_new_tokens=4)
    h2 = eng.submit(req)
    _drain(eng)
    fresh = _serve(model, arena, max_slots=2, cache_dtype="int8")
    h3 = fresh.submit(GenerationRequest(req.prompt_ids, max_new_tokens=4))
    _drain(fresh)
    np.testing.assert_array_equal(h2.result().tokens, h3.result().tokens)
    sess.release()
    eng.close()
    fresh.close()


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "int8"])
def test_prefill_chunk_matches_jax(quant):
    """``prefill_chunk`` at an offset over a row holding the prefix's
    K/V, against the JAX function on the same weights and row."""
    jm = JGPT2LMHead(JGPT2Config.tiny(dropout=0.0, n_kv_head=2))
    jm.compile([jtensor.from_numpy(np.zeros((1, 16), np.int32))],
               is_train=False, use_graph=False)
    tm = _port_model(n_kv_head=2)
    tm.set_states({k: jtensor.to_numpy(v)
                   for k, v in jm.get_states().items()})
    jp, tp = jgd.extract_params(jm), gd.extract_params(tm)
    rng = np.random.RandomState(7)
    ids = rng.randint(0, 256, (1, 40)).astype(np.int32)
    # the row: full prefill of positions < 24 (the JAX function's K/V)
    _, jk, jv = jgd.prefill(jp, jnp.asarray(ids[:, :24]), 4, 1e-5,
                            quant_cache=quant)
    W, pos, K = 48, 24, 8

    def pad(c):
        def one(a):
            w = [(0, 0)] * a.ndim
            w[3] = (0, W - a.shape[3])
            return np.pad(np.asarray(a), w)
        return tuple(one(a) for a in c) if quant else one(c)

    jk, jv = pad(jk), pad(jv)
    x = (np.asarray(jp["wte"])[ids[0, pos:pos + K]]
         + np.asarray(jp["wpe"])[pos:pos + K])[None]
    jh, jk2, jv2 = jgd.prefill_chunk(
        jp, jnp.asarray(x),
        jax.tree.map(jnp.asarray, jk), jax.tree.map(jnp.asarray, jv),
        jnp.int32(pos), 4, 1e-5)

    def th(c):
        return tuple(torch.from_numpy(a.copy()) for a in c) if quant \
            else torch.from_numpy(c.copy())

    tk, tv = th(jk), th(jv)
    h, tk, tv = gd.prefill_chunk(tp, torch.from_numpy(x), tk, tv, pos, 4,
                                 1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0,
                               atol=1e-5)
    for got, want in ((tk, jk2), (tv, jv2)):
        if quant:
            np.testing.assert_array_equal(got[0].numpy()[..., pos:pos + K, :],
                                          np.asarray(want[0])[..., pos:pos + K,
                                                              :])
            np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                       rtol=1e-6, atol=0)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-5)
