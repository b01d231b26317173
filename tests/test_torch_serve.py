"""GPT-2 serving in the port (``models/gpt2_decode.py``, ``serve/``)
against the JAX package, from the same weights.

``GPT2Config.tiny(dropout=0.0)`` is built in both packages and the JAX
model's states are carried into the port by ``set_states``; then
``extract_params`` runs on both sides.  On the CPU the port's
``paged_attn`` runs its plain version (the kernel is held against it on
the card: tests/test_torch_kernels_cuda.py, ``chip_smoke.py``).

Tolerances: ``prefill``, ``decode_step`` and ``decode_step_paged``
logits and written K/V atol 1e-5 in float32 (the packages sum the same
terms in other orders; values O(1)).  Token streams are compared for
identity: greedy against the JAX package (``generate`` and one run of
its paged engine), greedy and sampled between the port's engine and its
offline ``generate`` (the port's sampling noise is keyed by seed and
position, not ``jax.random``), and between the paged kernel and the
gather oracle.
"""

import types

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
from singa_tpu.serve import PagedConfig as JPagedConfig
from singa_tpu_torch import device, tensor
from singa_tpu_torch.models import gpt2_decode as gd
from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from singa_tpu_torch.observe import SLO
from singa_tpu_torch.serve import (FIFOScheduler, GenerationRequest,
                                   PagedConfig, PriorityScheduler,
                                   QueueFullError)

ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model holding the JAX weights), eval mode."""
    ids = np.zeros((1, 16), np.int32)
    jm = JGPT2LMHead(JGPT2Config.tiny(dropout=0.0))
    jm.compile([jtensor.from_numpy(ids)], is_train=False, use_graph=False)
    cpu = device.create_cpu_device()
    tm = GPT2LMHead(GPT2Config.tiny(dropout=0.0))
    tm.compile([tensor.from_numpy(ids, cpu)], is_train=False)
    tm.set_states({k: jtensor.to_numpy(v)
                   for k, v in jm.get_states().items()})
    return jm, tm


@pytest.fixture(scope="module")
def params(models):
    jm, tm = models
    return jgd.extract_params(jm), gd.extract_params(tm)


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _workload(seed, n, p_lo=3, p_hi=30, n_lo=2, n_hi=14, sampled=True):
    rng = np.random.RandomState(seed)
    return [dict(prompt=rng.randint(0, 256, rng.randint(p_lo, p_hi))
                 .astype(np.int32),
                 n_new=int(rng.randint(n_lo, n_hi)),
                 temperature=(float(rng.choice([0.0, 0.9])) if sampled
                              else 0.0),
                 seed=int(rng.randint(0, 1000))) for _ in range(n)]


def _serve(tm, work, max_slots=3, **paged):
    eng = tm.serve(max_slots=max_slots,
                   paged=PagedConfig(**{"block_size": 8, "num_blocks": 64,
                                        **paged}))
    hs = [eng.submit(GenerationRequest(
        w["prompt"], max_new_tokens=w["n_new"],
        temperature=w["temperature"], seed=w["seed"])) for w in work]
    eng.run_until_complete(max_steps=2000)
    outs = [h.result().tokens for h in hs]
    used = eng.paged_arena.blocks_used
    eng.check_block_accounting()
    eng.close()
    return outs, used


def _offline(tm, work):
    return [tm.generate(w["prompt"], max_new_tokens=w["n_new"],
                        temperature=w["temperature"], seed=w["seed"])
            for w in work]


# ---------------------------------------------------------- decode math


def test_prefill_matches_jax(models, params):
    jm, tm = models
    jp, tp = params
    cfg = tm.cfg
    ids = np.random.RandomState(0).randint(0, 256, (2, 11)).astype(np.int32)
    jh, jk, jv = jgd.prefill(jp, jnp.asarray(ids), cfg.n_head,
                             cfg.layer_norm_eps)
    th, tk, tv = gd.prefill(tp, torch.from_numpy(ids), cfg.n_head,
                            cfg.layer_norm_eps)
    for j, t in ((jh, th), (jk, tk), (jv, tv)):
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=0, atol=ATOL)
    np.testing.assert_allclose(_np(gd._logits(th, tp)),
                               np.asarray(jgd._logits(jh, jp)),
                               rtol=0, atol=ATOL)


def test_decode_step_matches_jax(models, params):
    jm, tm = models
    jp, tp = params
    cfg = tm.cfg
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 256, (2, 10)).astype(np.int32)
    _, k, v = gd.prefill(tp, torch.from_numpy(ids), cfg.n_head,
                         cfg.layer_norm_eps)
    ctx, pos = 16, 10
    kc = np.zeros(k.shape[:3] + (ctx, k.shape[-1]), np.float32)
    vc = np.zeros_like(kc)
    kc[:, :, :, :pos], vc[:, :, :, :pos] = _np(k), _np(v)
    toks = rng.randint(0, 256, 2)
    x = _np(tp["wte"])[toks][:, None] + _np(tp["wpe"])[pos][None, None]
    jl, jkc, jvc = jgd.decode_step(jp, jnp.asarray(x), jnp.asarray(kc),
                                   jnp.asarray(vc), pos, cfg.n_head,
                                   cfg.layer_norm_eps)
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tl, tkc, tvc = gd.decode_step(tp, torch.from_numpy(x), tkc, tvc,
                                  torch.tensor([pos, pos]), cfg.n_head,
                                  cfg.layer_norm_eps)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0, atol=ATOL)
    np.testing.assert_allclose(_np(tkc), np.asarray(jkc), rtol=0, atol=ATOL)
    np.testing.assert_allclose(_np(tvc), np.asarray(jvc), rtol=0, atol=ATOL)


def test_decode_step_paged_matches_jax(models, params):
    """Three slots in one call (a partial last block, ``pos`` on a block
    boundary, a dead slot with an all-trash table) against the JAX
    function slot by slot: logits, and the written block against the
    JAX function's read-modify-written one."""
    jm, tm = models
    jp, tp = params
    cfg = tm.cfg
    B, N, L = 8, 12, cfg.n_layer
    d = cfg.n_embd // cfg.n_head
    rng = np.random.RandomState(2)
    pool_k = (0.5 * rng.randn(L, N + 1, cfg.n_kv_head, B, d)) \
        .astype(np.float32)
    pool_v = (0.5 * rng.randn(*pool_k.shape)).astype(np.float32)
    tables = np.full((3, 6), N, np.int32)
    tables[0, :2] = [5, 2]          # pos 13: lanes 0..12, lane 5 of block 2
    tables[1, :3] = [7, 0, 9]       # pos 16: block 9 is the fresh one
    pos = np.array([13, 16, 0], np.int32)
    live = np.array([True, True, False])
    toks = rng.randint(0, 256, 3)
    x = _np(tp["wte"])[toks][:, None] + _np(tp["wpe"])[pos][:, None]
    n_blk = int(((pos + B - 1) // B).max())
    tpk, tpv = torch.from_numpy(pool_k.copy()), torch.from_numpy(
        pool_v.copy())
    tl = gd.decode_step_paged(tp, torch.from_numpy(x), tpk, tpv,
                              torch.from_numpy(tables), torch.from_numpy(pos),
                              cfg.n_head, cfg.layer_norm_eps, block=B)
    for s in range(3):
        jl, kb, vb = jgd.decode_step_paged(
            jp, jnp.asarray(x[s:s + 1]), jnp.asarray(pool_k),
            jnp.asarray(pool_v), jnp.asarray(tables[s]), jnp.int32(pos[s]),
            jnp.int32(n_blk), cfg.n_head, cfg.layer_norm_eps, block=B,
            trash=N)
        np.testing.assert_allclose(_np(tl[s]), np.asarray(jl[0]), rtol=0,
                                   atol=ATOL)
        if live[s]:
            blk = tables[s, pos[s] // B]
            np.testing.assert_allclose(_np(tpk[:, blk]), np.asarray(kb),
                                       rtol=0, atol=ATOL)
            np.testing.assert_allclose(_np(tpv[:, blk]), np.asarray(vb),
                                       rtol=0, atol=ATOL)
    # blocks no live slot writes keep their bytes
    untouched = [b for b in range(N) if b not in (2, 9)]
    assert np.array_equal(_np(tpk[:, untouched]), pool_k[:, untouched])


def test_generate_greedy_matches_jax(models):
    jm, tm = models
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 256, n).astype(np.int32) for n in (7, 12, 3)]
    np.testing.assert_array_equal(
        tm.generate(prompts[0], max_new_tokens=9, temperature=0.0),
        np.asarray(jm.generate(prompts[0], max_new_tokens=9,
                               temperature=0.0)))
    want = jm.generate(prompts, max_new_tokens=6, temperature=0.0)
    for got, w in zip(tm.generate(prompts, max_new_tokens=6,
                                  temperature=0.0), want):
        np.testing.assert_array_equal(got, np.asarray(w))


# ---------------------------------------------------------------- engine


def test_engine_greedy_streams_match_the_jax_paged_engine(models):
    jm, tm = models
    work = _workload(4, 6, sampled=False)
    eng = jm.serve(max_slots=3,
                   paged=JPagedConfig(block_size=8, num_blocks=64))
    hs = [eng.submit(JRequest(w["prompt"], max_new_tokens=w["n_new"],
                              temperature=0.0)) for w in work]
    eng.run_until_complete(max_steps=2000)
    want = [np.asarray(h.result().tokens) for h in hs]
    eng.close()
    got, used = _serve(tm, work)
    assert used == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_engine_equals_generate_and_block_equals_gather(models):
    """Greedy and sampled requests in one pool: the paged kernel's
    streams, the gather oracle's and offline ``generate``'s are
    identical, and the drained pool holds no block."""
    _, tm = models
    work = _workload(5, 8)
    assert {w["temperature"] for w in work} == {0.0, 0.9}
    block, used_b = _serve(tm, work)
    gather, used_g = _serve(tm, work, kernel="gather")
    offline = _offline(tm, work)
    assert used_b == used_g == 0
    for a, b, c in zip(block, gather, offline):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_sampled_stream_depends_on_seed_and_position_only(models):
    """The same request alone, beside other traffic, and at another slot
    count gives the same stream; another seed gives another."""
    _, tm = models
    w = dict(prompt=np.arange(5, dtype=np.int32), n_new=12,
             temperature=0.9, seed=11)
    alone, _ = _serve(tm, [w], max_slots=1)
    crowd, _ = _serve(tm, _workload(6, 4) + [w], max_slots=4)
    np.testing.assert_array_equal(alone[0], crowd[-1])
    other, _ = _serve(tm, [dict(w, seed=12)], max_slots=1)
    assert not np.array_equal(alone[0], other[0])


@pytest.mark.parametrize("B,N", [(1, 64), (8, 16), (16, 16)])
def test_edge_geometry(models, B, N):
    """``tests/test_paged.py::test_kernel_edge_geometry`` in the port:
    prompts whose first decode write lands on a block boundary, short
    ones, a partial last block, each block size against offline
    ``generate``."""
    _, tm = models
    rng = np.random.RandomState(22)
    work = [dict(prompt=rng.randint(0, 256, plen).astype(np.int32),
                 n_new=n_new, temperature=float(rng.choice([0.0, 0.9])),
                 seed=int(rng.randint(0, 1000)))
            for plen, n_new in ((max(B, 4), 5), (2 * max(B, 2), 3), (3, 4),
                                (5, 2))]
    outs, used = _serve(tm, work, max_slots=2, block_size=B, num_blocks=N)
    assert used == 0
    for a, b in zip(outs, _offline(tm, work)):
        np.testing.assert_array_equal(a, b)


def test_one_block_lifetime(models):
    """One live request in a 4-slot pool (three dead lanes with all-trash
    tables in the same step) whose whole life fits block 0."""
    _, tm = models
    p = np.random.RandomState(9).randint(0, 256, 4).astype(np.int32)
    want = tm.generate(p, max_new_tokens=4, temperature=0.0)
    eng = tm.serve(max_slots=4, paged=PagedConfig(block_size=16,
                                                  num_blocks=8))
    h = eng.submit(GenerationRequest(p, max_new_tokens=4, temperature=0.0))
    peak = 0
    while eng.pending:
        eng.step()
        peak = max([peak] + [len(s.blocks) for s in eng._slots
                             if s is not None])
    np.testing.assert_array_equal(h.result().tokens, want)
    assert peak == 1
    assert eng.paged_arena.blocks_used == 0
    eng.close()


def test_admission_waits_for_blocks(models):
    """A request whose first blocks do not fit waits at the head of the
    queue and is admitted when a retiring request frees them."""
    _, tm = models
    work = [dict(prompt=np.arange(20, dtype=np.int32), n_new=3,
                 temperature=0.0, seed=0) for _ in range(3)]
    outs, used = _serve(tm, work, max_slots=3, block_size=8, num_blocks=6)
    assert used == 0
    for o in outs:
        np.testing.assert_array_equal(o, outs[0])


def test_slot_that_cannot_grow_fails_typed(models):
    """A live slot that needs a block when the pool has none and no
    lower-priority victim no longer fails the engine: it swaps itself
    out and resumes when blocks return, so two equal-priority requests
    that each need the whole pool drain one after the other, with the
    streams of offline ``generate`` and no block left."""
    _, tm = models
    p = np.arange(7, dtype=np.int32)
    eng = tm.serve(max_slots=2, paged=PagedConfig(block_size=8,
                                                  num_blocks=5))
    hs = [eng.submit(GenerationRequest(p + i, max_new_tokens=30))
          for i in range(2)]
    eng.run_until_complete(max_steps=200)
    for i, h in enumerate(hs):
        np.testing.assert_array_equal(
            h.result().tokens, tm.generate(p + i, max_new_tokens=30,
                                           temperature=0.0))
    snap = eng.stats.snapshot()["paged"]
    assert snap["preemptions"] >= 1 and snap["swap_in"] >= 1
    assert snap["blocks_used"] == 0
    eng.close()


@pytest.mark.parametrize("kw", [
    dict(prefix_cache=True), dict(draft_model="d"), dict(spec_k=4),
    dict(tp=2), dict(ep=2), dict(pp=2), dict(slo="slo"),
], ids=lambda kw: next(iter(kw)))
def test_engine_refuses_what_is_not_ported(models, kw):
    """Each engine argument still owed raises; ``prefix_cache``, ported
    since, builds the engine with its cache (its behaviour:
    tests/test_torch_prefix.py); ``draft_model`` (the model itself here)
    builds a speculative engine, and ``spec_k`` without a draft is the
    JAX engine's typed ``ValueError`` (their behaviour:
    tests/test_torch_spec.py); ``slo``, ported since, builds an engine
    counting violations against the ``observe.SLO`` (its behaviour:
    tests/test_torch_supervisor.py); ``tp`` and ``pp``, ported since,
    need a process group of their ranks (none here), and ``ep`` an MoE
    model, each refused typed (their behaviour:
    tests/test_torch_{tp,ep,pp}_serve.py)."""
    _, tm = models
    kw = {"paged": PagedConfig(block_size=8, num_blocks=8), **kw}
    if "slo" in kw:
        slo = SLO(ttft_p99_s=1.0, queue_depth_max=4)
        eng = tm.serve(**dict(kw, slo=slo))
        snap = eng.stats.snapshot()["slo"]
        assert snap["targets"] == slo.asdict()
        assert snap["violations"] == {"ttft": 0, "tpot": 0, "queue": 0}
        eng.close()
        return
    if "draft_model" in kw:
        eng = tm.serve(**dict(kw, draft_model=tm))
        assert eng.draft is tm and eng.spec_k == 4
        assert eng.stats.snapshot()["spec"]["drafted"] == 0
        eng.close()
        return
    if "spec_k" in kw:
        with pytest.raises(ValueError, match="without draft_model"):
            tm.serve(**kw)
        return
    if "prefix_cache" in kw:
        # True: the default PrefixCacheConfig, whose 64-token blocks the
        # arena must share
        eng = tm.serve(**dict(kw, paged=PagedConfig(block_size=64,
                                                    num_blocks=8)))
        assert eng.prefix_cache is not None
        assert eng.prefix_cache.block_size == 64
        eng.close()
        return
    match = ("on a dense model" if "ep" in kw
             else "needs a process group of exactly 2")
    with pytest.raises(ValueError, match=match):
        tm.serve(**kw)


def test_serve_with_no_arguments_runs_the_slot_arena(models):
    """``model.serve()`` with the defaults serves (the slot arena,
    ``paged=None``): greedy and sampled streams equal offline
    ``generate``."""
    _, tm = models
    work = _workload(12, 4)
    eng = tm.serve()
    assert eng.paged_arena is None and eng.max_slots == 8
    hs = [eng.submit(GenerationRequest(
        w["prompt"], max_new_tokens=w["n_new"],
        temperature=w["temperature"], seed=w["seed"])) for w in work]
    eng.run_until_complete(max_steps=500)
    for h, want in zip(hs, _offline(tm, work)):
        np.testing.assert_array_equal(h.result().tokens, want)
    eng.close()


def test_paged_engine_serves_int8_kv(models):
    """``cache_dtype="int8"`` serves on the paged engine, streams equal
    to offline int8 ``generate``, and a value other than None or
    "int8" raises."""
    _, tm = models
    work = _workload(13, 4)
    eng = tm.serve(max_slots=3, cache_dtype="int8",
                   paged=PagedConfig(block_size=8, num_blocks=64))
    assert eng.paged_arena.snapshot()["quant"]
    hs = [eng.submit(GenerationRequest(
        w["prompt"], max_new_tokens=w["n_new"],
        temperature=w["temperature"], seed=w["seed"])) for w in work]
    eng.run_until_complete(max_steps=500)
    for h, w in zip(hs, work):
        np.testing.assert_array_equal(h.result().tokens, tm.generate(
            w["prompt"], max_new_tokens=w["n_new"],
            temperature=w["temperature"], seed=w["seed"],
            cache_dtype="int8"))
    eng.close()
    with pytest.raises(ValueError, match="cache_dtype"):
        tm.serve(cache_dtype="int4")


@pytest.mark.parametrize("req", [
    dict(n=2), dict(structured=object()), dict(pin_session=True)],
    ids=["fork", "structured", "pin_session"])
def test_submit_refuses_what_is_not_ported(models, req):
    """Each of these request options, once owed, is ported now: ``n = 2``
    is served as a fork group of two branches (tests/test_torch_fork.py),
    a ``structured`` object that is not a token automaton is refused
    typed when the request is made (``ValueError``, as the JAX package
    refuses it), and ``pin_session`` is served: without a prefix cache the
    result carries a session handle that pins nothing (with one:
    tests/test_torch_prefix.py)."""
    _, tm = models
    eng = tm.serve(paged=PagedConfig(block_size=8, num_blocks=8))
    if "structured" in req:
        with pytest.raises(ValueError, match="token automaton"):
            GenerationRequest(np.arange(3), max_new_tokens=2, **req)
        eng.close()
        return
    h = eng.submit(GenerationRequest(np.arange(3), max_new_tokens=2, **req))
    eng.run_until_complete(max_steps=20)
    if "n" in req:
        res = h.results()
        assert [r.branch for r in res] == [0, 1]
        assert all(len(r.tokens) == 5 for r in res)
        eng.close()
        return
    sess = h.result().session
    assert sess is not None and sess.pinned_blocks == 0
    np.testing.assert_array_equal(sess.tokens, h.result().tokens)
    eng.close()


def test_features_still_owed_raise(models):
    """MoE decode, beam search, the chunked-prefill budget, the admission
    interleave and sliding-window decode, ported since, are accepted
    (their behaviour: tests/test_torch_moe.py, tests/test_torch_beam.py,
    tests/test_torch_longctx.py); a MoE ``moe_top_k`` other than 1 or 2
    raises."""
    _, tm = models
    gd.check_decodable(types.SimpleNamespace(moe_every=2))
    gd.check_decodable(GPT2Config.tiny(moe_every=2, moe_top_k=1))
    with pytest.raises(ValueError, match="moe_top_k"):
        gd.check_decodable(types.SimpleNamespace(moe_every=2, moe_top_k=3))
    out = gd.generate_beam(tm, np.arange(3), max_new_tokens=2, num_beams=2)
    assert out.shape == (5,)
    with pytest.raises(ValueError, match="num_beams"):
        gd.generate_beam(tm, np.arange(3), max_new_tokens=2, num_beams=0)
    assert PagedConfig(prefill_token_budget=32).prefill_token_budget == 32
    assert PagedConfig(admit_per_step=2).admit_per_step == 2
    windowed = GPT2LMHead(GPT2Config.tiny(dropout=0.0, attn_window=16))
    gd.check_decodable(windowed.cfg)
    assert gd._norm_window(windowed.cfg) == 16


def test_submit_validation_and_queue_limits(models):
    _, tm = models
    eng = tm.serve(paged=PagedConfig(block_size=8, num_blocks=4),
                   scheduler=FIFOScheduler(max_queue_depth=1))
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(GenerationRequest(np.arange(100), max_new_tokens=40))
    with pytest.raises(ValueError, match="KV blocks"):
        eng.submit(GenerationRequest(np.arange(30), max_new_tokens=10))
    eng.submit(GenerationRequest(np.arange(3), max_new_tokens=2))
    with pytest.raises(QueueFullError):
        eng.submit(GenerationRequest(np.arange(3), max_new_tokens=2))
    eng.run_until_complete(max_steps=50)
    snap = eng.stats.snapshot()
    assert snap["requests"]["completed"] == 1
    assert snap["requests"]["rejected_queue_full"] == 1
    assert snap["latency"]["ttft"]["count"] == 1
    eng.close()


def test_deadline_and_priority_order():
    now = [0.0]
    pq = PriorityScheduler()
    reqs = [GenerationRequest(np.arange(2), priority=p, request_id=f"p{i}")
            for i, p in enumerate((0, 2, 1, 2))]
    for r in reqs:
        pq.enqueue(r)
    admit, _ = pq.schedule(4, now[0])
    assert [r.request_id for r in admit] == ["p1", "p3", "p2", "p0"]
    fifo = FIFOScheduler()
    late = GenerationRequest(np.arange(2), deadline=1.0)
    fifo.enqueue(late)
    admit, expired = fifo.schedule(0, 2.0)
    assert admit == [] and expired == [late]


def test_gqa_generate_and_engine(models):
    """GQA (n_kv_head 2 of 4): the cache and pool keep 2 heads, each
    serving a group of 2 queries; greedy ``generate`` equals the JAX
    package's and the engine equals ``generate``."""
    ids = np.zeros((1, 16), np.int32)
    jm = JGPT2LMHead(JGPT2Config.tiny(dropout=0.0, n_kv_head=2))
    jm.compile([jtensor.from_numpy(ids)], is_train=False, use_graph=False)
    tm = GPT2LMHead(GPT2Config.tiny(dropout=0.0, n_kv_head=2))
    tm.compile([tensor.from_numpy(ids, device.create_cpu_device())],
               is_train=False)
    tm.set_states({k: jtensor.to_numpy(v)
                   for k, v in jm.get_states().items()})
    p = np.random.RandomState(7).randint(0, 256, 9).astype(np.int32)
    np.testing.assert_array_equal(
        tm.generate(p, max_new_tokens=8, temperature=0.0),
        np.asarray(jm.generate(p, max_new_tokens=8, temperature=0.0)))
    work = _workload(8, 5)
    outs, used = _serve(tm, work)
    assert used == 0
    assert gd.extract_params(tm)["blocks"][0]["wk"].shape == (64, 32)
    for a, b in zip(outs, _offline(tm, work)):
        np.testing.assert_array_equal(a, b)


def test_arena_copies_and_reference_counts():
    """``scatter_row`` / ``gather_row`` round-trip a cache row through
    pool blocks (a row narrower than its blocks leaves their tails),
    and a block shared by two holders returns to the free list only at
    its last ``free``."""
    from singa_tpu_torch.serve import PagedKVArena

    arena = PagedKVArena(PagedConfig(block_size=4, num_blocks=6), 2, 3, 8,
                         torch.float32, 16, torch.device("cpu"))
    blocks = arena.alloc(3)
    assert arena.blocks_used == 3 and arena.alloc(4) is None
    row_k = torch.randn(2, 1, 3, 10, 8)
    row_v = torch.randn(2, 1, 3, 10, 8)
    arena.scatter_row(row_k, row_v, dict(enumerate(blocks)))
    got_k, got_v = arena.gather_row(blocks)
    assert torch.equal(got_k[:, :, :, :10], row_k)
    assert torch.equal(got_v[:, :, :, :10], row_v)
    assert torch.equal(arena.gather_row(blocks, n_used=2)[0][:, :, :, 8:],
                       torch.zeros(2, 1, 3, 4, 8))
    arena.share(blocks[:1])
    assert arena.ref_count(blocks[0]) == 2
    arena.free(blocks)
    assert arena.blocks_used == 1 and arena.snapshot()["shared_blocks"] == 0
    arena.free(blocks[:1])
    assert arena.blocks_used == 0
    arena.unregister()
