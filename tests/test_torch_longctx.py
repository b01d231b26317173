"""Long-context serving in the port against the JAX package, from the
same weights: sliding-window decode (``prefill``'s rolling cache,
``decode_step``, ``prefill_chunk``, ``decode_step_paged`` and
``chunk_step_paged`` with a window, offline windowed ``generate``, the
paged engine on a windowed model, which drops the blocks that left a
slot's window) and the chunked-prefill token budget with the admission
interleave (``PagedConfig(prefill_token_budget=, admit_per_step=)``).

``GPT2Config.tiny`` (2 layers, 64 wide, 128 positions); the windowed
model is the same weights with ``attn_window=16``; block size 8, float32.
Weights cross from the JAX models by ``save_states`` / ``load_states``
zips.  Tolerances: logits, hidden rows and written K/V atol 1e-5 (values
O(1), the packages sum in other orders); int8 caches equal in values,
rtol 1e-6 in scales.  Token streams are compared for identity, greedy
ones against the JAX package.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU: tests/conftest.py)
import jax.numpy as jnp
import torch

from singa_tpu import device as jdevice
from singa_tpu import tensor as jtensor
from singa_tpu.models import gpt2_decode as jgd
from singa_tpu.models.gpt2 import GPT2Config as JGPT2Config
from singa_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from singa_tpu.serve import GenerationRequest as JRequest
from singa_tpu.serve import PagedConfig as JPagedConfig
from singa_tpu_torch import device, tensor
from singa_tpu_torch.models import gpt2_decode as gd
from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from singa_tpu_torch.resilience import FailAfterN, faults
from singa_tpu_torch.serve import (EngineFailedError, GenerationRequest,
                                   PagedConfig, PrefixCacheConfig)

ATOL = 1e-5
B = 8
W = 2 * B
CPU = device.create_cpu_device()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models: one intra-op thread a process is faster than many,
    and keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(**kw):
    m = JGPT2LMHead(JGPT2Config.tiny(dropout=0.0, **kw))
    m.compile([jtensor.from_numpy(np.zeros((1, 16), np.int32))],
              is_train=False, use_graph=False)
    return m


def _port(path, **kw):
    m = GPT2LMHead(GPT2Config.tiny(dropout=0.0, **kw))
    m.compile([tensor.from_numpy(np.zeros((1, 16), np.int32), CPU)],
              is_train=False)
    m.load_states(path)
    return m


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX dense, JAX windowed, port dense, port windowed, port 1-layer
    draft): one set of weights; the draft holds the dense model's
    embeddings, first block and final LN.  The JAX device's generator is
    seeded (unseeded it draws from ``os.urandom``): the same weights every
    run."""
    path = str(tmp_path_factory.mktemp("longctx") / "gpt2.zip")
    jdevice.get_default_device().SetRandSeed(0)
    jm = _jax_model()
    jm.save_states(path)
    jw = _jax_model(attn_window=W)
    jw.set_states(jm.get_states())
    tm, tw = _port(path), _port(path, attn_window=W)
    dr = GPT2LMHead(GPT2Config.tiny(dropout=0.0, n_layer=1))
    dr.compile([tensor.from_numpy(np.zeros((1, 16), np.int32), CPU)],
               is_train=False)
    states = tm.get_states()
    dr.set_states({k: states[k] for k in dr.get_states()})
    return jm, jw, tm, tw, dr


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, quant):
    """Caches of both packages.  int8: quantized from float rows that
    agree within atol 1e-5, so a value may land on the other side of a
    rounding boundary (``tests/test_torch_int8.py``): values within 1, at
    most 0.1% of them differing, scales atol 1e-5 / 127; returns whether
    every value is equal.  Dense: atol 1e-5."""
    if not quant:
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=ATOL)
        return True
    diff = np.abs(_np(got[0]).astype(np.int32)
                  - np.asarray(want[0]).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, diff.max()
    np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), rtol=0,
                               atol=ATOL / 127)
    return diff.max() == 0


def _drain(eng, max_steps=3000, per_step=None):
    for _ in range(max_steps):
        if not eng.pending:
            break
        eng.step()
        eng.check_block_accounting()
        if per_step is not None:
            per_step(eng)
    assert not eng.pending


def _serve(m, specs, max_slots=3, per_step=None, **kw):
    """Streams of ``specs`` ((prompt, n_new, temperature, seed) tuples)
    on ``m.serve(**kw)``, drained step by step, and its stats."""
    kw.setdefault("paged", PagedConfig(block_size=B, num_blocks=64))
    eng = m.serve(max_slots=max_slots, **kw)
    hs = [eng.submit(GenerationRequest(p, max_new_tokens=n, temperature=t,
                                       seed=s)) for p, n, t, s in specs]
    _drain(eng, per_step=per_step)
    out = [h.result().tokens for h in hs]
    snap = eng.stats.snapshot()
    eng.close()
    return out, snap


def _specs(seed=0, n=4, lo=4, hi=20, n_new=(6, 14), sampled=True):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 256, rng.randint(lo, hi)).astype(np.int32),
             int(rng.randint(*n_new)),
             float(rng.choice([0.0, 0.9])) if sampled else 0.0, 10 + i)
            for i in range(n)]


# ------------------------------------------------------------ decode math


@pytest.mark.parametrize("quant", [False, True], ids=["float32", "int8"])
def test_rolling_prefill_and_decode_match_jax(models, quant):
    """``prefill`` with a window rolls the prompt's K/V into ``W`` lanes
    (position p at lane p % W) as the JAX function does, and three
    ``decode_step``s on that rolling cache give the JAX logits and
    caches.  int8: each step starts from the JAX caches, and its logits
    are held at atol 1e-5 where the row it quantized equals JAX's (a
    value on the other side of a rounding boundary moves them by
    O(1e-4))."""
    _, jw, _, tw, _ = models
    cfg = tw.cfg
    jp, tp = jgd.extract_params(jw), gd.extract_params(tw)
    ids = np.random.RandomState(0).randint(0, 256, (2, 37)).astype(np.int32)
    jh, jk, jv = jgd.prefill(jp, jnp.asarray(ids), cfg.n_head,
                             cfg.layer_norm_eps, quant_cache=quant,
                             window=W)
    th, tk, tv = gd.prefill(tp, torch.from_numpy(ids), cfg.n_head,
                            cfg.layer_norm_eps, quant_cache=quant, window=W)
    np.testing.assert_allclose(_np(th), np.asarray(jh), rtol=0, atol=ATOL)
    _close(tk, jk, quant)
    _close(tv, jv, quant)
    rng = np.random.RandomState(1)
    for pos in range(37, 40):
        tok = rng.randint(0, 256, 2)
        x = np.asarray(jp["wte"])[tok] + np.asarray(jp["wpe"])[pos]
        if quant:
            tk, tv = (tuple(torch.from_numpy(np.array(t)) for t in c)
                      for c in (jk, jv))
        jl, jk, jv = jgd.decode_step(jp, jnp.asarray(x[:, None]), jk, jv,
                                     pos, cfg.n_head, cfg.layer_norm_eps,
                                     window=W)
        tl, tk, tv = gd.decode_step(tp, torch.from_numpy(x[:, None]), tk, tv,
                                    pos, cfg.n_head, cfg.layer_norm_eps,
                                    window=W)
        if _close(tk, jk, quant) & _close(tv, jv, quant):
            np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0,
                                       atol=ATOL)


@pytest.mark.parametrize("cache_dtype", [None, "int8"])
def test_windowed_generate_matches_jax(models, cache_dtype):
    """Offline windowed ``generate`` (rolling cache) on a ragged greedy
    batch that runs far past the window: the JAX function's tokens."""
    _, jw, _, tw, _ = models
    rows = [np.arange(5, dtype=np.int32) * 7 % 256,
            np.random.RandomState(2).randint(0, 256, 30).astype(np.int32)]
    got = tw.generate(rows, max_new_tokens=50, temperature=0.0,
                      cache_dtype=cache_dtype)
    want = jgd.generate(jw, rows, max_new_tokens=50, temperature=0.0,
                        cache_dtype=cache_dtype)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_windowed_chunk_and_paged_steps_match_jax(models):
    """The linear-layout band: ``prefill_chunk`` with a window against
    the JAX function, then ``decode_step_paged`` and ``chunk_step_paged``
    at Q = 4 with a window over tables whose out-of-window entries are
    the trash block (the JAX functions given the exact ``blk_lo``, the
    port's reading from entry 0), slot by slot against the JAX functions:
    logits and hidden rows atol 1e-5."""
    _, jw, _, tw, _ = models
    cfg = tw.cfg
    jp, tp = jgd.extract_params(jw), gd.extract_params(tw)
    n_kv, d = cfg.n_kv_head, cfg.n_embd // cfg.n_head
    rng = np.random.RandomState(4)
    shape = (cfg.n_layer, 1, n_kv, 48, d)
    kc, vc = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    x = (rng.randn(1, B, cfg.n_embd) * 0.5).astype(np.float32)
    jh, _, _ = jgd.prefill_chunk(jp, jnp.asarray(x), jnp.asarray(kc),
                                 jnp.asarray(vc), 32, cfg.n_head,
                                 cfg.layer_norm_eps, window=W)
    th, _, _ = gd.prefill_chunk(tp, torch.from_numpy(x),
                                torch.from_numpy(kc.copy()),
                                torch.from_numpy(vc.copy()), 32, cfg.n_head,
                                cfg.layer_norm_eps, window=W)
    np.testing.assert_allclose(_np(th), np.asarray(jh), rtol=0, atol=ATOL)
    n_blocks = 16
    pools = [rng.randn(cfg.n_layer, n_blocks + 1, n_kv, B,
                       d).astype(np.float32) for _ in range(2)]
    pos = np.array([45, 21], np.int32)
    tables = np.full((2, 8), n_blocks, np.int32)
    tables[0, 3:6] = [4, 11, 2]       # blocks 0-2 dropped: out of window
    tables[1, 1:3] = [9, 6]           # block 0 dropped
    blk_lo = min(max(0, (p - W + 1) // B) for p in pos)
    for nq, step in ((1, "decode_step_paged"), (4, "chunk_step_paged")):
        xs = (rng.randn(2, nq, cfg.n_embd) * 0.5).astype(np.float32)
        want = [np.asarray(getattr(jgd, step)(
            jp, jnp.asarray(xs[s:s + 1]), jnp.asarray(pools[0]),
            jnp.asarray(pools[1]), jnp.asarray(tables[s]), int(pos[s]),
            int(pos.max() + B - 1) // B, cfg.n_head, cfg.layer_norm_eps,
            block=B, trash=n_blocks, window=W,
            blk_lo=jnp.int32(blk_lo))[0])[0] for s in range(2)]
        tpk, tpv = (torch.from_numpy(p.copy()) for p in pools)
        tl = getattr(gd, step)(tp, torch.from_numpy(xs), tpk, tpv,
                               torch.from_numpy(tables),
                               torch.from_numpy(pos), cfg.n_head,
                               cfg.layer_norm_eps, block=B, window=W)
        for s in range(2):
            np.testing.assert_allclose(_np(tl[s]), want[s], rtol=0,
                                       atol=ATOL)


# ------------------------------------------------------- windowed serving


def test_windowed_engine_in_window_parity_with_dense(models):
    """Sequences that never leave the window: the windowed paged engine's
    streams are the dense engine's."""
    _, _, tm, tw, _ = models
    specs = _specs(1, n=3, lo=3, hi=6, n_new=(4, 9))
    dense, _ = _serve(tm, specs)
    win, snap = _serve(tw, specs)
    for a, b in zip(win, dense):
        np.testing.assert_array_equal(a, b)
    assert snap["paged"]["window_drops"] == 0


def test_windowed_engine_long_generation(models):
    """Generations far past the window, greedy and sampled: streams equal
    offline windowed ``generate`` (greedy ones the JAX windowed engine's
    too), the block accounting holds after every step, no slot holds
    more than (W - 1) // B + 2 blocks, and blocks return to the pool as
    they leave the window."""
    jm, jw, _, tw, _ = models
    specs = _specs(3, n=4, lo=4, hi=24, n_new=(60, 90))
    most = []

    def per_step(eng):
        most.append(max([sum(b != eng.paged_arena.trash for b in s.blocks)
                         for s in eng._slots if s is not None] or [0]))

    out, snap = _serve(tw, specs, per_step=per_step)
    for o, (p, n, t, s) in zip(out, specs):
        np.testing.assert_array_equal(
            o, tw.generate(p, max_new_tokens=n, temperature=t, seed=s))
    assert max(most) <= (W - 1) // B + 2
    assert snap["paged"]["window_drops"] > 0
    eng = jw.serve(max_slots=3, paged=JPagedConfig(block_size=B,
                                                   num_blocks=64))
    greedy = [i for i, sp in enumerate(specs) if sp[2] == 0.0]
    hs = [eng.submit(JRequest(specs[i][0], max_new_tokens=specs[i][1]))
          for i in greedy]
    eng.run_until_complete(max_steps=2000)
    for i, h in zip(greedy, hs):
        np.testing.assert_array_equal(out[i], np.asarray(h.result().tokens))
    eng.close()


def test_windowed_long_prompt_admits_in_window(models):
    """A 70-token prompt on a 16-token window allocates only the blocks
    from its first in-window lane: the table's first (70 - 16 + 1) // 8
    entries are the trash block; the stream is offline ``generate``'s."""
    _, _, _, tw, _ = models
    p = np.random.RandomState(5).randint(0, 256, 70).astype(np.int32)
    eng = tw.serve(max_slots=1, paged=PagedConfig(block_size=B,
                                                  num_blocks=8))
    h = eng.submit(GenerationRequest(p, max_new_tokens=20))
    eng.step()
    slot = eng._slots[0]
    j_lo = (70 - W + 1) // B
    assert slot.blocks[:j_lo] == [eng.paged_arena.trash] * j_lo
    assert eng.paged_arena.blocks_used == len(slot.blocks) - j_lo
    _drain(eng)
    np.testing.assert_array_equal(
        h.result().tokens, tw.generate(p, max_new_tokens=20,
                                       temperature=0.0))
    eng.close()


@pytest.mark.parametrize("case", ["int8", "draft", "preempt"])
def test_windowed_engine_compositions(models, case):
    """Windowed serving on int8 pools (== offline windowed int8
    ``generate``), with a speculative draft (== the windowed engine
    without one) and under a pool that preempts windowed slots (== the
    unpressured run)."""
    _, _, _, tw, dr = models
    specs = _specs(6, n=3, lo=5, hi=12, n_new=(30, 41),
                   sampled=case == "preempt")
    if case == "int8":
        out, _ = _serve(tw, specs, cache_dtype="int8")
        want = [tw.generate(p, max_new_tokens=n, temperature=0.0,
                            cache_dtype="int8") for p, n, _, _ in specs]
    elif case == "draft":
        out, snap = _serve(tw, specs, draft_model=dr, spec_k=4)
        want, _ = _serve(tw, specs)
        assert snap["spec"]["chunks"] > 0
    else:
        want, _ = _serve(tw, specs)
        out, snap = _serve(tw, specs, scheduler="priority",
                           paged=PagedConfig(block_size=B, num_blocks=6))
        assert snap["paged"]["preemptions"] >= 1
        assert snap["paged"]["blocks_used"] == 0
    for o, w in zip(out, want):
        np.testing.assert_array_equal(o, w)


# -------------------------------------------------- chunked-prefill budget


def _mix(seed=0):
    """One long admission (64 tokens) among short chat traffic."""
    rng = np.random.RandomState(seed)
    specs = [(rng.randint(0, 256, 64).astype(np.int32), 4, 0.0, 11)]
    return specs + [(rng.randint(0, 256, rng.randint(4, 12)).astype(
        np.int32), 6, float(rng.choice([0.0, 0.9])), 20 + i)
        for i in range(3)]


def test_budget_streams_equal_unbudgeted_and_jax(models):
    """Budgeted streams (greedy and sampled) equal the unbudgeted
    engine's; the greedy ones equal the JAX budgeted engine's; the long
    prompt took 8 budgeted chunk passes."""
    jm, _, tm, _, _ = models
    base, _ = _serve(tm, _mix(), max_slots=4)
    out, snap = _serve(tm, _mix(), max_slots=4, paged=PagedConfig(
        block_size=B, num_blocks=64, prefill_token_budget=B))
    for a, b in zip(out, base):
        np.testing.assert_array_equal(a, b)
    assert snap["budget_chunks"] == sum(
        (len(p) - 1) // B + 1 for p, _, _, _ in _mix())
    eng = jm.serve(max_slots=4, paged=JPagedConfig(
        block_size=B, num_blocks=64, prefill_token_budget=B))
    greedy = [sp for sp in _mix() if sp[2] == 0.0]
    hs = [eng.submit(JRequest(p, max_new_tokens=n))
          for p, n, _, _ in greedy]
    eng.run_until_complete(max_steps=2000)
    want = [np.asarray(h.result().tokens) for h in hs]
    eng.close()
    for o, w in zip([o for o, sp in zip(out, _mix()) if sp[2] == 0.0],
                    want):
        np.testing.assert_array_equal(o, w)


def test_budget_decode_dispatches_every_step(models):
    """While a 64-token admission prefills 16 tokens a step, the live chat
    slots emit a token every step, and a request queued behind it waits
    (admission order blocks, it never skips); every stream is offline
    ``generate``'s."""
    _, _, tm, _, _ = models
    eng = tm.serve(max_slots=4, paged=PagedConfig(
        block_size=B, num_blocks=64, prefill_token_budget=2 * B))
    hs = [eng.submit(GenerationRequest(np.arange(5, dtype=np.int32) + i,
                                       max_new_tokens=20))
          for i in range(2)]
    eng.step()
    assert eng.live_slots == 2
    hs += [eng.submit(GenerationRequest(np.arange(64, dtype=np.int32),
                                        max_new_tokens=3)),
           eng.submit(GenerationRequest(np.arange(6, dtype=np.int32),
                                        max_new_tokens=3))]
    emitted = [sum(len(s.emitted) for s in eng._slots if s is not None)]
    for _ in range(3):
        eng.step()
        assert len(eng._prefilling) == 1 and eng.live_slots == 2
        assert eng.scheduler.queue_depth == 1
        emitted.append(sum(len(s.emitted) for s in eng._slots
                           if s is not None))
    assert np.diff(emitted).tolist() == [2, 2, 2]
    _drain(eng)
    for h in hs:
        np.testing.assert_array_equal(
            h.result().tokens, tm.generate(
                h.request.prompt_ids, max_new_tokens=h.request.max_new_tokens,
                temperature=0.0))
    eng.close()


def test_budget_with_prefix_cache_and_draft(models):
    """The budget composes with the prefix cache (a warm admission
    chunks only its uncached blocks, streams equal the cold engine's)
    and with a speculative draft (streams equal the unbudgeted
    speculative engine's)."""
    _, _, tm, _, dr = models
    system = np.random.RandomState(7).randint(0, 256, 24).astype(np.int32)
    specs = [(np.concatenate([system, p]), n, 0.0, s)
             for p, n, _, s in _specs(8, n=3, lo=3, hi=9)]
    cold, _ = _serve(tm, specs, max_slots=1)
    warm, snap = _serve(tm, specs, max_slots=1, paged=PagedConfig(
        block_size=B, num_blocks=64, prefill_token_budget=B),
        prefix_cache=PrefixCacheConfig(block_size=B, num_blocks=64))
    for a, b in zip(warm, cold):
        np.testing.assert_array_equal(a, b)
    assert snap["prefix"]["hit_tokens"] > 0
    base, _ = _serve(tm, _mix(3), max_slots=4, draft_model=dr, spec_k=4)
    out, _ = _serve(tm, _mix(3), max_slots=4, draft_model=dr, spec_k=4,
                    paged=PagedConfig(block_size=B, num_blocks=64,
                                      prefill_token_budget=B))
    for a, b in zip(out, base):
        np.testing.assert_array_equal(a, b)


def test_budget_fault_mid_prefill_frees_blocks(models):
    """A fault between chunk passes (``serve.prefill_chunk``) fails the
    engine typed: the prefilling request is rejected with
    ``started=False`` and its blocks return to the pool."""
    _, _, tm, _, _ = models
    eng = tm.serve(max_slots=2, paged=PagedConfig(
        block_size=B, num_blocks=32, prefill_token_budget=B))
    h = eng.submit(GenerationRequest(np.arange(64, dtype=np.int32),
                                     max_new_tokens=3))
    pol = faults.inject("serve.prefill_chunk", FailAfterN(2, times=1))
    try:
        with pytest.raises(EngineFailedError):
            for _ in range(20):
                eng.step()
    finally:
        faults.clear()
    assert pol.fired == 1
    with pytest.raises(EngineFailedError) as ei:
        h.result()
    assert ei.value.started is False
    assert eng.paged_arena.blocks_used == 0
    eng.close(force=True)


def test_resume_never_lands_on_prefilling_slot(models):
    """A slot reserved by an admission still prefilling is not free: a
    swapped request resumes into another slot, and every stream is
    offline ``generate``'s."""
    _, _, tm, _, _ = models
    eng = tm.serve(max_slots=2, paged=PagedConfig(
        block_size=B, num_blocks=32, prefill_token_budget=B))
    reqs = [(np.arange(4, dtype=np.int32), 4), (np.arange(6, dtype=np.int32),
                                                 30),
            (np.arange(64, dtype=np.int32), 2)]
    hs = [eng.submit(GenerationRequest(reqs[0][0], max_new_tokens=4))]
    eng.step()
    hs.append(eng.submit(GenerationRequest(reqs[1][0], max_new_tokens=30)))
    eng.step()
    hs.append(eng.submit(GenerationRequest(reqs[2][0], max_new_tokens=2)))
    for _ in range(20):
        eng.step()
        if 0 in eng._prefilling:
            break
    assert 0 in eng._prefilling and eng._slots[1] is not None
    eng._preempt_slot(1, reason="test")
    eng.step()
    assert 0 in eng._prefilling or eng._slots[0] is not None
    _drain(eng)
    for h, (p, n) in zip(hs, reqs):
        np.testing.assert_array_equal(
            h.result().tokens, tm.generate(p, max_new_tokens=n,
                                           temperature=0.0))
    assert eng.paged_arena.blocks_used == 0
    eng.close()


def test_admit_per_step_caps_admissions(models):
    """``admit_per_step=1``: one admission a scheduling pass however many
    slots are free; the streams are the uncapped engine's."""
    _, _, tm, _, _ = models
    specs = _specs(9, n=3)
    base, _ = _serve(tm, specs)
    live = []
    out, _ = _serve(tm, specs, per_step=lambda e: live.append(e.live_slots),
                    paged=PagedConfig(block_size=B, num_blocks=64,
                                      admit_per_step=1))
    assert live[:3] == [1, 2, 3]
    for a, b in zip(out, base):
        np.testing.assert_array_equal(a, b)


def test_longctx_typed_errors(models):
    """The JAX engine's refusals (``tests/test_serve_longctx.py``'s
    configuration test, without its TP and ring parts)."""
    _, _, tm, tw, _ = models
    with pytest.raises(NotImplementedError, match="paged"):
        tw.serve()
    with pytest.raises(ValueError, match="kernel"):
        tw.serve(paged=PagedConfig(block_size=B, num_blocks=8,
                                   kernel="gather"))
    with pytest.raises(NotImplementedError, match="prefix"):
        tw.serve(paged=PagedConfig(block_size=B, num_blocks=8),
                 prefix_cache=PrefixCacheConfig(block_size=B))
    with pytest.raises(ValueError, match="prefill_token_budget"):
        PagedConfig(block_size=B, num_blocks=8, prefill_token_budget=B + 1)
    with pytest.raises(ValueError, match="admit_per_step"):
        PagedConfig(admit_per_step=0)
    eng = tw.serve(max_slots=1, paged=PagedConfig(block_size=B,
                                                  num_blocks=2))
    with pytest.raises(ValueError, match="KV blocks"):
        eng.submit(GenerationRequest(np.arange(40), max_new_tokens=40))
    eng.close()
