"""Speculative decoding in the port (``models/gpt2_decode.py``'s
``chunk_step_paged``, ``spec_verify`` and ``generate_speculative``, the
serve engine's ``draft_model=`` / ``spec_k=``) against the JAX package,
from the same weights.

``GPT2Config.tiny`` (2 layers, 64 wide) is the target; the draft is a
1-layer model holding the target's embeddings, first block and final
LayerNorm (copied by state name), so it agrees with the target often
but not always.  Weights cross from the JAX models to the port's by
``save_states`` / ``load_states`` zips.  Block size 8, float32.

Tolerances: ``chunk_step_paged`` logits atol 1e-5 against the JAX
function slot by slot (values O(1), the packages sum in other orders),
the int8 rows it writes within 1 in values (an ulp of the float row may
cross a rounding boundary, ``tests/test_torch_int8.py``) and atol 1e-5 /
127 in scales.  Token
streams are compared for identity, greedy ones against the JAX package
(sampled ones in ``tests/test_torch_sampled_parity.py``); sampled
speculative streams are held to direct target sampling by a two-sample
chi-square test at the 0.001 level.
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
from singa_tpu_torch.ops import prng
from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from singa_tpu_torch.ops import paged_attention as tpa
from singa_tpu_torch.serve import (FIFOScheduler, GenerationRequest,
                                   PagedConfig, PrefixCacheConfig,
                                   jit_cache_size)
from test_torch_graphs import _CaptureGuard

ATOL = 1e-5
B = 8
CPU = device.create_cpu_device()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models: one intra-op thread a process is faster than many,
    and keeps parallel test workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(cfg):
    m = JGPT2LMHead(cfg)
    m.compile([jtensor.from_numpy(np.zeros((1, 16), np.int32))],
              is_train=False, use_graph=False)
    return m


def _port(jm, path, **kw):
    """The port's model of ``jm``'s configuration holding its weights,
    carried by a ``save_states`` zip."""
    m = GPT2LMHead(GPT2Config.tiny(dropout=0.0, **kw))
    m.compile([tensor.from_numpy(np.zeros((1, 16), np.int32), CPU)],
              is_train=False)
    jm.save_states(path)
    m.load_states(path)
    return m


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX target, JAX draft, port target, port draft): the draft is the
    target's embeddings, first block and final LN.  The JAX device's
    generator is seeded (unseeded it draws from ``os.urandom``), so the
    weights, and with them the draft's acceptance, are the same every
    run."""
    tmp = tmp_path_factory.mktemp("spec")
    jdevice.get_default_device().SetRandSeed(0)
    jt = _jax_model(JGPT2Config.tiny(dropout=0.0))
    jdr = _jax_model(JGPT2Config.tiny(dropout=0.0, n_layer=1))
    states = jt.get_states()
    jdr.set_states({k: states[k] for k in jdr.get_states()})
    return (jt, jdr, _port(jt, str(tmp / "t.zip")),
            _port(jdr, str(tmp / "d.zip"), n_layer=1))


def _prompts(seed=0, n=5, lo=3, hi=30):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, rng.randint(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _drain(eng, max_steps=1000):
    for _ in range(max_steps):
        if not eng.pending:
            break
        eng.step()
        eng.check_block_accounting()
    assert not eng.pending


def _serve(m, prompts, news, max_slots=3, paged=True, **kw):
    """Greedy streams of ``prompts`` on ``m.serve`` and its stats."""
    if paged is True:
        paged = PagedConfig(block_size=B, num_blocks=64)
    eng = m.serve(max_slots=max_slots, paged=paged, **kw)
    hs = [eng.submit(GenerationRequest(p, max_new_tokens=n))
          for p, n in zip(prompts, news)]
    _drain(eng)
    out = [h.result().tokens for h in hs]
    snap = eng.stats.snapshot()
    steps = len(eng._steps)
    eng.close()
    return out, snap, steps


# ------------------------------------------------------------ chunk verify


def _pools(rng, n_blocks, n_kv, d, quant):
    """Random (L, N + 1, H, B, D) pools for both packages (int8: values
    and scales by ``_quantize_kv``)."""
    raw = [rng.randn(2, n_blocks + 1, n_kv, B, d).astype(np.float32)
           for _ in range(2)]
    if not quant:
        return ([torch.from_numpy(r.copy()) for r in raw],
                [jnp.asarray(r) for r in raw])
    port = [gd._quantize_kv(torch.from_numpy(r)) for r in raw]
    return port, [tuple(jnp.asarray(t.numpy()) for t in p) for p in port]


@pytest.mark.parametrize("quant", [False, True], ids=["float32", "int8"])
def test_chunk_step_paged_matches_jax(pair, quant):
    """The verify chunk against the pool at Q = 4 for three slots (one
    spanning two blocks, one dead) against the JAX function slot by
    slot: logits atol 1e-5, the chunk's K/V rows written where the JAX
    function's double blocks put them (``_rows_close``)."""
    jt, _, tm, _ = pair
    cfg = tm.cfg
    jp, tp = jgd.extract_params(jt), gd.extract_params(tm)
    d, n_kv, k = cfg.n_embd // cfg.n_head, cfg.n_kv_head, 4
    rng = np.random.RandomState(3)
    n_blocks = 12
    (tpk, tpv), (jpk, jpv) = _pools(rng, n_blocks, n_kv, d, quant)
    pos = np.array([13, 6, 0], np.int32)
    tables = np.full((3, 4), n_blocks, np.int32)
    tables[0, :3] = [5, 2, 9]         # positions 13..16 span blocks 1, 2
    tables[1, :2] = [7, 0]
    x = (rng.randn(3, k, cfg.n_embd) * 0.5).astype(np.float32)
    tl = gd.chunk_step_paged(tp, torch.from_numpy(x), tpk, tpv,
                             torch.from_numpy(tables),
                             torch.from_numpy(pos), cfg.n_head,
                             cfg.layer_norm_eps, block=B)
    for s in range(2):
        jl, kd, vd = jgd.chunk_step_paged(
            jp, jnp.asarray(x[s:s + 1]), jpk, jpv, jnp.asarray(tables[s]),
            int(pos[s]), (int(pos[s]) + B - 1) // B, cfg.n_head,
            cfg.layer_norm_eps, block=B, trash=n_blocks)
        b0, b1 = tables[s, pos[s] // B], tables[s, (pos[s] + k - 1) // B]
        lanes = slice(pos[s] % B, pos[s] % B + k)
        same = True
        for pool, dbl in ((tpk, kd), (tpv, vd)):
            leaves = pool if quant else (pool,)
            dbls = dbl if quant else (dbl,)
            got = [torch.cat([leaf[:, b0], leaf[:, b1]], 2).numpy()[
                :, :, lanes] for leaf in leaves]
            want = [np.asarray(jd)[:, :, lanes] for jd in dbls]
            same &= _rows_close(got, want, quant)
        if same:
            np.testing.assert_allclose(tl[s].numpy(), np.asarray(jl[0]),
                                       rtol=0, atol=ATOL)


def _rows_close(got, want, quant):
    """The written K/V rows of both packages.  int8: quantized from float
    rows that agree within atol 1e-5, so a value may land on the other
    side of a rounding boundary (``tests/test_torch_int8.py``): values
    within 1, at most 0.1% differing, scales atol 1e-5 / 127; returns
    whether every value is equal (the logits are then held at atol 1e-5;
    a value across a boundary moves them by O(1e-4)).  Dense: atol
    1e-5."""
    if not quant:
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL)
        return True
    diff = np.abs(got[0].astype(np.int32) - want[0].astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, diff.max()
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=ATOL / 127)
    return diff.max() == 0


# -------------------------------------------------------------- spec_verify


def test_spec_verify_greedy_matches_jax():
    """Greedy verify: the tokens and accept counts of the JAX function,
    row by row, with proposals that match the target's argmax for 0, 1,
    2 and all 3 positions."""
    rng = np.random.RandomState(0)
    s_, k, v = 4, 4, 32
    logits = rng.randn(s_, k, v).astype(np.float32)
    cands = logits.argmax(-1)
    props = rng.randint(0, v, (s_, k - 1))
    for r in range(s_):
        props[r, :r] = cands[r, :r]
        if r < k - 1:
            props[r, r] = (cands[r, r] + 1) % v
    d_probs = rng.dirichlet(np.ones(v), (s_, k - 1)).astype(np.float32)
    ks = np.stack([prng.split(prng.PRNGKey(r)) for r in range(s_)])
    out, a = gd.spec_verify(torch.from_numpy(logits),
                            torch.from_numpy(d_probs),
                            torch.from_numpy(props), torch.zeros(s_),
                            ks[:, 0], ks[:, 1])
    assert a.tolist() == [0, 1, 2, 3]
    for r in range(s_):
        jo, ja = jgd.spec_verify(
            jnp.asarray(logits[r]), jnp.asarray(d_probs[r]),
            jnp.asarray(props[r], jnp.int32), jax.random.PRNGKey(r),
            jnp.float32(0.0), jnp.float32(1.0), 0, False)
        assert int(a[r]) == int(ja)
        np.testing.assert_array_equal(out[r].numpy(), np.asarray(jo))


def _sharp_pair(vocab=16):
    """A 2-layer target and a 1-layer draft over a 16-token vocabulary
    with their own random weights, the embeddings scaled so both
    distributions are far from uniform and differ: acceptance is then
    interior and both the accept and the residual branches carry
    mass."""
    out = []
    for seed, n_layer in ((5, 2), (6, 1)):
        CPU.SetRandSeed(seed)
        m = GPT2LMHead(GPT2Config.tiny(dropout=0.0, vocab_size=vocab,
                                       n_layer=n_layer))
        m.compile([tensor.from_numpy(np.zeros((1, 8), np.int32), CPU)],
                  is_train=False)
        with torch.no_grad():
            m.transformer.wte.W.mul_(40.0)
        out.append(m)
    return out


def test_spec_sampled_chi2_matches_direct_sampling():
    """Rejection sampling's claim: speculative sampled tokens are
    distributed as direct target sampling.  400 seeded requests of 3
    tokens through the speculative engine and the plain one; a
    two-sample chi-square over the 16 tokens at the two positions the
    verify produced, against the 0.001 critical value for df = 15
    (37.70).  Everything is seeded, so the statistic is
    deterministic."""
    target, draft = _sharp_pair()
    prompt = np.arange(8, dtype=np.int32) % 16
    n = 400

    def collect(spec):
        kw = dict(draft_model=draft, spec_k=3) if spec else {}
        eng = target.serve(max_slots=32, paged=None,
                           scheduler=FIFOScheduler(max_queue_depth=n + 1),
                           **kw)
        hs = [eng.submit(GenerationRequest(prompt, max_new_tokens=3,
                                           temperature=1.0, seed=1000 + i))
              for i in range(n)]
        eng.run_until_complete(max_steps=5000)
        snap = eng.stats.snapshot()
        eng.close()
        return np.stack([h.result().tokens[8:] for h in hs]), snap

    t_spec, snap = collect(True)
    t_plain, _ = collect(False)
    rate = snap["spec"]["acceptance_rate"]
    assert 0.05 < rate < 0.999, rate
    for pos in (1, 2):
        o1 = np.bincount(t_spec[:, pos], minlength=16)
        o2 = np.bincount(t_plain[:, pos], minlength=16)
        live = (o1 + o2) > 0
        chi2 = float((((o1 - o2) ** 2) / np.maximum(o1 + o2, 1))[live].sum())
        assert chi2 < 37.70, (pos, chi2, o1, o2)


# ---------------------------------------------------- generate_speculative


def test_generate_speculative_matches_jax(pair):
    """Offline greedy speculative decoding: the JAX function's tokens
    and acceptance rate on a ragged pair of prompts, and the target's
    greedy ``generate``; with the target as its own draft every proposal
    is accepted."""
    jt, jdr, tm, tdr = pair
    prompts = _prompts(1, n=2)
    got, st = gd.generate_speculative(tm, tdr, prompts, max_new_tokens=14,
                                      spec_k=4)
    want, jst = jgd.generate_speculative(jt, jdr, prompts,
                                         max_new_tokens=14, spec_k=4)
    for g, w, r in zip(got, want, tm.generate(prompts, max_new_tokens=14,
                                              temperature=0.0)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r)
    assert st["chunks"] == jst["chunks"]
    assert st["acceptance_rate"] == pytest.approx(jst["acceptance_rate"])
    assert 0.0 < st["acceptance_rate"] < 1.0
    self_ids, self_st = gd.generate_speculative(tm, tm, prompts[0],
                                                max_new_tokens=14, spec_k=4)
    np.testing.assert_array_equal(self_ids, got[0])
    assert self_st["acceptance_rate"] == 1.0


# --------------------------------------------------------------- the engine


@pytest.fixture(scope="module")
def work(pair):
    """Five ragged prompts and their greedy references: the port's
    non-speculative paged engine and the JAX speculative paged engine
    (one run, weights by zip)."""
    jt, jdr, tm, _ = pair
    prompts, news = _prompts(2), [12, 9, 14, 7, 10]
    plain, _, _ = _serve(tm, prompts, news)
    eng = jt.serve(max_slots=3, draft_model=jdr, spec_k=4,
                   paged=JPagedConfig(block_size=B, num_blocks=64))
    hs = [eng.submit(JRequest(p, max_new_tokens=n))
          for p, n in zip(prompts, news)]
    eng.run_until_complete(max_steps=1000)
    jax_spec = [np.asarray(h.result().tokens) for h in hs]
    jsnap = eng.stats.snapshot()["spec"]
    eng.close()
    return prompts, news, plain, jax_spec, jsnap


@pytest.mark.parametrize("arena", ["paged", "slots", "gather"])
def test_spec_engine_matches_jax_and_plain(pair, work, arena):
    """Greedy streams of the speculative engine equal the non-speculative
    engine's and the JAX speculative engine's, on the paged arena (its
    accept counts too), the slot arena and the paged gather oracle; one
    captured step an engine."""
    _, _, tm, tdr = pair
    prompts, news, plain, jax_spec, jsnap = work
    paged = {"paged": True, "slots": None,
             "gather": PagedConfig(block_size=B, num_blocks=64,
                                   kernel="gather")}[arena]
    base = jit_cache_size()
    out, snap, steps = _serve(tm, prompts, news, paged=paged,
                              draft_model=tdr, spec_k=4)
    for o, p, j in zip(out, plain, jax_spec):
        np.testing.assert_array_equal(o, p)
        np.testing.assert_array_equal(o, j)
    assert steps == (0 if arena == "gather" else 1)
    assert jit_cache_size() == base
    if arena == "paged":
        assert snap["spec"]["accepted"] == jsnap["accepted"]
        assert snap["spec"]["chunks"] == jsnap["chunks"]
    assert 0.0 < snap["spec"]["acceptance_rate"] < 1.0


@pytest.mark.parametrize("case", ["gqa", "int8", "prefix", "self_draft"])
def test_spec_engine_compositions(pair, case):
    """Greedy speculative streams equal offline ``generate`` (int8: at
    ``cache_dtype="int8"``) on a GQA target with a GQA draft, on int8
    pools, with a prefix cache (a shared system prompt hits warm) and
    with the target as its own draft (every proposal accepted, the
    bonus token emitted)."""
    _, _, tm, tdr = pair
    prompts, news = _prompts(4, n=4), [11, 8, 13, 9]
    kw, gen = dict(draft_model=tdr, spec_k=4), {}
    target = tm
    if case == "gqa":
        CPU.SetRandSeed(7)
        models = []
        for n_layer in (2, 1):
            m = GPT2LMHead(GPT2Config.tiny(dropout=0.0, n_kv_head=2,
                                           n_layer=n_layer))
            m.compile([tensor.from_numpy(np.zeros((1, 8), np.int32), CPU)],
                      is_train=False)
            models.append(m)
        target, kw["draft_model"] = models
    elif case == "int8":
        kw["cache_dtype"] = gen["cache_dtype"] = "int8"
    elif case == "prefix":
        system = _prompts(9, n=1, lo=24, hi=25)[0]
        prompts = [np.concatenate([system, p]) for p in prompts]
        kw["prefix_cache"] = PrefixCacheConfig(block_size=B, num_blocks=64)
    else:
        kw["draft_model"] = tm
    want = [target.generate(p, max_new_tokens=n, temperature=0.0, **gen)
            for p, n in zip(prompts, news)]
    out, snap, _ = _serve(target, prompts, news, max_slots=2, **kw)
    for o, w in zip(out, want):
        np.testing.assert_array_equal(o, w)
    if case == "prefix":
        assert snap["prefix"]["hits"] >= 1
    if case == "self_draft":
        assert snap["spec"]["acceptance_rate"] == 1.0
        assert snap["spec"]["tokens_per_chunk"] > 3.0


def test_spec_stop_token_retires_mid_chunk(pair):
    """Self-drafted chunks of four tokens: a stop token that is the
    second token of a chunk retires the request there with
    ``finish_reason="stop"``; the tokens after it are never emitted."""
    _, _, tm, _ = pair
    p = _prompts(5, n=1)[0]
    full = tm.generate(p, max_new_tokens=10, temperature=0.0)
    stop = int(full[len(p) + 2])   # chunk 1 emits tokens 1..4
    seen = []
    eng = tm.serve(max_slots=1, paged=PagedConfig(block_size=B,
                                                  num_blocks=16),
                   draft_model=tm, spec_k=4)
    h = eng.submit(GenerationRequest(p, max_new_tokens=10, stop_token=stop,
                                     on_token=lambda r, t: seen.append(t)))
    _drain(eng)
    res = h.result()
    first = list(full[len(p):]).index(stop)
    np.testing.assert_array_equal(res.tokens, full[:len(p) + first + 1])
    assert res.finish_reason == "stop" and seen == list(res.tokens[len(p):])
    eng.close()


def test_spec_preempt_and_swap(pair):
    """A pool too small for three speculative slots preempts (the draft's
    row rides the swap) and the resumed streams equal the unpressured
    ones."""
    _, _, tm, tdr = pair
    prompts, news = _prompts(6, n=3, lo=10, hi=20), [30, 30, 30]
    want = [tm.generate(p, max_new_tokens=n, temperature=0.0)
            for p, n in zip(prompts, news)]
    out, snap, _ = _serve(tm, prompts, news, draft_model=tdr, spec_k=4,
                          paged=PagedConfig(block_size=B, num_blocks=12))
    for o, w in zip(out, want):
        np.testing.assert_array_equal(o, w)
    assert snap["paged"]["preemptions"] >= 1


def test_spec_config_typed_errors(pair):
    """The JAX engine's typed refusals (``tests/test_spec_serve.py``'s
    configuration test): spec_k without a draft, spec_k < 2, a draft of
    another vocabulary or too few positions, a sliding-window draft, a
    chunk wider than a block, and the spec_k - 1 positions of headroom
    at submit."""
    _, _, tm, tdr = pair
    with pytest.raises(ValueError, match="without draft_model"):
        tm.serve(spec_k=4)
    with pytest.raises(ValueError, match="spec_k must be >= 2"):
        tm.serve(draft_model=tdr, spec_k=1)
    other = []
    for kw in (dict(vocab_size=128), dict(n_positions=32),
               dict(attn_window=8)):
        m = GPT2LMHead(GPT2Config.tiny(dropout=0.0, **kw))
        m.compile([tensor.from_numpy(np.zeros((1, 8), np.int32), CPU)],
                  is_train=False)
        other.append(m)
    with pytest.raises(ValueError, match="vocab mismatch"):
        tm.serve(draft_model=other[0])
    with pytest.raises(ValueError, match="n_positions"):
        tm.serve(draft_model=other[1])
    with pytest.raises(NotImplementedError, match="sliding-window"):
        tm.serve(draft_model=other[2])
    with pytest.raises(ValueError, match="block_size"):
        tm.serve(draft_model=tdr, spec_k=9,
                 paged=PagedConfig(block_size=B, num_blocks=8))
    eng = tm.serve(max_slots=1, draft_model=tdr, spec_k=4)
    with pytest.raises(ValueError, match="spec_k-1"):
        eng.submit(GenerationRequest(np.zeros(120, np.int32),
                                     max_new_tokens=6))
    eng.close()
    with pytest.raises(NotImplementedError, match="sliding-window"):
        gd.generate_speculative(other[2], tdr, np.arange(4))
    with pytest.raises(ValueError, match="spec_k-1"):
        gd.generate_speculative(tm, tdr, np.arange(120), max_new_tokens=6)


@pytest.mark.parametrize("case", ["paged", "slots", "window_sampled"])
def test_spec_step_is_capturable(pair, monkeypatch, case):
    """The speculative step (the draft's steps, the verify chunk, the
    sampled and greedy verify) runs no op a CUDA graph cannot take: no
    host read of a device value, no data-dependent shape, no tensor made
    from host data (``tests/test_torch_graphs.py``'s guard; the plain
    version of ``paged_attn`` exempt)."""
    _, _, tm, tdr = pair
    guard = _CaptureGuard()
    plain = tpa.paged_attn_plain

    def exempt(*a, **k):
        guard.exempt += 1
        try:
            return plain(*a, **k)
        finally:
            guard.exempt -= 1

    monkeypatch.setattr(tpa, "paged_attn_plain", exempt)
    target, paged = tm, PagedConfig(block_size=B, num_blocks=64)
    if case == "slots":
        paged = None
    elif case == "window_sampled":
        target = GPT2LMHead(GPT2Config.tiny(dropout=0.0, attn_window=B))
        target.compile([tensor.from_numpy(np.zeros((1, 8), np.int32), CPU)],
                       is_train=False)
        target.set_states(tm.get_states())
    eng = target.serve(max_slots=3, paged=paged, draft_model=tdr, spec_k=4,
                       top_k=20, top_p=0.9)
    orig = eng._decode_once

    def guarded():
        with guard:
            orig()

    monkeypatch.setattr(eng, "_decode_once", guarded)
    for i, p in enumerate(_prompts(10, n=4)):
        eng.submit(GenerationRequest(p, max_new_tokens=12,
                                     temperature=0.8 * (i % 2), seed=i))
    _drain(eng)
    assert eng.stats.decode_steps > 0 and guard.bad == [], guard.bad
    eng.close()
