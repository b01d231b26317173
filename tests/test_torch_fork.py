"""The port's fork and structured decoding (``serve/fork.py``,
``serve/structured.py``, the engine's ``n > 1`` / ``fork()`` /
``prune()`` / ``structured=``) against the JAX engine and the port's own
plain streams: the counterparts of ``tests/test_fork.py`` (its ledger
test waits for the port's request ledger).

``GPT2Config.tiny`` (vocabulary 256, so a token id is a character for
the structured tests), block size 8, float32, on the CPU; the JAX
weights carried into the port by a ``save_states`` zip.  Every engine is
driven through ``_drain``, which checks the block accounting (``used ==
cached + live_referenced``) after every step.

* Against the JAX engine, one run of both: greedy ``n = 3`` streams and
  greedy structured streams (``n = 1`` and ``n = 2``) token-identical,
  branch scores within atol 1e-5 (the summed log-probabilities of the
  chosen tokens under the float32 softmax), and every structured output
  parses with ``json.loads`` and matches the schema.  Sampled fork
  branches (keyed ``fold_in``) are held against the JAX engine in
  ``tests/test_torch_sampled_parity.py``.
* Within the port, as the JAX tests pin them: branch 0 equals ``n = 1``
  (greedy and seeded; GQA; int8), shared prompt blocks accounted once,
  copy-on-write isolation mid-stream, ``prune`` freeing private blocks
  only, fork over a warm prefix, fork under priority preemption (the
  streams of a roomy pool), a fault at ``serve.fork_copy`` rejecting one
  branch, the typed composition limits, the automaton's compile-time
  checks, no step prepared after warm-up, and all-True masks leaving a
  plain engine's streams bitwise as they were.
"""

import json

import numpy as np
import pytest

import torch

from singa_tpu import device as jdevice
from singa_tpu import tensor as jtensor
from singa_tpu.models.gpt2 import GPT2Config as JGPT2Config
from singa_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from singa_tpu.serve import GenerationRequest as JRequest
from singa_tpu.serve import JsonSchemaAutomaton as JAutomaton
from singa_tpu.serve import PagedConfig as JPagedConfig
from singa_tpu.serve import structured as jstructured
from singa_tpu_torch import device, tensor
from singa_tpu_torch.models import gpt2_decode as gd
from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from singa_tpu_torch.resilience import FailAfterN, FaultInjected, faults
from singa_tpu_torch.serve import (BranchHandle, ForkHandle,
                                   GenerationRequest, JsonSchemaAutomaton,
                                   PagedConfig, PrefixCacheConfig,
                                   PriorityScheduler, jit_cache_size)
from singa_tpu_torch.serve import structured

from test_torch_graphs import _CaptureGuard

ATOL = 1e-5
B = 8
CPU = device.create_cpu_device()
VOCAB = [chr(c) for c in range(256)]
SCHEMA = {"type": "object", "properties": {
    "verdict": {"enum": ["yes", "no", "maybe"]},
    "count": {"type": "integer"},
    "flag": {"type": "boolean"},
}}


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


def _port(jm, path, **kw):
    """The port's model of ``jm``'s configuration holding its weights."""
    m = GPT2LMHead(GPT2Config.tiny(dropout=0.0, **kw))
    m.compile([tensor.from_numpy(np.zeros((1, 16), np.int32), CPU)],
              is_train=False)
    jm.save_states(path)
    m.load_states(path)
    return m


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX model, port model holding its weights); the JAX device's
    generator seeded, so the weights are the same every run."""
    jdevice.get_default_device().SetRandSeed(0)
    jm = _jax_model()
    return jm, _port(jm, str(tmp_path_factory.mktemp("fork") / "m.zip"))


@pytest.fixture(scope="module")
def model(pair):
    return pair[1]


def _paged(**kw):
    return PagedConfig(**dict(dict(block_size=B, num_blocks=32), **kw))


def _drain(eng, max_steps=1000):
    for _ in range(max_steps):
        if not eng.pending:
            break
        eng.step()
        eng.check_block_accounting()
    assert not eng.pending


def _drained_ok(eng):
    """After a drain every used block is the prefix cache's."""
    used = eng.check_block_accounting()
    cached = (eng.prefix_cache.cached_blocks
              if eng.prefix_cache is not None else 0)
    assert used == cached
    return used


def _plain_stream(model, prompt, n_new, temperature, seed, **kw):
    eng = model.serve(max_slots=4, paged=_paged(), **kw)
    h = eng.submit(GenerationRequest(prompt, max_new_tokens=n_new,
                                     temperature=temperature, seed=seed))
    _drain(eng)
    eng.close()
    return h.result().tokens


def _text(tokens, plen):
    return "".join(VOCAB[t] for t in tokens[plen:])


def _check_schema(tokens, plen):
    obj = json.loads(_text(tokens, plen))
    assert set(obj) == {"verdict", "count", "flag"}
    assert obj["verdict"] in ("yes", "no", "maybe")
    assert isinstance(obj["count"], int) and not isinstance(obj["count"],
                                                            bool)
    assert isinstance(obj["flag"], bool)


# ------------------------------------------------------ against the JAX engine

#: (prompt length, max_new_tokens, n, structured) of the shared workload
WORKLOAD = [(6, 10, 3, False), (17, 7, 2, False), (5, 96, 1, True),
            (9, 96, 2, True)]


def _workload(pkg_request, automaton, paged, serve):
    rng = np.random.RandomState(3)
    eng = serve(max_slots=8, paged=paged)
    hs = []
    for plen, n_new, n, st in WORKLOAD:
        hs.append(eng.submit(pkg_request(
            rng.randint(0, 256, plen).astype(np.int32),
            max_new_tokens=n_new, n=n,
            structured=automaton if st else None)))
    return eng, hs


def _results(h):
    return h.results() if hasattr(h, "results") else [h.result()]


def test_greedy_fork_and_structured_streams_match_jax_engine(pair):
    jm, tm = pair
    jeng, jhs = _workload(
        JRequest, JAutomaton(SCHEMA, VOCAB, max_digits=4),
        JPagedConfig(block_size=B, num_blocks=64), jm.serve)
    jeng.run_until_complete()
    teng, ths = _workload(
        GenerationRequest, JsonSchemaAutomaton(SCHEMA, VOCAB, max_digits=4),
        _paged(num_blocks=64), tm.serve)
    _drain(teng)
    for (plen, _, n, st), jh, th in zip(WORKLOAD, jhs, ths):
        want, got = _results(jh), _results(th)
        assert len(want) == len(got) == n
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.tokens, w.tokens)
            assert (g.branch, g.finish_reason) == (w.branch,
                                                   w.finish_reason)
            if n > 1:
                np.testing.assert_allclose(g.score, w.score, rtol=0,
                                           atol=ATOL)
            else:
                assert g.score is None and w.score is None
            if st:
                assert g.finish_reason == "stop"
                _check_schema(g.tokens, plen)
    _drained_ok(teng)
    teng.close()
    jeng.close()


def test_automaton_masks_match_jax():
    """The port's copy of the automaton gives the JAX one's masks and
    transitions along a walk through every node kind."""
    schema = dict(SCHEMA, properties=dict(
        SCHEMA["properties"], name={"type": "string", "maxLength": 5}))
    a = structured.JsonSchemaAutomaton(schema, VOCAB, max_digits=3)
    ja = jstructured.JsonSchemaAutomaton(schema, VOCAB, max_digits=3)
    text = '{"verdict":"maybe","count":407,"flag":false,"name":"ab_9"}'
    s, js = a.initial(), ja.initial()
    for ch in text:
        np.testing.assert_array_equal(a.mask(s), ja.mask(js))
        s, js = a.advance(s, ord(ch)), ja.advance(js, ord(ch))
        assert s == js
    assert a.done(s) and ja.done(js)
    assert not a.mask(s).any()


# ------------------------------------------------------------- best-of-n

@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.9, 7)])
def test_branch0_equals_n1(model, temperature, seed):
    """Branch 0 of an n = 3 group is the n = 1 stream, greedy and seeded;
    every branch has a score and shares the first token; greedy branches
    are identical, sampled ones diverge."""
    prompt = np.arange(6, dtype=np.int32) + 11
    base = _plain_stream(model, prompt, 8, temperature, seed)
    eng = model.serve(max_slots=4, paged=_paged())
    fh = eng.submit(GenerationRequest(prompt, max_new_tokens=8,
                                      temperature=temperature, seed=seed,
                                      n=3))
    assert isinstance(fh, ForkHandle)
    _drain(eng)
    assert fh.done()
    res = fh.results()
    assert len(res) == 3
    np.testing.assert_array_equal(res[0].tokens, base)
    for k, r in enumerate(res):
        assert r.branch == k and r.score is not None
        assert len(r.tokens) == len(prompt) + 8
        assert r.tokens[len(prompt)] == base[len(prompt)]
    if temperature == 0.0:
        assert all(np.array_equal(r.tokens, base) for r in res)
    else:
        assert any(not np.array_equal(r.tokens, base) for r in res[1:])
    ranked = fh.ranked()
    assert [r.score for r in ranked] == sorted((r.score for r in ranked),
                                               reverse=True)
    assert fh.best() is ranked[0]
    _drained_ok(eng)
    assert eng.stats.snapshot()["paged"]["blocks_used"] == 0
    eng.close()


@pytest.mark.parametrize("kind", ["gqa", "int8"])
def test_branch0_parity_gqa_and_int8(model, kind):
    if kind == "gqa":
        m = GPT2LMHead(GPT2Config.tiny(dropout=0.0, n_kv_head=2))
        m.compile([tensor.from_numpy(np.zeros((1, 16), np.int32), CPU)],
                  is_train=False)
        kw, prompt, temp, seed = {}, np.arange(5, dtype=np.int32) + 3, \
            0.8, 3
    else:
        m, kw = model, dict(cache_dtype="int8")
        prompt, temp, seed = np.arange(7, dtype=np.int32) + 5, 0.7, 11
    base = _plain_stream(m, prompt, 6, temp, seed, **kw)
    eng = m.serve(max_slots=3, paged=_paged(), **kw)
    fh = eng.submit(GenerationRequest(prompt, max_new_tokens=6,
                                      temperature=temp, seed=seed, n=2))
    _drain(eng)
    np.testing.assert_array_equal(fh.results()[0].tokens, base)
    _drained_ok(eng)
    eng.close()


def test_shared_prompt_blocks_accounted(model):
    """While the branches decode, their prompt blocks are shared (one
    block table entry each, counted once by the accounting) and the
    group holds fewer blocks than n independent admissions."""
    prompt = np.arange(17, dtype=np.int32) + 2  # 2 full blocks at B = 8
    eng = model.serve(max_slots=4, paged=_paged())
    fh = eng.submit(GenerationRequest(prompt, max_new_tokens=10,
                                      temperature=0.9, seed=5, n=3))
    eng.step()  # admits the parent and forks the branches
    assert len(fh.branches) == 3
    arena = eng.paged_arena
    assert arena.shared_blocks >= 2
    tables = [s.blocks for s in eng._slots if s is not None]
    assert len(tables) == 3 and all(t[:2] == tables[0][:2] for t in tables)
    assert arena.blocks_used < 3 * (len(prompt) // B + 1)
    eng.check_block_accounting()
    snap = eng.stats.snapshot()["fork"]
    assert snap["branches"] == 2 and snap["shared_blocks"] >= 2
    _drain(eng)
    _drained_ok(eng)
    eng.close()


# ---------------------------------------------------- fork() and prune()

def test_midstream_fork_cow_isolation(model):
    """Forking a live stream leaves the parent's tokens those of the
    unforked run (the child writes into its own copies) and the child
    shares exactly the tokens before the fork."""
    prompt = np.arange(6, dtype=np.int32) + 21
    base = _plain_stream(model, prompt, 12, 0.85, 13)
    eng = model.serve(max_slots=4, paged=_paged())
    h = eng.submit(GenerationRequest(prompt, max_new_tokens=12,
                                     temperature=0.85, seed=13))
    rid = h.request.request_id
    for _ in range(4):
        eng.step()
    bh = eng.fork(rid)
    assert isinstance(bh, BranchHandle) and bh.branch == 1
    _drain(eng)
    np.testing.assert_array_equal(h.result().tokens, base)
    child = bh.result()
    assert child.request_id == f"{rid}#1"
    pre = len(prompt) + 4
    np.testing.assert_array_equal(child.tokens[:pre], base[:pre])
    assert not np.array_equal(child.tokens, base)
    assert eng.stats.snapshot()["fork"]["cow_copies"] >= 1
    _drained_ok(eng)
    eng.close()


def test_prune_frees_private_blocks(model):
    """``prune`` seals a ``"pruned"`` result with what was emitted and
    frees the branch's private blocks at once; shared ones stay."""
    prompt = np.arange(9, dtype=np.int32) + 4
    eng = model.serve(max_slots=4, paged=_paged())
    fh = eng.submit(GenerationRequest(prompt, max_new_tokens=16,
                                      temperature=0.9, seed=2, n=3))
    for _ in range(10):
        eng.step()
    arena = eng.paged_arena
    used_before, shared = arena.blocks_used, arena.shared_blocks
    victim = fh.branches[2]
    slot = next(s for s in eng._slots
                if s is not None and s.handle is victim._handle)
    private = [b for b in slot.blocks if arena.ref_count(b) == 1]
    victim.prune()
    r = victim.result()
    assert r.finish_reason == "pruned" and r.branch == 2
    assert r.score is not None and len(r.tokens) > len(prompt)
    assert arena.blocks_used == used_before - len(private) < used_before
    assert arena.shared_blocks <= shared
    victim.prune()  # a no-op once done
    _drain(eng)
    assert fh.done() and len(fh.results()) == 3
    assert all(rr.finish_reason != "pruned" for rr in fh.ranked())
    assert eng.stats.snapshot()["fork"]["pruned"] == 1
    _drained_ok(eng)
    eng.close()


def test_fork_with_prefix_cache(model):
    """Fork over a warm admission: the cached prefix blocks are shared,
    never copied, branch 0 keeps its parity, and after the drain every
    used block is the cache's (the last branch to retire donates)."""
    rng = np.random.RandomState(8)
    prompt = rng.randint(0, 256, 30).astype(np.int32)
    kw = dict(prefix_cache=PrefixCacheConfig(block_size=B))
    eng = model.serve(max_slots=4, paged=_paged(num_blocks=48), **kw)
    eng.submit(GenerationRequest(prompt, max_new_tokens=4))
    _drain(eng)
    base = _plain_stream(model, prompt, 8, 0.9, 17, **kw)
    fh = eng.submit(GenerationRequest(prompt, max_new_tokens=8,
                                      temperature=0.9, seed=17, n=3))
    _drain(eng)
    np.testing.assert_array_equal(fh.results()[0].tokens, base)
    snap = eng.stats.snapshot()
    assert snap["prefix"]["hit_tokens"] > 0
    assert _drained_ok(eng) == snap["prefix"]["cached_blocks"] > 0
    eng.close()


def test_fork_under_priority_preemption(model):
    """A higher-priority arrival on a tight pool preempts forked branches
    (a byte copy swapped out), which resume and finish with the streams
    of a roomy pool."""
    prompt = np.arange(10, dtype=np.int32) + 6
    hi_prompt = np.arange(12, dtype=np.int32) + 40

    def run(num_blocks):
        eng = model.serve(max_slots=4, scheduler=PriorityScheduler(),
                          paged=_paged(num_blocks=num_blocks))
        fh = eng.submit(GenerationRequest(prompt, max_new_tokens=20,
                                          temperature=0.9, seed=9, n=3))
        for _ in range(4):
            eng.step()
        hi = eng.submit(GenerationRequest(hi_prompt, max_new_tokens=26,
                                          priority=5))
        _drain(eng)
        outs = [r.tokens for r in fh.results()] + [hi.result().tokens]
        preempts = eng.stats.snapshot()["paged"]["preemptions"]
        _drained_ok(eng)
        eng.close()
        return outs, preempts

    roomy, _ = run(64)
    tight, preempts = run(10)
    assert preempts > 0
    for a, b in zip(roomy, tight):
        np.testing.assert_array_equal(a, b)


def test_cow_copy_fault_rejects_one_branch(model):
    """A fault at ``serve.fork_copy`` rejects only the branch copying,
    typed; the others finish with the streams of an unfaulted run and
    nothing leaks."""
    prompt = np.arange(6, dtype=np.int32) + 31
    req = dict(max_new_tokens=12, temperature=0.9, seed=21, n=3)
    eng = model.serve(max_slots=4, paged=_paged())
    fh = eng.submit(GenerationRequest(prompt, **req))
    pol = faults.inject("serve.fork_copy", FailAfterN(0, times=1))
    try:
        _drain(eng)
    finally:
        faults.clear()
    assert pol.fired == 1
    done, rejected = {}, 0
    for b in fh.branches:
        try:
            done[b.branch] = b.result().tokens
        except FaultInjected as e:
            assert e.site == "serve.fork_copy"
            rejected += 1
    assert rejected == 1 and len(done) == 2
    _drained_ok(eng)
    eng2 = model.serve(max_slots=4, paged=_paged())
    fh2 = eng2.submit(GenerationRequest(prompt, **req))
    _drain(eng2)
    clean = {r.branch: r.tokens for r in fh2.results()}
    for k, tokens in done.items():
        np.testing.assert_array_equal(tokens, clean[k])
    eng.close()
    eng2.close()


# ---------------------------------------------------- structured decoding

@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.9, 1),
                                              (1.2, 42)])
def test_structured_always_schema_valid(model, temperature, seed):
    a = JsonSchemaAutomaton(SCHEMA, VOCAB, max_digits=4)
    prompt = np.arange(5, dtype=np.int32) + 60
    eng = model.serve(max_slots=2, paged=_paged())
    h = eng.submit(GenerationRequest(prompt, max_new_tokens=64,
                                     temperature=temperature, seed=seed,
                                     structured=a))
    _drain(eng)
    r = h.result()
    assert r.finish_reason == "stop"
    _check_schema(r.tokens, len(prompt))
    _drained_ok(eng)
    eng.close()


def test_structured_composes_with_fork(model):
    """n > 1 with structured decoding: every branch satisfies the grammar
    from its own state."""
    a = JsonSchemaAutomaton(SCHEMA, VOCAB, max_digits=3)
    prompt = np.arange(4, dtype=np.int32) + 90
    eng = model.serve(max_slots=4, paged=_paged())
    fh = eng.submit(GenerationRequest(prompt, max_new_tokens=64,
                                      temperature=1.0, seed=6, n=3,
                                      structured=a))
    _drain(eng)
    texts = set()
    for r in fh.results():
        assert r.finish_reason == "stop"
        _check_schema(r.tokens, len(prompt))
        texts.add(_text(r.tokens, len(prompt)))
    assert len(texts) > 1
    _drained_ok(eng)
    eng.close()


class _Scripted:
    """An automaton over the 256-token vocabulary: all tokens allowed for
    ``dead_at`` steps, then none (None: always all), never done."""

    vocab_size = 256

    def __init__(self, dead_at=None):
        self.dead_at = dead_at

    def initial(self):
        return 0

    def mask(self, state):
        return np.full(256, self.dead_at is None or state < self.dead_at)

    def advance(self, state, token):
        return state + 1

    def done(self, state):
        return False


def test_dead_end_rejects_that_request_only(model):
    prompt = np.arange(5, dtype=np.int32) + 7
    base = _plain_stream(model, prompt, 9, 0.0, 0)
    eng = model.serve(max_slots=4, paged=_paged())
    dead = eng.submit(GenerationRequest(prompt, max_new_tokens=9,
                                        structured=_Scripted(dead_at=3)))
    ok = eng.submit(GenerationRequest(prompt, max_new_tokens=9))
    _drain(eng)
    with pytest.raises(ValueError, match="admits no vocabulary token"):
        dead.result()
    np.testing.assert_array_equal(ok.result().tokens, base)
    _drained_ok(eng)
    eng.close()


def test_all_true_masks_leave_streams_bitwise(model):
    """``_sample`` under an all-True mask is bitwise ``_sample`` without
    one, greedy and sampled; and an engine serving a structured request
    whose masks are all True (so its steps take masks) gives every
    request the stream of an engine without it."""
    logits = torch.randn(6, 256, generator=torch.Generator().manual_seed(0))
    args = (torch.tensor([0.0, 0.7, 1.0, 0.0, 1.3, 0.5]),
            np.stack([[0, 100 + i] for i in range(6)]).astype(np.uint32))
    ones = torch.ones(6, 256, dtype=torch.bool)
    for kw in ({}, dict(top_k=20, top_p=0.9)):
        assert torch.equal(gd._sample(logits, *args, mask=ones, **kw),
                           gd._sample(logits, *args, **kw))
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, 256, n).astype(np.int32) for n in (5, 12, 9)]
    reqs = [dict(max_new_tokens=10, temperature=t, seed=i)
            for i, t in enumerate((0.0, 0.9, 0.6))]

    def run(structured):
        eng = model.serve(max_slots=4, paged=_paged())
        hs = [eng.submit(GenerationRequest(
            p, structured=_Scripted() if structured and i == 0 else None,
            **r)) for i, (p, r) in enumerate(zip(prompts, reqs))]
        _drain(eng)
        keys = set(eng._steps)
        eng.close()
        return [h.result().tokens for h in hs], keys

    plain, plain_keys = run(False)
    masked, masked_keys = run(True)
    assert all(isinstance(k, int) for k in plain_keys)
    assert any(isinstance(k, tuple) and k[1] for k in masked_keys)
    for a, b in zip(plain, masked):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------ capture and typing

def test_no_step_prepared_after_warm_up(model, monkeypatch):
    """After one pass of mixed traffic (plain, forked, structured, both)
    a second pass prepares no step; the steps are keyed by width (plain)
    or (width, masked, with_lp), all four kinds met; and the masked,
    log-probability step reads no device value on the host (the capture
    guard of ``tests/test_torch_graphs.py``)."""
    from singa_tpu_torch.ops import paged_attention as tpa
    guard = _CaptureGuard()
    plain = tpa.paged_attn_plain

    def exempt(*a, **k):
        guard.exempt += 1
        try:
            return plain(*a, **k)
        finally:
            guard.exempt -= 1

    monkeypatch.setattr(tpa, "paged_attn_plain", exempt)
    eng = model.serve(max_slots=4, paged=_paged(num_blocks=64))
    orig = eng._step_fn

    def guarded(key, n_rb=None):
        fn = orig(key, n_rb)

        def run():
            with guard:
                return fn()
        return run

    monkeypatch.setattr(eng, "_step_fn", guarded)
    a = JsonSchemaAutomaton(SCHEMA, VOCAB, max_digits=3)

    def traffic():
        rng = np.random.RandomState(5)
        for n, st in ((1, False), (2, False), (1, True), (2, True)):
            eng.submit(GenerationRequest(
                rng.randint(0, 256, 7).astype(np.int32), max_new_tokens=40,
                temperature=0.8, seed=n, n=n,
                structured=a if st else None))
            _drain(eng)

    traffic()
    warm = jit_cache_size()
    keys = set(eng._steps)
    traffic()
    assert jit_cache_size() == warm and set(eng._steps) == keys
    flags = {k[1:] if isinstance(k, tuple) else (False, False)
             for k in keys}
    assert flags == {(False, False), (False, True), (True, False),
                     (True, True)}
    assert guard.bad == [], guard.bad
    eng.close()


def test_automaton_compile_validation():
    with pytest.raises(ValueError, match="at least one property"):
        JsonSchemaAutomaton({"type": "array"}, VOCAB)
    with pytest.raises(ValueError, match="unsupported value schema"):
        JsonSchemaAutomaton({"type": "object", "properties": {
            "x": {"type": "number"}}}, VOCAB)
    with pytest.raises(ValueError, match="first char"):
        JsonSchemaAutomaton({"type": "object", "properties": {
            "x": {"enum": ["yes", "yellow"]}}}, VOCAB)
    with pytest.raises(ValueError, match="enum must be non-empty"):
        JsonSchemaAutomaton({"type": "object", "properties": {
            "x": {"enum": []}}}, VOCAB)
    with pytest.raises(ValueError, match="vocab must be non-empty"):
        JsonSchemaAutomaton(SCHEMA, [])


def test_composition_limits_raise_typed(model):
    prompt = np.arange(5, dtype=np.int32) + 1
    with pytest.raises(ValueError, match="pin_session"):
        GenerationRequest(prompt, n=2, pin_session=True, max_new_tokens=4)
    with pytest.raises(ValueError, match="nothing to diverge"):
        GenerationRequest(prompt, n=2, max_new_tokens=1)
    with pytest.raises(ValueError, match="n must be >= 1"):
        GenerationRequest(prompt, n=0)
    with pytest.raises(ValueError, match="callable"):
        GenerationRequest(prompt, structured=object())
    auto = JsonSchemaAutomaton(SCHEMA, VOCAB)
    eng = model.serve(max_slots=2)  # the slot arena
    for req in (GenerationRequest(prompt, n=2, max_new_tokens=4),
                GenerationRequest(prompt, structured=auto,
                                  max_new_tokens=4)):
        with pytest.raises(ValueError, match="paged engine"):
            eng.submit(req)
    with pytest.raises(ValueError, match="plain paged engine"):
        eng.fork("nope")
    eng.close()
    spec = model.serve(max_slots=2, paged=_paged(), draft_model=model,
                       spec_k=2)
    with pytest.raises(ValueError, match="speculative"):
        spec.submit(GenerationRequest(prompt, n=2, max_new_tokens=4))
    spec.close()
    budget = model.serve(max_slots=2, paged=_paged(prefill_token_budget=B))
    with pytest.raises(ValueError, match="chunked-prefill budget"):
        budget.submit(GenerationRequest(prompt, n=2, max_new_tokens=4))
    budget.close()
    wm = GPT2LMHead(GPT2Config.tiny(dropout=0.0, attn_window=16))
    wm.compile([tensor.from_numpy(np.zeros((1, 16), np.int32), CPU)],
               is_train=False)
    win = wm.serve(max_slots=2, paged=_paged())
    with pytest.raises(ValueError, match="sliding-window"):
        win.submit(GenerationRequest(prompt, n=2, max_new_tokens=4))
    win.close()
    eng = model.serve(max_slots=4, paged=_paged(num_blocks=8))
    with pytest.raises(ValueError, match="per-branch"):
        eng.submit(GenerationRequest(prompt, n=4, max_new_tokens=30))
    with pytest.raises(ValueError, match="vocab"):
        eng.submit(GenerationRequest(
            prompt, max_new_tokens=8,
            structured=JsonSchemaAutomaton(SCHEMA, VOCAB[:100])))
    with pytest.raises(ValueError, match="accepts no token"):
        eng.submit(GenerationRequest(prompt, max_new_tokens=8,
                                     structured=_Scripted(dead_at=0)))
    with pytest.raises(ValueError, match="unknown or already"):
        eng.fork("req-does-not-exist")
    with pytest.raises(ValueError, match="not a live or swapped"):
        eng.prune("req-does-not-exist")
    h = eng.submit(GenerationRequest(prompt, max_new_tokens=4))
    with pytest.raises(ValueError, match="still queued"):
        eng.fork(h.request.request_id)
    _drain(eng)
    _drained_ok(eng)
    eng.close()
