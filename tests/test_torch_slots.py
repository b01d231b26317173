"""The slot arena (``paged=None``, the serve engine's default) in the port,
dense and int8, against the JAX package's slot-arena engine and the
port's offline ``generate``.

``GPT2Config.tiny(dropout=0.0)`` (and a GQA variant, 2 kv heads of 4)
is built in both packages, the JAX weights carried into the port by
``set_states``; prompts and seeds come from numpy seeds; everything runs
on the CPU.  The slot arena's step is the dense ``decode_step`` over
every slot, dead slots on clamped inputs, captured as one CUDA graph on
the card; on the CPU the same first-step rule and persistent inputs run
the step function itself.  Token streams compare for identity: greedy
against the JAX package, greedy and sampled against the port's offline
``generate`` at the same ``cache_dtype`` (the same threefry key
chain).
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU: tests/conftest.py)
import torch

from singa_tpu import tensor as jtensor
from singa_tpu.models.gpt2 import GPT2Config as JGPT2Config
from singa_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from singa_tpu.serve import GenerationRequest as JRequest
from singa_tpu_torch import device, tensor
from singa_tpu_torch.models import gpt2_decode as gd
from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from singa_tpu_torch.serve import GenerationRequest, jit_cache_size
from singa_tpu_torch.serve import engine as eng_mod


def _pair(**cfg):
    """(JAX model, port model holding the JAX weights), eval mode."""
    ids = np.zeros((1, 16), np.int32)
    jm = JGPT2LMHead(JGPT2Config.tiny(dropout=0.0, **cfg))
    jm.compile([jtensor.from_numpy(ids)], is_train=False, use_graph=False)
    tm = GPT2LMHead(GPT2Config.tiny(dropout=0.0, **cfg))
    tm.compile([tensor.from_numpy(ids, device.create_cpu_device())],
               is_train=False)
    tm.set_states({k: jtensor.to_numpy(v)
                   for k, v in jm.get_states().items()})
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair()


@pytest.fixture(scope="module")
def gqa_models():
    return _pair(n_kv_head=2)


def _workload(seed, n, p_lo=3, p_hi=30, n_lo=2, n_hi=14, sampled=False):
    rng = np.random.RandomState(seed)
    return [dict(prompt=rng.randint(0, 256, rng.randint(p_lo, p_hi))
                 .astype(np.int32),
                 n_new=int(rng.randint(n_lo, n_hi)),
                 temperature=(float(rng.choice([0.0, 0.9])) if sampled
                              else 0.0),
                 seed=int(rng.randint(0, 1000))) for _ in range(n)]


def _serve(tm, work, max_slots=3, **kw):
    """``work`` through a slot-arena engine; returns (streams, engine
    snapshot, the prepared steps' widths)."""
    eng = tm.serve(max_slots=max_slots, **kw)
    assert eng.paged_arena is None
    hs = [eng.submit(GenerationRequest(
        w["prompt"], max_new_tokens=w["n_new"],
        temperature=w["temperature"], seed=w["seed"])) for w in work]
    eng.run_until_complete(max_steps=2000)
    outs = [h.result().tokens for h in hs]
    snap, widths = eng.stats.snapshot(), sorted(eng._steps)
    assert eng.check_block_accounting() == 0
    eng.close()
    return outs, snap, widths


def _offline(tm, work, cache_dtype=None):
    return [tm.generate(w["prompt"], max_new_tokens=w["n_new"],
                        temperature=w["temperature"], seed=w["seed"],
                        cache_dtype=cache_dtype) for w in work]


def _jax_slot_streams(jm, work, max_slots=3, **kw):
    eng = jm.serve(max_slots=max_slots, **kw)
    assert eng.paged_arena is None
    hs = [eng.submit(JRequest(w["prompt"], max_new_tokens=w["n_new"],
                              temperature=0.0)) for w in work]
    eng.run_until_complete(max_steps=2000)
    out = [np.asarray(h.result().tokens) for h in hs]
    eng.close()
    return out


@pytest.mark.parametrize("cache_dtype", [None, "int8"],
                         ids=["dense", "int8"])
def test_greedy_streams_match_the_jax_slot_engine_and_generate(
        models, cache_dtype):
    """More requests than slots (slots are refilled over stale rows):
    the port's slot engine gives the JAX ``paged=None`` engine's greedy
    streams and its own offline ``generate``'s, dense and int8."""
    jm, tm = models
    work = _workload(4, 7)
    want = _jax_slot_streams(jm, work, cache_dtype=cache_dtype)
    got, snap, _ = _serve(tm, work, cache_dtype=cache_dtype)
    assert snap["paged"] is None
    assert snap["requests"]["completed"] == len(work)
    for g, w, o in zip(got, want, _offline(tm, work, cache_dtype)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, o)


@pytest.mark.parametrize("cache_dtype", [None, "int8"],
                         ids=["dense", "int8"])
@pytest.mark.parametrize("capture", [True, False], ids=["captured", "eager"])
def test_sampled_streams_equal_generate(models, cache_dtype, capture):
    """Greedy and sampled requests, the step prepared once (``capture``)
    or run eagerly: streams equal offline ``generate`` at each seed."""
    _, tm = models
    work = _workload(5, 8, sampled=True)
    assert {w["temperature"] for w in work} == {0.0, 0.9}
    got, _, widths = _serve(tm, work, max_slots=4, cache_dtype=cache_dtype,
                            capture=capture)
    assert widths == ([4] if capture else [])
    for g, o in zip(got, _offline(tm, work, cache_dtype)):
        np.testing.assert_array_equal(g, o)


@pytest.mark.parametrize("cache_dtype", [None, "int8"],
                         ids=["dense", "int8"])
def test_gqa_slot_engine(gqa_models, cache_dtype):
    """GQA (2 kv heads of 4): the arena keeps 2 heads; greedy streams
    equal the JAX slot engine's and ``generate``'s."""
    jm, tm = gqa_models
    work = _workload(8, 5)
    want = _jax_slot_streams(jm, work, cache_dtype=cache_dtype)
    eng = tm.serve(max_slots=3, cache_dtype=cache_dtype)
    kc = eng._kc[0] if cache_dtype else eng._kc
    assert kc.shape == (2, 3, 2, 128, 16)
    eng.close()
    got, _, _ = _serve(tm, work, cache_dtype=cache_dtype)
    for g, w, o in zip(got, want, _offline(tm, work, cache_dtype)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, o)


def test_one_step_prepared_and_the_census_flat(models):
    """The slot arena has one decode width, ``max_slots``: one prepared
    step, counted by ``jit_cache_size``, however many steps and
    admissions follow; closing releases it."""
    _, tm = models
    base = jit_cache_size()
    eng = tm.serve(max_slots=4)
    for seed in (9, 10):
        for w in _workload(seed, 6):
            eng.submit(GenerationRequest(w["prompt"],
                                         max_new_tokens=w["n_new"]))
        while eng.pending:
            eng.step()
            assert jit_cache_size() - base == len(eng._steps) <= 1
    assert sorted(eng._steps) == [4]
    eng.close()
    assert jit_cache_size() == base


def test_arena_layout_and_slot_rows(models):
    """Dense arena (L, S, H_kv, max_len, D) in the compute dtype, int8 a
    (values, scales) pair; an admission writes its prefilled rows into
    its slot (``read_slot`` reads them back equal to ``prefill``'s), and
    a dead slot's step writes only its own lane 0."""
    _, tm = models
    cfg = tm.cfg
    for cache_dtype in (None, "int8"):
        eng = tm.serve(max_slots=2, max_len=64, cache_dtype=cache_dtype)
        shape = (cfg.n_layer, 2, cfg.n_kv_head, 64, cfg.n_embd // cfg.n_head)
        if cache_dtype:
            assert eng._kc[0].shape == shape and eng._kc[0].dtype == torch.int8
            assert eng._kc[1].shape == shape[:-1]
        else:
            assert eng._kc.shape == shape and eng._kc.dtype == torch.float32
        p = np.arange(5, 14, dtype=np.int32)
        eng.submit(GenerationRequest(p, max_new_tokens=3))
        eng.step()                         # admits into slot 0
        kc, _ = eng._x.read_slot(eng._kc, eng._vc, 0)
        _, want, _ = gd.prefill(eng._params, torch.from_numpy(p)[None],
                                cfg.n_head, cfg.layer_norm_eps,
                                quant_cache=bool(cache_dtype))
        for got_l, want_l in zip(gd._leaves(kc), gd._leaves(want)):
            assert torch.equal(got_l[:, :, :, :len(p)], want_l)
        before = [t.clone() for t in gd._leaves(eng._kc)]
        eng.step()                         # slot 1 dead: clamped to pos 0
        for b, a in zip(before, gd._leaves(eng._kc)):
            assert torch.equal(b[:, 1, :, 1:], a[:, 1, :, 1:])
            assert torch.equal(b[:, 0, :, :len(p)], a[:, 0, :, :len(p)])
        eng.run_until_complete(max_steps=20)
        eng.close()


def test_validate_refuses_past_max_len(models):
    """prompt + ``max_new_tokens`` past ``max_len`` is refused at submit,
    as in the JAX engine; up to it is served."""
    _, tm = models
    eng = tm.serve(max_slots=2, max_len=32)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(GenerationRequest(np.arange(20), max_new_tokens=13))
    h = eng.submit(GenerationRequest(np.arange(20), max_new_tokens=12))
    eng.run_until_complete(max_steps=50)
    assert len(h.result().tokens) == 32
    eng.close()
    with pytest.raises(ValueError, match="n_positions"):
        tm.serve(max_len=tm.cfg.n_positions + 1)


def test_pool_decode_step_is_generate_s_step(models):
    """``_pool_decode_step`` at width 3 with one dead lane gives, on its
    live lanes, the logits of ``decode_step`` on those rows alone."""
    _, tm = models
    cfg = tm.cfg
    params = gd.extract_params(tm)
    rng = np.random.RandomState(11)
    shape = (cfg.n_layer, 3, cfg.n_kv_head, 24, cfg.n_embd // cfg.n_head)
    kc = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    vc = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    inp = {"toks": torch.tensor([5, 9, 7], dtype=torch.int32),
           "pos": torch.tensor([4, 11, 17], dtype=torch.int32),
           "live": torch.tensor([1, 0, 1], dtype=torch.int32)}
    got = eng_mod._pool_decode_step(params, kc.clone(), vc.clone(), inp,
                                    cfg.n_head, float(cfg.layer_norm_eps))
    rows = [0, 2]
    x = (params["wte"][[5, 7]] + params["wpe"][[4, 17]])[:, None]
    want, _, _ = gd.decode_step(params, x, kc[:, rows].clone(),
                                vc[:, rows].clone(), torch.tensor([4, 17]),
                                cfg.n_head, float(cfg.layer_norm_eps))
    torch.testing.assert_close(got[rows], want, rtol=0, atol=1e-6)
