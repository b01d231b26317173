"""The port's beam search (``gpt2_decode.generate_beam``,
``_beam_search``) against the JAX package's (``generate_beam``,
``_beam_search_cached``): the counterparts of the beam tests of
``tests/test_gpt2.py`` (the GQA, window, int8, exhaustive and batched
ones; the tensor-parallel and MoE ones wait for their slices).

``GPT2Config.tiny`` models (and a 6-token vocabulary for the exhaustive
search), float32 on the CPU, the JAX weights carried into the port by
``set_states``.  Every beam's tokens compare for identity and its total
log-probability within atol 1e-5 (the dead beams of ``num_beams > V``
at ``NEG_INF`` in both); ``num_beams = 1`` is the port's greedy
``generate`` token for token, at the same ``cache_dtype``.
"""

import itertools

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from singa_tpu import device as jdevice
from singa_tpu import tensor as jtensor
from singa_tpu.models import gpt2_decode as jgd
from singa_tpu.models.gpt2 import GPT2Config as JGPT2Config
from singa_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from singa_tpu_torch import device, tensor
from singa_tpu_torch.models import gpt2_decode as gd
from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead

ATOL = 1e-5
CPU = device.create_cpu_device()
SMALL_V = dict(vocab_size=6, n_positions=16, n_embd=32, n_layer=2,
               n_head=4, n_inner=64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed=0, **kw):
    """(JAX model, port model holding its weights), ``tiny`` with ``kw``
    (or the 6-token model for ``small_v``)."""
    cfg = dict(SMALL_V) if kw.pop("small_v", False) else {}
    cfg.update(kw, dropout=0.0)
    jdevice.get_default_device().SetRandSeed(seed)
    jm = JGPT2LMHead(JGPT2Config.tiny(**cfg))
    jm.compile([jtensor.from_numpy(np.zeros((1, 8), np.int32))],
               is_train=False, use_graph=False)
    tm = GPT2LMHead(GPT2Config.tiny(**cfg))
    tm.compile([tensor.from_numpy(np.zeros((1, 8), np.int32), CPU)],
               is_train=False)
    tm.set_states({k: jtensor.to_numpy(v)
                   for k, v in jm.get_states().items()})
    return jm, tm


def _jax_beams(jm, prompts, n_new, k, cache_dtype=None):
    """Every beam's tokens and total log-probability from the JAX
    ``_beam_search_cached``, as ``generate_beam`` calls it."""
    cfg = jm.cfg
    _, _, _, max_len, padded, start = jgd._normalize_prompts(prompts, n_new,
                                                             cfg)
    seqs, scores = jgd._beam_search_cached(
        jgd.extract_params(jm), jnp.asarray(padded), max_len, cfg.n_head,
        float(cfg.layer_norm_eps), n_new, cfg.n_positions, k, start=start,
        quant_cache=jgd._quant_flag(cache_dtype),
        window=jgd._norm_window(cfg))
    return np.asarray(seqs), np.asarray(scores)


def _port_beams(tm, prompts, n_new, k, cache_dtype=None):
    rows = [np.asarray(p, np.int32) for p in prompts]
    with torch.no_grad():
        seqs, scores = gd._beam_search(gd.extract_params(tm), rows, n_new,
                                       tm.cfg, k,
                                       gd._quant_flag(cache_dtype))
    return seqs.numpy(), scores.numpy()


def _prompts(vocab, lens, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, vocab, n).astype(np.int32) for n in lens]


#: name -> (model kwargs, prompt lengths, new tokens, beams, cache dtype)
CASES = {
    "single": ({}, (7,), 8, 4, None),
    "ragged": ({}, (8, 3, 11), 6, 3, None),
    "mqa": (dict(n_kv_head=1), (5, 9), 8, 4, None),
    "int8_gqa_ragged": (dict(n_kv_head=2), (5, 9), 6, 2, "int8"),
    "window_gqa_int8": (dict(attn_window=6, n_positions=64, n_kv_head=2),
                        (5, 11), 5, 2, "int8"),
    "window_long": (dict(attn_window=8, n_positions=64), (20,), 12, 3,
                    None),
    "beams_over_vocab": (dict(small_v=True), (3, 2), 3, 8, None),
    "one_beam": ({}, (6, 10), 7, 1, None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_beams_match_jax(name):
    kw, lens, n_new, k, cache = CASES[name]
    jm, tm = _pair(**kw)
    prompts = _prompts(tm.cfg.vocab_size, lens, seed=len(name))
    want_t, want_s = _jax_beams(jm, prompts, n_new, k, cache)
    got_t, got_s = _port_beams(tm, prompts, n_new, k, cache)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=ATOL)
    V = tm.cfg.vocab_size
    if k > V:
        # one token: the beams past V stay dead, at NEG_INF in both
        want_t, want_s = _jax_beams(jm, prompts, 1, k, cache)
        got_t, got_s = _port_beams(tm, prompts, 1, k, cache)
        np.testing.assert_array_equal(got_t, want_t)
        np.testing.assert_allclose(got_s, want_s, rtol=0, atol=ATOL)
        assert (got_s[:, V:] <= gd.NEG_INF / 2).all()
        assert (got_s[:, :V] > gd.NEG_INF / 2).all()
    out = gd.generate_beam(tm, prompts if len(prompts) > 1 else prompts[0],
                           max_new_tokens=n_new, num_beams=k,
                           cache_dtype=cache)
    want = jgd.generate_beam(jm, prompts if len(prompts) > 1
                             else prompts[0], max_new_tokens=n_new,
                             num_beams=k, cache_dtype=cache)
    if len(prompts) == 1:
        out, want = [out], [want]
    for o, w in zip(out, want):
        np.testing.assert_array_equal(o, w)


@pytest.mark.parametrize("kw,cache", [({}, None), (dict(n_kv_head=1), None),
                                      (dict(n_kv_head=2), "int8"),
                                      (dict(attn_window=6, n_positions=64),
                                       None)])
def test_one_beam_is_greedy(kw, cache):
    _, tm = _pair(**kw)
    for p in _prompts(256, (5, 9), seed=1):
        np.testing.assert_array_equal(
            gd.generate_beam(tm, p, max_new_tokens=8, num_beams=1,
                             cache_dtype=cache),
            gd.generate(tm, p, max_new_tokens=8, temperature=0,
                        cache_dtype=cache))


def test_batched_equals_per_row():
    """A ragged batch in one loop equals each prompt alone: the
    block-diagonal parent gather never mixes prompts."""
    _, tm = _pair()
    prompts = [np.arange(8) % 256, np.asarray([3, 1, 4]),
               (np.arange(11) + 5) % 256]
    batched = gd.generate_beam(tm, prompts, max_new_tokens=6, num_beams=3)
    assert isinstance(batched, list) and len(batched) == 3
    for p, got in zip(prompts, batched):
        np.testing.assert_array_equal(
            got, gd.generate_beam(tm, np.asarray(p), max_new_tokens=6,
                                  num_beams=3))
        assert got[:len(p)].tolist() == list(p)


def test_wide_beam_finds_exhaustive_best():
    """On the 6-token model a beam of V^2 covers every level of a
    3-token search, so it finds the best of all V^3 continuations (scored
    by teacher-forced forwards in float64, near-ties within 1e-4 nats);
    4 beams never score below greedy; bad arguments raise."""
    _, tm = _pair(seed=3, small_v=True)
    cfg = tm.cfg
    prompt = np.asarray([1, 4, 2], np.int32)
    T = 3
    params = gd.extract_params(tm)
    conts = np.asarray(list(itertools.product(range(cfg.vocab_size),
                                              repeat=T)), np.int64)
    ids = torch.as_tensor(np.concatenate(
        [np.broadcast_to(prompt, (len(conts), len(prompt))), conts], 1))
    with torch.no_grad():
        hidden, _, _ = gd.prefill(params, ids, cfg.n_head,
                                  float(cfg.layer_norm_eps))
        lp = torch.log_softmax(gd._logits(hidden, params).double(), -1)
    steps = torch.arange(T) + len(prompt) - 1
    totals = lp[:, steps].gather(-1, torch.as_tensor(conts)[..., None])
    score = dict(zip(map(tuple, conts.tolist()),
                     totals[..., 0].sum(-1).tolist()))
    best = max(score.values())
    wide = gd.generate_beam(tm, prompt, max_new_tokens=T,
                            num_beams=cfg.vocab_size ** 2)
    assert score[tuple(wide[len(prompt):].tolist())] >= best - 1e-4
    greedy = gd.generate(tm, prompt, max_new_tokens=T, temperature=0)
    np.testing.assert_array_equal(
        gd.generate_beam(tm, prompt, max_new_tokens=T, num_beams=1),
        greedy)
    g4 = gd.generate_beam(tm, prompt, max_new_tokens=T, num_beams=4)
    assert score[tuple(g4[len(prompt):].tolist())] >= \
        score[tuple(greedy[len(prompt):].tolist())] - 1e-9
    with pytest.raises(ValueError, match="num_beams"):
        gd.generate_beam(tm, prompt, max_new_tokens=2, num_beams=0)
    with pytest.raises(ValueError, match="n_positions"):
        gd.generate_beam(tm, prompt, max_new_tokens=cfg.n_positions)
    outs = gd.generate_beam(tm, np.zeros((2, 3), np.int32),
                            max_new_tokens=2)
    assert isinstance(outs, list) and [len(o) for o in outs] == [5, 5]


def test_top_k_orders_equal_totals_by_the_raw_logit():
    """Two logits one ulp apart tie once ``log_softmax`` subtracts a
    normalizer ten times their size; ``_top_k`` orders them by the raw
    logit, as greedy's argmax does, then by index."""
    logits = torch.full((1, 4096), 1.0)
    logits[0, 7] = 2.0
    logits[0, 9] = float(np.nextafter(np.float32(2.0), np.float32(3.0)))
    lp = torch.log_softmax(logits, -1)
    assert lp[0, 7] == lp[0, 9]
    _, idx = gd._top_k(lp, 3, logits)
    assert idx.tolist() == [[9, 7, 0]] and logits.argmax().item() == 9
