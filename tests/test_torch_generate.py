"""``generate`` in the port against the JAX package: the sampling filters
(``min_p``, the repetition penalty), the KV-cached path with them, and
the windowed path that ``GPT2LMHead.generate`` takes past
``n_positions``.

``GPT2Config.tiny(dropout=0.0)`` (n_positions 128) in both packages, the
JAX weights carried into the port by ``set_states``; on the CPU.  Filtered
logits compare at atol 1e-5 in float32, with every filtered-out position
at ``NEG_INF`` in both; token streams compare for identity: greedy ones
against the JAX package's, sampled windowed ones too, since both draw
with ``rng.choice`` on float64 probabilities from the same numpy
``RandomState`` (the KV-cached path's noise is the port's own, so there
only greedy streams and seed-free facts compare).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from singa_tpu import tensor as jtensor
from singa_tpu.models import gpt2_decode as jgd
from singa_tpu.models.gpt2 import GPT2Config as JGPT2Config
from singa_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from singa_tpu_torch import device, tensor
from singa_tpu_torch.models import gpt2_decode as gd
from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead

ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    """(JAX model, port model holding the JAX weights), eval mode."""
    ids = np.zeros((1, 16), np.int32)
    jm = JGPT2LMHead(JGPT2Config.tiny(dropout=0.0))
    jm.compile([jtensor.from_numpy(ids)], is_train=False, use_graph=False)
    tm = GPT2LMHead(GPT2Config.tiny(dropout=0.0))
    tm.compile([tensor.from_numpy(ids, device.create_cpu_device())],
               is_train=False)
    tm.set_states({k: jtensor.to_numpy(v)
                   for k, v in jm.get_states().items()})
    return jm, tm


def _prompt(seed, n):
    return np.random.RandomState(seed).randint(0, 256, n).astype(np.int32)


# ------------------------------------------------------------- filters

FILTERS = {
    "min_p": dict(min_p=0.2),
    "rep": dict(rep=1.3),
    "rep_top_k_min_p": dict(rep=1.7, top_k=12, min_p=0.05),
    "top_p_min_p": dict(top_p=0.8, min_p=0.1),
    "all": dict(rep=0.8, top_k=30, top_p=0.9, min_p=0.02),
}


def _jax_filtered(logit, rep_mask, temp, f):
    """The tensor JAX ``_sample`` hands to ``jax.random.categorical``:
    its penalty, ``_filter_logits`` and min-p steps (checked against
    ``_sample`` itself by :func:`test_filters_match_jax_sample`)."""
    x = jnp.asarray(logit)
    if "rep" in f:
        pen = jnp.where(x > 0, x / f["rep"], x * f["rep"])
        x = jnp.where(jnp.asarray(rep_mask), pen, x)
    x = jgd._filter_logits(x, temp, f.get("top_p", 1.0), f.get("top_k", 0),
                           "top_p" in f)
    if "min_p" in f:
        x = jnp.where(x < jnp.max(x) + jnp.log(f["min_p"]), jgd.NEG_INF, x)
    return x


def _jax_sample(logit, key, rep_mask, temp, f, greedy=False):
    return int(jgd._sample(
        jnp.asarray(logit), key, temp, jnp.float32(f.get("top_p", 1.0)),
        greedy, f.get("top_k", 0), "top_p" in f,
        min_p=jnp.float32(f.get("min_p", 1.0)), use_min_p="min_p" in f,
        rep_mask=jnp.asarray(rep_mask) if "rep" in f else None,
        rep_penalty=jnp.float32(f.get("rep", 1.0))))


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_filters_match_jax_sample(name):
    f = FILTERS[name]
    rng = np.random.RandomState(3)
    vocab, temp = 64, 0.7
    logit = (2.0 * rng.randn(vocab)).astype(np.float32)
    rep_mask = rng.rand(vocab) < 0.3
    want = _jax_filtered(logit, rep_mask, temp, f)
    # the reconstruction is what JAX's _sample draws from
    for i in range(16):
        key = jax.random.PRNGKey(i)
        assert _jax_sample(logit, key, rep_mask, temp, f) == int(
            jax.random.categorical(key, want))
    x = torch.from_numpy(logit)[None]
    if "rep" in f:
        x = gd._penalize(x, torch.from_numpy(rep_mask)[None], f["rep"])
    got = gd._filter_logits(x, temp, f.get("top_p"), f.get("top_k", 0),
                            f.get("min_p"))[0].numpy()
    want = np.asarray(want)
    assert np.array_equal(got <= gd.NEG_INF, want <= jgd.NEG_INF)
    keep = want > jgd.NEG_INF
    np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=ATOL)


@pytest.mark.parametrize("penalty", [1.5, 0.6])
def test_greedy_applies_the_penalty_first(penalty):
    """The penalty comes before the greedy argmax: seen tokens lose (or,
    below 1, gain) ground, as in JAX ``_sample``."""
    rng = np.random.RandomState(5)
    logits = (rng.randn(8, 64)).astype(np.float32)
    masks = rng.rand(8, 64) < 0.5
    f = dict(rep=penalty)
    want = [_jax_sample(lg, jax.random.PRNGKey(0), m, 1.0, f, greedy=True)
            for lg, m in zip(logits, masks)]
    got = gd._sample(torch.from_numpy(logits), np.zeros(8), np.zeros(8),
                     np.zeros(8), rep_mask=torch.from_numpy(masks),
                     rep_penalty=penalty)
    assert got.tolist() == want
    assert got.tolist() != logits.argmax(-1).tolist()


def test_rep_mask_init_marks_each_rows_prompt():
    m = gd._rep_mask_init([np.array([3, 3, 7]), np.array([0])], 9,
                          torch.device("cpu"))
    assert m.tolist() == [[i in (3, 7) for i in range(9)],
                          [i == 0 for i in range(9)]]


# ---------------------------------------------------------- KV-cached


def test_cached_greedy_with_penalty_matches_jax(models):
    jm, tm = models
    p = _prompt(1, 9)
    kw = dict(max_new_tokens=12, temperature=0.0, repetition_penalty=1.4)
    want = np.asarray(jm.generate(p, **kw))
    np.testing.assert_array_equal(tm.generate(p, **kw), want)
    np.testing.assert_array_equal(gd.generate(tm, p, **kw), want)
    assert not np.array_equal(
        want, np.asarray(jm.generate(p, max_new_tokens=12,
                                     temperature=0.0)))
    rows = [_prompt(2, 5), _prompt(3, 11)]
    for got, w in zip(tm.generate(rows, **kw), jm.generate(rows, **kw)):
        np.testing.assert_array_equal(got, np.asarray(w))


def test_cached_min_p_one_keeps_only_the_top_token(models):
    """min_p = 1 keeps only the most likely token, so sampling is
    greedy whatever the seed, penalty included."""
    _, tm = models
    p = _prompt(4, 10)
    for rp in (None, 1.2):
        greedy = tm.generate(p, max_new_tokens=10, temperature=0.0,
                             repetition_penalty=rp)
        for seed in (0, 1):
            np.testing.assert_array_equal(
                tm.generate(p, max_new_tokens=10, temperature=0.9,
                            min_p=1.0, seed=seed, repetition_penalty=rp),
                greedy)


# ----------------------------------------------------------- windowed


def test_windowed_greedy_matches_jax_past_n_positions(models):
    """100 + 40 > n_positions 128: both packages take the windowed path,
    one full forward per token over the last 128 tokens."""
    jm, tm = models
    p = _prompt(6, 100)
    want = np.asarray(jm.generate(p, max_new_tokens=40, temperature=0.0))
    got = tm.generate(p, max_new_tokens=40, temperature=0.0)
    assert got.dtype == np.int32 and len(got) == 140
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tm.generate(p, max_new_tokens=40, temperature=0.0, use_cache=False),
        want)


@pytest.mark.parametrize("filters", [
    dict(), dict(top_k=20, top_p=0.9, min_p=0.05, repetition_penalty=1.2)],
    ids=["plain", "filtered"])
def test_windowed_sampled_matches_jax_with_a_numpy_rng(models, filters):
    jm, tm = models
    p = _prompt(7, 110)
    kw = dict(max_new_tokens=30, temperature=0.9, **filters)
    want = np.asarray(jm.generate(p, rng=np.random.RandomState(11), **kw))
    got = tm.generate(p, rng=np.random.RandomState(11), **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tm.generate(p, seed=11, **kw), got)


def test_windowed_equals_cached_inside_n_positions(models):
    _, tm = models
    p = _prompt(8, 40)
    for rp in (None, 1.3):
        np.testing.assert_array_equal(
            tm.generate(p, max_new_tokens=20, temperature=0.0,
                        use_cache=False, repetition_penalty=rp),
            tm.generate(p, max_new_tokens=20, temperature=0.0,
                        use_cache=True, repetition_penalty=rp))


def test_over_length_batch_loops_every_row_through_the_window(models):
    jm, tm = models
    rows = [_prompt(9, 120), _prompt(10, 30)]
    got = tm.generate(rows, max_new_tokens=12, temperature=0.0)
    want = jm.generate(rows, max_new_tokens=12, temperature=0.0)
    assert isinstance(got, list) and len(got) == 2
    for g, w, r in zip(got, want, rows):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(
            g, tm.generate(r, max_new_tokens=12, temperature=0.0,
                           use_cache=False))


@pytest.mark.parametrize("kw,match", [
    (dict(prompt=120, use_cache=True), "n_positions"),
    (dict(batch=True, use_cache=False), "single-prompt"),
    (dict(top_k=-1), "top_k"),
    (dict(top_p=0.0), "top_p"),
    (dict(top_p=1.5), "top_p"),
    (dict(min_p=0.0), "min_p"),
    (dict(min_p=1.5), "min_p"),
    (dict(repetition_penalty=0.0), "repetition_penalty"),
    (dict(prompt=120, repetition_penalty=-1.0), "repetition_penalty"),
    (dict(prompt=120, min_p=2.0), "min_p"),
], ids=["cache_over_length", "batch_windowed", "top_k", "top_p_0",
        "top_p_big", "min_p_0", "min_p_big", "rep_0", "windowed_rep",
        "windowed_min_p"])
def test_typed_errors_match_jax(models, kw, match):
    """Each refusal of the JAX package is a ValueError in the port too,
    on both paths."""
    jm, tm = models
    kw = dict(kw)
    n = kw.pop("prompt", 10)
    ids = [_prompt(0, n), _prompt(1, n)] if kw.pop("batch", False) \
        else _prompt(0, n)
    kw = dict(max_new_tokens=20, temperature=0.9, **kw)
    with pytest.raises(ValueError):
        jm.generate(ids, **kw)
    with pytest.raises(ValueError, match=match):
        tm.generate(ids, **kw)
