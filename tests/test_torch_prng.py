"""``singa_tpu_torch/ops/prng.py`` against ``jax.random`` (JAX 0.9,
threefry-2x32, ``jax_threefry_partitionable`` on, 32-bit integers): keys,
``split``, ``fold_in``, ``random_bits`` and ``uniform`` bit for bit,
``gumbel`` within 4 float32 ulp of 1 (its two logarithms may round apart
in numpy, torch and XLA), ``categorical`` equal away from near-ties of
the noised logits.  Seeds and fold-in data come from hypothesis; shapes
are (V,), (N, V) and odd lengths.  Both the numpy functions (the host
key chain) and the torch ones (the draws inside a captured step) are
held, the torch ones on int32 key words as a step stages them.  The
known-answer vectors were taken from ``jax.random`` once and are the
ones ``chip_smoke.py`` holds the card's draw to.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
import torch

from singa_tpu_torch.ops import prng

SEEDS = st.integers(min_value=-2 ** 40, max_value=2 ** 40)
SHAPES = [(1,), (7,), (256,), (3, 11), (2, 257), (4, 1, 5)]
#: the largest |gumbel - JAX's| allowed: 4 ulp at 1.0
GUMBEL_ATOL = 4 * 2.0 ** -23

#: ``jax.random`` at PRNGKey(42), taken in JAX 0.9.0
KNOWN = dict(
    split3=[[1832780943, 270669613], [64467757, 2916123636],
            [2465931498, 255383827]],
    fold_in7=[2547012911, 1371500959],
    bits8=[2098992034, 2919706841, 2646866425, 2409546199, 1935504149,
           2516274904, 321304473, 3329172656],
    uniform4_bits=[1056585764, 1059981104, 1058915320, 1057988288],
    gumbel4=[0.3340933918952942, 0.952019453048706, 0.7255305647850037,
             0.5481715202331543],
)
#: ``bits(PRNGKey(1), (2, 50257))[1, 50250:]``: the flat counter past a
#: row of GPT-2's vocabulary
KNOWN_ROW = [3015957629, 4147172050, 4260404170, 2641025899, 4003422046,
             699060600, 3255117096]


def _kd(k):
    return np.asarray(jax.random.key_data(k))


def _jkey(words):
    return jax.random.wrap_key_data(jnp.asarray(words, jnp.uint32))


@settings(max_examples=25, deadline=None)
@given(SEEDS, st.integers(min_value=1, max_value=9))
def test_key_and_split_match_jax(seed, n):
    k = jax.random.PRNGKey(seed)
    assert (_kd(k) == prng.PRNGKey(seed)).all()
    assert (_kd(jax.random.split(k, n)) == prng.split(prng.PRNGKey(seed),
                                                       n)).all()
    kt = prng.key_words(prng.PRNGKey(seed), "cpu")
    assert (prng.split_t(kt, n).numpy() == prng.split(prng.PRNGKey(seed),
                                                      n)).all()


@settings(max_examples=25, deadline=None)
@given(SEEDS, st.integers(min_value=0, max_value=2 ** 32 - 1))
def test_fold_in_matches_jax(seed, data):
    k = jax.random.PRNGKey(seed)
    assert (_kd(jax.random.fold_in(k, data))
            == prng.fold_in(prng.PRNGKey(seed), data)).all()


def test_a_batch_of_keys_splits_as_each_alone():
    keys = prng.split(prng.PRNGKey(3), 5)
    both = prng.split(keys, 3)
    for i in range(5):
        assert (both[i] == prng.split(keys[i], 3)).all()
        assert (prng.fold_in(keys, 2)[i] == prng.fold_in(keys[i], 2)).all()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@settings(max_examples=10, deadline=None)
@given(seed=SEEDS)
def test_bits_and_uniform_match_jax(shape, seed):
    k, key = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    want = np.asarray(jax.random.bits(k, shape, jnp.uint32))
    assert (prng.random_bits(key, shape) == want).all()
    u = np.asarray(jax.random.uniform(k, shape))
    assert (prng.uniform(key, shape).view(np.uint32) == u.view(np.uint32)
            ).all()
    u2 = np.asarray(jax.random.uniform(k, shape, minval=-2.0, maxval=3.0))
    assert (prng.uniform(key, shape, -2.0, 3.0).view(np.uint32)
            == u2.view(np.uint32)).all()
    g = np.asarray(jax.random.gumbel(k, shape))
    np.testing.assert_allclose(prng.gumbel(key, shape), g, rtol=0,
                               atol=GUMBEL_ATOL * max(1.0, np.abs(g).max()))


@pytest.mark.parametrize("n", [1, 7, 256, 1001], ids=str)
@settings(max_examples=10, deadline=None)
@given(seed=SEEDS)
def test_torch_rows_match_each_keys_draw(n, seed):
    """(N, n) torch draws from N keys given as int32 words (as a step
    stages them) equal each key's numpy and JAX draw of (n,)."""
    keys = prng.split(prng.PRNGKey(seed), 3)
    kt = torch.from_numpy(keys.view(np.int32))
    bits = prng.random_bits_t(kt, n).numpy()
    u = prng.uniform_t(kt, n).numpy()
    g = prng.gumbel_t(kt, n).numpy()
    for i in range(3):
        jk = _jkey(keys[i])
        want = np.asarray(jax.random.bits(jk, (n,), jnp.uint32))
        assert (bits[i] == want).all()
        assert (bits[i] == prng.random_bits(keys[i], (n,))).all()
        assert (u[i].view(np.uint32) == np.asarray(
            jax.random.uniform(jk, (n,))).view(np.uint32)).all()
        jg = np.asarray(jax.random.gumbel(jk, (n,)))
        np.testing.assert_allclose(g[i], jg, rtol=0,
                                   atol=GUMBEL_ATOL * max(1.0,
                                                          np.abs(jg).max()))


@settings(max_examples=20, deadline=None)
@given(SEEDS, st.integers(min_value=2, max_value=300))
def test_categorical_matches_jax(seed, vocab):
    """One draw a row with its own key; a row whose two best noised
    logits lie within the Gumbel tolerance is a stated near-tie and is
    not compared."""
    rng = np.random.RandomState(seed % 2 ** 32)
    logits = (2.0 * rng.randn(6, vocab)).astype(np.float32)
    keys = prng.split(prng.PRNGKey(seed), 6)
    got_np = np.array([prng.categorical(keys[i], logits[i])
                       for i in range(6)])
    got_t = prng.categorical_t(prng.key_words(keys, "cpu"),
                               torch.from_numpy(logits)).numpy()
    assert (got_np == got_t).all()
    for i in range(6):
        noised = np.sort(prng.gumbel(keys[i], (vocab,)) + logits[i])
        if noised[-1] - noised[-2] < 4 * GUMBEL_ATOL * (1 + abs(noised[-1])):
            continue
        assert int(jax.random.categorical(_jkey(keys[i]), logits[i])) \
            == got_t[i]


def test_known_answers():
    k = prng.PRNGKey(42)
    assert prng.split(k, 3).tolist() == KNOWN["split3"]
    assert prng.fold_in(k, 7).tolist() == KNOWN["fold_in7"]
    assert prng.random_bits(k, (8,)).tolist() == KNOWN["bits8"]
    assert prng.uniform(k, (4,)).view(np.uint32).tolist() == \
        KNOWN["uniform4_bits"]
    np.testing.assert_allclose(prng.gumbel(k, (4,)), KNOWN["gumbel4"],
                               rtol=0, atol=GUMBEL_ATOL)
    assert prng.random_bits(prng.PRNGKey(1), (2, 50257))[1, 50250:] \
        .tolist() == KNOWN_ROW
    kt = prng.key_words(k, "cpu")
    assert prng.random_bits_t(kt, 8).tolist() == KNOWN["bits8"]


def test_draws_stay_inside_a_capture_guard():
    """The torch draws make no host tensor and read nothing back: a step
    captured as a CUDA graph can hold them (the capture guard of
    ``tests/test_torch_graphs.py``)."""
    from test_torch_graphs import _CaptureGuard

    kt = prng.key_words(prng.split(prng.PRNGKey(5), 4), "cpu")
    logits = torch.randn(4, 50)
    with _CaptureGuard() as g:
        prng.categorical_t(kt, logits)
        prng.uniform_t(kt, 3)
        prng.split_t(kt, 3)
    assert g.bad == []
