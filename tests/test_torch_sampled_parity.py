"""Seeded-sampled streams of the port against the JAX package's, token for
token: the port draws its noise with ``ops/prng.py``'s threefry, keyed as
``jax.random`` keys it (``generate``: ``split(PRNGKey(seed), B)`` and a
split a step; the engine: ``split(PRNGKey(seed), 1)[0]`` at admission, a
split a decode step, ``split(key, 3)`` a speculative step, ``fold_in`` a
fork branch), so the same seed gives the same tokens.

``GPT2Config.tiny`` (vocabulary 256), float32, on the CPU; the JAX weights
carried into the port by a ``save_states`` zip; one JAX run of each kind
per module (module-scoped fixtures).  Covered: batched ``generate`` (one
seed for the batch, ragged prompts, with top-k / top-p); the engine on the
paged arena, the slot arena, int8 pools, and a pool small enough that a
priority scheduler preempts and swaps; speculative decoding (the target
as its own draft, rejection sampling); ``n = 3`` fork branches keyed by
``fold_in``.  The draws' float32 logarithms may round one ulp apart in
torch and XLA, which could flip a token only at a near-tie of two
noised logits; none occurs on these seeds.
"""

import numpy as np
import pytest

import torch

from singa_tpu import device as jdevice
from singa_tpu import tensor as jtensor
from singa_tpu.models.gpt2 import GPT2Config as JGPT2Config
from singa_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from singa_tpu.serve import GenerationRequest as JRequest
from singa_tpu.serve import PagedConfig as JPagedConfig
from singa_tpu_torch import device, tensor
from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from singa_tpu_torch.serve import (GenerationRequest, PagedConfig,
                                   PriorityScheduler)

B = 8
CPU = device.create_cpu_device()
TEMP = 0.9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX model, port model holding its weights)."""
    jdevice.get_default_device().SetRandSeed(0)
    jm = JGPT2LMHead(JGPT2Config.tiny(dropout=0.0))
    jm.compile([jtensor.from_numpy(np.zeros((1, 16), np.int32))],
               is_train=False, use_graph=False)
    path = str(tmp_path_factory.mktemp("sampled") / "m.zip")
    jm.save_states(path)
    m = GPT2LMHead(GPT2Config.tiny(dropout=0.0))
    m.compile([tensor.from_numpy(np.zeros((1, 16), np.int32), CPU)],
              is_train=False)
    m.load_states(path)
    return jm, m


def _traffic(n=6, seed=3):
    """``n`` requests: ragged prompts, mixed lengths, all sampled at
    ``TEMP`` with their own seeds but one greedy."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        out.append(dict(prompt=rng.randint(0, 256, int(rng.randint(3, 20)))
                        .astype(np.int32),
                        max_new=int(rng.randint(6, 14)),
                        temperature=0.0 if i == 2 else TEMP,
                        seed=int(rng.randint(0, 2 ** 31 - 1))))
    return out


def _serve(serve, request, traffic, paged, **kw):
    eng = serve(max_slots=4, paged=paged, **kw)
    hs = [eng.submit(request(w["prompt"], max_new_tokens=w["max_new"],
                             temperature=w["temperature"], seed=w["seed"],
                             **w.get("extra", {})))
          for w in traffic]
    eng.run_until_complete()
    return eng, hs


@pytest.fixture(scope="module")
def jax_streams(pair):
    """The JAX paged engine's streams of ``_traffic()``."""
    jm, _ = pair
    eng, hs = _serve(jm.serve, JRequest, _traffic(),
                     JPagedConfig(block_size=B, num_blocks=64))
    out = [np.asarray(h.result().tokens) for h in hs]
    eng.close()
    return out


def _check(hs, want):
    for h, w in zip(hs, want):
        np.testing.assert_array_equal(np.asarray(h.result().tokens), w)


# ---------------------------------------------------------------- generate


@pytest.mark.parametrize("filters", [dict(), dict(top_k=20),
                                     dict(top_p=0.85)],
                         ids=["plain", "top_k", "top_p"])
def test_generate_sampled_matches_jax(pair, filters):
    """A ragged batch under one seed (drawn from the same numpy rng by
    both): rows keyed ``split(PRNGKey(seed), B)``."""
    jm, m = pair
    rng = np.random.RandomState(11)
    rows = [rng.randint(0, 256, n).astype(np.int32) for n in (5, 9, 9, 14)]
    want = jm.generate(rows, max_new_tokens=12, temperature=TEMP,
                       rng=np.random.RandomState(4), **filters)
    got = m.generate(rows, max_new_tokens=12, temperature=TEMP,
                     rng=np.random.RandomState(4), **filters)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_generate_one_seed_a_row_is_the_engine_key(pair, jax_streams):
    """Row i under ``seed=[...]`` is keyed ``split(PRNGKey(seed_i),
    1)[0]``: the JAX engine's stream of that request."""
    _, m = pair
    traffic = _traffic()
    idx = [i for i, w in enumerate(traffic) if w["temperature"] > 0]
    n_new = max(traffic[i]["max_new"] for i in idx)
    got = m.generate([traffic[i]["prompt"] for i in idx],
                     max_new_tokens=n_new, temperature=TEMP,
                     seed=[traffic[i]["seed"] for i in idx])
    for i, g in zip(idx, got):
        n = len(traffic[i]["prompt"]) + traffic[i]["max_new"]
        np.testing.assert_array_equal(g[:n], jax_streams[i])


# ------------------------------------------------------------------ engine


@pytest.mark.parametrize("arena", ["paged", "slots", "gather"])
def test_engine_sampled_matches_jax_engine(pair, jax_streams, arena):
    _, m = pair
    paged = None if arena == "slots" else PagedConfig(
        block_size=B, num_blocks=64,
        kernel="gather" if arena == "gather" else "block")
    eng, hs = _serve(m.serve, GenerationRequest, _traffic(), paged)
    _check(hs, jax_streams)
    eng.close()


def test_int8_engine_sampled_matches_jax_int8_engine(pair):
    jm, m = pair
    traffic = _traffic(seed=5)
    jeng, jhs = _serve(jm.serve, JRequest, traffic,
                       JPagedConfig(block_size=B, num_blocks=64),
                       cache_dtype="int8")
    want = [np.asarray(h.result().tokens) for h in jhs]
    jeng.close()
    eng, hs = _serve(m.serve, GenerationRequest, traffic,
                     PagedConfig(block_size=B, num_blocks=64),
                     cache_dtype="int8")
    _check(hs, want)
    eng.close()


def test_preempted_and_swapped_streams_match_jax_engine(pair, jax_streams):
    """A pool of 7 blocks under a priority scheduler: three requests
    start, then the other three arrive at a higher priority and preempt
    them, whose blocks and key leave for the host and come back; every
    stream is still the unpressured JAX engine's."""
    _, m = pair
    traffic = _traffic()
    eng = m.serve(max_slots=4, paged=PagedConfig(block_size=B, num_blocks=7),
                  scheduler=PriorityScheduler())

    def submit(w, priority):
        return eng.submit(GenerationRequest(
            w["prompt"], max_new_tokens=w["max_new"],
            temperature=w["temperature"], seed=w["seed"],
            priority=priority))

    hs = [submit(w, 0) for w in traffic[:3]]
    for _ in range(3):
        eng.step()
    hs += [submit(w, 5) for w in traffic[3:]]
    eng.run_until_complete()
    pg = eng.stats.snapshot()["paged"]
    assert pg["preemptions"] > 0 and pg["swap_in"] > 0
    _check(hs, jax_streams)
    eng.close()


def test_speculative_sampled_matches_jax_engine(pair):
    """The target as its own draft at ``spec_k`` 3: proposals drawn with
    ``split(k_draft, spec_k)``, the accept test's uniforms and the
    correction token with ``split(k_verify)``."""
    jm, m = pair
    traffic = _traffic(seed=7)
    jeng, jhs = _serve(jm.serve, JRequest, traffic,
                       JPagedConfig(block_size=B, num_blocks=64),
                       draft_model=jm, spec_k=3)
    want = [np.asarray(h.result().tokens) for h in jhs]
    jeng.close()
    eng, hs = _serve(m.serve, GenerationRequest, traffic,
                     PagedConfig(block_size=B, num_blocks=64),
                     draft_model=m, spec_k=3)
    _check(hs, want)
    eng.close()


def test_fork_branches_sampled_match_jax_engine(pair):
    """``n = 3`` at admission: branch k > 0 keyed ``fold_in(parent key,
    k)``; every branch's stream and score as the JAX engine's."""
    jm, m = pair
    traffic = _traffic(n=3, seed=9)
    for w in traffic:
        w["temperature"] = TEMP
        w["extra"] = dict(n=3)
    jeng, jhs = _serve(jm.serve, JRequest, traffic,
                       JPagedConfig(block_size=B, num_blocks=64))
    want = [[np.asarray(r.tokens) for r in h.results()] for h in jhs]
    jeng.close()
    eng, hs = _serve(m.serve, GenerationRequest, traffic,
                     PagedConfig(block_size=B, num_blocks=64))
    for h, ws in zip(hs, want):
        got = [np.asarray(r.tokens) for r in h.results()]
        assert len(got) == 3
        for g, w in zip(got, ws):
            np.testing.assert_array_equal(g, w)
        assert not all(np.array_equal(got[0], g) for g in got[1:])
    eng.close()
