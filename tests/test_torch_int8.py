"""int8 KV caches in the port (``cache_dtype="int8"``) against the JAX
package: the quantizer, int8 prefill, the dense and paged int8 decode
steps, ``paged_attn_plain`` on int8 pools, int8 ``generate`` and the
int8 paged engine, with preemption and swap.

``GPT2Config.tiny(dropout=0.0)`` (and a GQA variant, 2 kv heads of 4)
is built in both packages and the JAX weights are carried into the port
by ``set_states``; inputs come from numpy seeds; everything runs on the
CPU (``paged_attn`` takes its plain version; the int8 kernel is held
against it by tests/test_torch_kernels_emulated.py and, on the card,
tests/test_torch_kernels_cuda.py and ``chip_smoke.py``).

Tolerances: the quantizer is byte-equal on equal inputs, ties to even
included.  Where the two packages compute the float K/V they quantize
(prefill, a decode step's own row), those differ by a few float32 ulps
(the packages sum the same terms in other orders, and the CPU's BLAS
orders them by its thread count): the float rows are within atol 1e-5
(tests/test_torch_serve.py), so the scales, max|x| / 127 of those rows,
are compared at atol 1e-5 / 127, and an int8 value may land on the other
side of a rounding boundary: values within 1 of JAX's, at most 0.1% of
them differing at all (none did in the runs recorded).  The
quantization step itself is held byte-equal on the JAX package's float
rows.  Logits atol 1e-5 (values O(1));
``paged_attn_plain`` atol 1e-5 in float32 (dequantized values O(1),
up to 1000 lanes).  Token streams compare for identity: greedy against
the JAX package, greedy and sampled between the port's engines and its
offline int8 ``generate``.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU: tests/conftest.py)
import jax.numpy as jnp
import torch

import chip_smoke
from singa_tpu import tensor as jtensor
from singa_tpu.models import gpt2_decode as jgd
from singa_tpu.models.gpt2 import GPT2Config as JGPT2Config
from singa_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from singa_tpu.serve import GenerationRequest as JRequest
from singa_tpu.serve import PagedConfig as JPagedConfig
from singa_tpu_torch import device, tensor
from singa_tpu_torch.models import gpt2_decode as gd
from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from singa_tpu_torch.ops import paged_attention as pa
from singa_tpu_torch.serve import GenerationRequest, PagedConfig, PagedKVArena
from singa_tpu_torch.serve.kvimage import KVImageError

ATOL = 1e-5
SCALE_ATOL = ATOL / 127
VALUES_DIFFERING = 1e-3


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


@pytest.fixture(scope="module")
def params(models):
    jm, tm = models
    return jgd.extract_params(jm), gd.extract_params(tm)


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _assert_int8_close(got, want, what=""):
    """(values, scales) pairs quantized from float rows that agree within
    ``ATOL``: values within 1, at most ``VALUES_DIFFERING`` of them off;
    scales within ``SCALE_ATOL`` (module docstring)."""
    diff = np.abs(_np(got[0]).astype(np.int32)
                  - np.asarray(want[0]).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= VALUES_DIFFERING, \
        (what, diff.max(), (diff > 0).mean())
    np.testing.assert_allclose(_np(got[1]), np.asarray(want[1]), rtol=0,
                               atol=SCALE_ATOL, err_msg=f"{what} scales")


def _workload(seed, n, p_lo=3, p_hi=20, n_lo=2, n_hi=12, sampled=False):
    rng = np.random.RandomState(seed)
    return [dict(prompt=rng.randint(0, 256, rng.randint(p_lo, p_hi))
                 .astype(np.int32),
                 n_new=int(rng.randint(n_lo, n_hi)),
                 temperature=(float(rng.choice([0.0, 0.9])) if sampled
                              else 0.0),
                 seed=int(rng.randint(0, 1000))) for _ in range(n)]


def _offline(tm, work):
    return [tm.generate(w["prompt"], max_new_tokens=w["n_new"],
                        temperature=w["temperature"], seed=w["seed"],
                        cache_dtype="int8") for w in work]


def _serve(tm, work, max_slots=3, scheduler=None, **paged):
    eng = tm.serve(max_slots=max_slots, cache_dtype="int8",
                   scheduler=scheduler,
                   paged=PagedConfig(**{"block_size": 8, "num_blocks": 64,
                                        **paged}))
    hs = [eng.submit(GenerationRequest(
        w["prompt"], max_new_tokens=w["n_new"],
        temperature=w["temperature"], seed=w["seed"])) for w in work]
    eng.run_until_complete(max_steps=4000)
    outs = [h.result().tokens for h in hs]
    snap = eng.stats.snapshot()["paged"]
    eng.check_block_accounting()
    eng.close()
    return outs, snap


# ------------------------------------------------------------ quantizer


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_byte_equal_to_jax(dtype):
    """Values and scales equal the JAX quantizer's byte for byte: random
    rows, rows whose scale is exactly 1 with every value a tie (x.5,
    rounded half to even), an all-zero row (scale 1e-8)."""
    rng = np.random.RandomState(0)
    x = (3.0 * rng.randn(4, 3, 7, 24)).astype(np.float32)
    ties = np.arange(-11.5, 12.0, 1.0, dtype=np.float32)  # 24 values
    x[0, 0, 0] = ties
    x[0, 0, 0, 0] = 127.0                                  # scale 1
    x[1, 2, 3] = 0.0
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jgd._quantize_kv(jx)
    tq, ts = gd._quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(_np(tq), np.asarray(jq))
    assert np.array_equal(_np(ts).view(np.uint32),
                          np.asarray(js).view(np.uint32))
    assert _np(ts)[1, 2, 3] == np.float32(1e-8)
    # half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2, -0.5 -> 0, -1.5 -> -2
    row = dict(zip(ties.tolist(), _np(tq)[0, 0, 0].tolist()))
    assert [row[v] for v in (0.5, 1.5, 2.5, -0.5, -1.5)] == [0, 2, 2, 0, -2]
    np.testing.assert_array_equal(
        _np(gd._dequantize_kv(tq, ts, torch.float32)),
        np.asarray(jgd._dequantize_kv(jq, js, jnp.float32)))


def test_quant_flag_takes_none_and_int8_only():
    assert gd._quant_flag(None) is False and gd._quant_flag("int8") is True
    for bad in ("int4", "float16", torch.int8):
        with pytest.raises(ValueError, match="cache_dtype"):
            gd._quant_flag(bad)


# ---------------------------------------------------------- decode math


def test_int8_prefill_matches_jax(models, params):
    """``prefill(quant_cache=True)`` against the JAX package's
    (``_assert_int8_close``); quantizing the JAX package's own float rows
    in the port gives its int8 prefill byte for byte."""
    _, tm = models
    jp, tp = params
    cfg = tm.cfg
    ids = np.random.RandomState(0).randint(0, 256, (2, 11)).astype(np.int32)
    _, jk, jv = jgd.prefill(jp, jnp.asarray(ids), cfg.n_head,
                            cfg.layer_norm_eps, quant_cache=True)
    th, tk, tv = gd.prefill(tp, torch.from_numpy(ids), cfg.n_head,
                            cfg.layer_norm_eps, quant_cache=True)
    assert tk[0].dtype == torch.int8 and tk[1].shape == tk[0].shape[:-1]
    _assert_int8_close(tk, jk, "k")
    _assert_int8_close(tv, jv, "v")
    _, fk, _ = jgd.prefill(jp, jnp.asarray(ids), cfg.n_head,
                           cfg.layer_norm_eps)
    q, s = gd._quantize_kv(torch.from_numpy(np.array(fk)))
    assert np.array_equal(_np(q), np.asarray(jk[0]))
    assert np.array_equal(_np(s), np.asarray(jk[1]))
    # the hidden states do not depend on the cache's dtype
    th0, _, _ = gd.prefill(tp, torch.from_numpy(ids), cfg.n_head,
                           cfg.layer_norm_eps)
    assert torch.equal(th, th0)


def _int8_cache(jk, ctx, pos):
    """A (values, scales) cache of ``ctx`` lanes holding the JAX int8
    prefill rows at lanes < pos, as numpy arrays."""
    vals = np.zeros(jk[0].shape[:3] + (ctx, jk[0].shape[-1]), np.int8)
    scales = np.zeros(jk[1].shape[:3] + (ctx,), np.float32)
    vals[..., :pos, :] = np.asarray(jk[0])
    scales[..., :pos] = np.asarray(jk[1])
    return vals, scales


def test_int8_decode_step_matches_jax(models, params):
    """One dense decode step on int8 caches from the same JAX int8
    prefill: logits atol 1e-5, the written lane as
    ``_assert_int8_close``, every other lane byte for byte."""
    _, tm = models
    jp, tp = params
    cfg = tm.cfg
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 256, (2, 10)).astype(np.int32)
    ctx, pos = 16, 10
    _, jk, jv = jgd.prefill(jp, jnp.asarray(ids), cfg.n_head,
                            cfg.layer_norm_eps, quant_cache=True)
    kc, vc = _int8_cache(jk, ctx, pos), _int8_cache(jv, ctx, pos)
    toks = rng.randint(0, 256, 2)
    x = _np(tp["wte"])[toks][:, None] + _np(tp["wpe"])[pos][None, None]
    jl, jkc, jvc = jgd.decode_step(
        jp, jnp.asarray(x), tuple(map(jnp.asarray, kc)),
        tuple(map(jnp.asarray, vc)), pos, cfg.n_head, cfg.layer_norm_eps)
    tkc = tuple(torch.from_numpy(a.copy()) for a in kc)
    tvc = tuple(torch.from_numpy(a.copy()) for a in vc)
    tl, tkc, tvc = gd.decode_step(tp, torch.from_numpy(x), tkc, tvc,
                                  torch.tensor([pos, pos]), cfg.n_head,
                                  cfg.layer_norm_eps)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0, atol=ATOL)
    for got, want, before in ((tkc, jkc, kc), (tvc, jvc, vc)):
        _assert_int8_close((got[0][..., pos, :], got[1][..., pos]),
                           (want[0][..., pos, :], want[1][..., pos]))
        others = [i for i in range(ctx) if i != pos]
        assert np.array_equal(_np(got[0])[..., others, :],
                              before[0][..., others, :])
        assert np.array_equal(_np(got[1])[..., others], before[1][..., others])


def _int8_pool(rng, shape):
    return gd._quantize_kv(torch.from_numpy(
        (0.5 * rng.randn(*shape)).astype(np.float32)))


def test_int8_decode_step_paged_matches_jax(models, params):
    """Three slots in one call on int8 pools (a partial last block,
    ``pos`` on a block boundary, a dead slot) against the JAX function
    slot by slot: logits atol 1e-5, the written block as
    ``_assert_int8_close`` against the JAX read-modify-written block, and
    blocks no live slot writes keep their bytes."""
    _, tm = models
    jp, tp = params
    cfg = tm.cfg
    B, N, L = 8, 12, cfg.n_layer
    d = cfg.n_embd // cfg.n_head
    rng = np.random.RandomState(2)
    shape = (L, N + 1, cfg.n_kv_head, B, d)
    pool_k, pool_v = _int8_pool(rng, shape), _int8_pool(rng, shape)
    np_k = tuple(_np(t).copy() for t in pool_k)
    np_v = tuple(_np(t).copy() for t in pool_v)
    tables = np.full((3, 6), N, np.int32)
    tables[0, :2] = [5, 2]
    tables[1, :3] = [7, 0, 9]
    pos = np.array([13, 16, 0], np.int32)
    toks = rng.randint(0, 256, 3)
    x = _np(tp["wte"])[toks][:, None] + _np(tp["wpe"])[pos][:, None]
    n_blk = int(((pos + B - 1) // B).max())
    tl = gd.decode_step_paged(tp, torch.from_numpy(x), pool_k, pool_v,
                              torch.from_numpy(tables), torch.from_numpy(pos),
                              cfg.n_head, cfg.layer_norm_eps, block=B)
    jk = tuple(map(jnp.asarray, np_k))
    jv = tuple(map(jnp.asarray, np_v))
    for s in range(3):
        jl, kb, vb = jgd.decode_step_paged(
            jp, jnp.asarray(x[s:s + 1]), jk, jv, jnp.asarray(tables[s]),
            jnp.int32(pos[s]), jnp.int32(n_blk), cfg.n_head,
            cfg.layer_norm_eps, block=B, trash=N)
        np.testing.assert_allclose(_np(tl[s]), np.asarray(jl[0]), rtol=0,
                                   atol=ATOL)
        if s < 2:
            blk = tables[s, pos[s] // B]
            _assert_int8_close((pool_k[0][:, blk], pool_k[1][:, blk]), kb)
            _assert_int8_close((pool_v[0][:, blk], pool_v[1][:, blk]), vb)
    untouched = [b for b in range(N) if b not in (2, 9)]
    for got, before in ((pool_k, np_k), (pool_v, np_v)):
        for leaf, old in zip(got, before):
            assert np.array_equal(_np(leaf)[:, untouched], old[:, untouched])


# --------------------------------------------------------- paged_attn_plain


def _jax_paged(a):
    """``_paged_attn`` slot by slot with tuple pools: (S, n_kv, g, Q, D)."""
    block = a["pool_k"][0].shape[2]
    trash = a["pool_k"][0].shape[0] - 1
    n_blk = max(-(-int(p) // block) for p in a["p_limit"])

    def j(t):
        return tuple(jnp.asarray(x.numpy()) for x in t)

    pk, pv, kc, vc = j(a["pool_k"]), j(a["pool_v"]), j(a["k_cur"]), \
        j(a["v_cur"])
    blk_lo = a["blk_lo"]
    out = []
    for s in range(a["q"].shape[0]):
        out.append(np.asarray(jgd._paged_attn(
            jnp.asarray(a["q"][s].numpy()), pk, pv,
            jnp.asarray(a["tables"][s].numpy()),
            jnp.int32(int(a["p_limit"][s])), jnp.int32(n_blk), block, trash,
            (kc[0][s], kc[1][s]), (vc[0][s], vc[1][s]),
            jnp.asarray(a["cur_mask"].numpy()), a["scale"],
            window=a["window"],
            blk_lo=None if blk_lo is None else jnp.int32(blk_lo))))
    return np.stack(out)


@pytest.fixture
def cpu_inputs(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", torch.device("cpu"))


PAGED_CASES = [pytest.param(seed, kw, id=name) for seed, (name, kw)
               in enumerate(chip_smoke.paged_edge_cases())]


@pytest.mark.parametrize("seed,kw", PAGED_CASES)
def test_paged_attn_plain_on_int8_pools_matches_jax(cpu_inputs, seed, kw):
    """Every ``chip_smoke.paged_edge_cases()`` case (windows, GQA, Q > 1,
    dead slots, D 16 to 1024) on int8 pools, float32 q: the port's plain
    version against the JAX ``_paged_attn`` with (values, scales) pools,
    atol 1e-5."""
    a = chip_smoke.paged_inputs(dtype=torch.float32, seed=seed, quant=True,
                                **kw)
    got = pa.paged_attn_plain(**a)
    assert got.dtype == torch.float32
    want = _jax_paged(a)
    assert np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=ATOL)


def test_paged_attn_plain_int8_is_the_dequantized_float_attention(
        cpu_inputs):
    """The scales' placement is exact algebra: on int8 pools the plain
    version equals it on the dequantized float pools (atol 1e-5)."""
    a = chip_smoke.paged_inputs(dtype=torch.float32, seed=5, quant=True,
                                **chip_smoke.paged_edge_cases()[8][1])
    deq = {k: (gd._dequantize_kv(*v, torch.float32)
               if isinstance(v, tuple) else v) for k, v in a.items()}
    np.testing.assert_allclose(_np(pa.paged_attn_plain(**a)),
                               _np(pa.paged_attn_plain(**deq)),
                               rtol=0, atol=ATOL)


# ------------------------------------------------------------- generate


def test_int8_generate_greedy_matches_jax(models, gqa_models):
    """Greedy int8 ``generate`` tokens equal the JAX package's: one
    prompt, a ragged batch, and the GQA model."""
    jm, tm = models
    rng = np.random.RandomState(3)
    p = rng.randint(0, 256, 9).astype(np.int32)
    np.testing.assert_array_equal(
        tm.generate(p, max_new_tokens=10, temperature=0.0,
                    cache_dtype="int8"),
        np.asarray(jgd.generate(jm, p, max_new_tokens=10, temperature=0.0,
                                cache_dtype="int8")))
    prompts = [rng.randint(0, 256, n).astype(np.int32) for n in (7, 12, 3)]
    want = jgd.generate(jm, prompts, max_new_tokens=6, temperature=0.0,
                        cache_dtype="int8")
    got = tm.generate(prompts, max_new_tokens=6, temperature=0.0,
                      cache_dtype="int8")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    jg, tg = gqa_models
    np.testing.assert_array_equal(
        tg.generate(p, max_new_tokens=8, temperature=0.0,
                    cache_dtype="int8"),
        np.asarray(jgd.generate(jg, p, max_new_tokens=8, temperature=0.0,
                                cache_dtype="int8")))


def test_int8_generate_refuses_the_windowed_path(models):
    _, tm = models
    with pytest.raises(ValueError, match="cache_dtype"):
        tm.generate(np.arange(4), max_new_tokens=2, use_cache=False,
                    cache_dtype="int8")


# --------------------------------------------------------------- engine


def test_int8_paged_engine_matches_jax_and_generate(models):
    """Greedy streams of the int8 paged engine equal the JAX int8 paged
    engine's and the port's int8 ``generate``; the gather oracle gives
    the kernel route's streams; no block is left."""
    jm, tm = models
    work = _workload(4, 6)
    eng = jm.serve(max_slots=3, cache_dtype="int8",
                   paged=JPagedConfig(block_size=8, num_blocks=64))
    hs = [eng.submit(JRequest(w["prompt"], max_new_tokens=w["n_new"],
                              temperature=0.0)) for w in work]
    eng.run_until_complete(max_steps=2000)
    want = [np.asarray(h.result().tokens) for h in hs]
    eng.close()
    block, snap = _serve(tm, work)
    gather, _ = _serve(tm, work, kernel="gather")
    assert snap["quant"] and snap["blocks_used"] == 0
    for a, b, c, w in zip(block, gather, _offline(tm, work), want):
        np.testing.assert_array_equal(a, w)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_int8_engine_sampled_equals_generate(models, gqa_models):
    """Greedy and sampled requests on int8 pools, the tiny model and the
    GQA one: streams equal offline int8 ``generate`` at each seed."""
    for m in (models[1], gqa_models[1]):
        work = _workload(5, 6, sampled=True)
        assert {w["temperature"] for w in work} == {0.0, 0.9}
        outs, snap = _serve(m, work)
        assert snap["blocks_used"] == 0
        for a, b in zip(outs, _offline(m, work)):
            np.testing.assert_array_equal(a, b)


def test_int8_preempt_resume_byte_parity(models):
    """``tests/test_torch_preempt.py``'s over-committed pool (4 slots, 10
    blocks of 8) on int8 pools: requests are swapped out mid-decode with
    their scales and resumed; streams, greedy and sampled, equal a run
    that never preempts and offline int8 ``generate``; no block left."""
    _, tm = models
    work = _workload(1, 6, n_lo=12, n_hi=30, p_lo=4, p_hi=20, sampled=True)
    roomy, snap0 = _serve(tm, work, max_slots=4)
    outs, snap = _serve(tm, work, max_slots=4, num_blocks=10)
    assert snap0["preemptions"] == 0
    assert snap["preemptions"] > 0 and snap["swap_in"] > 0
    assert snap["swap_out"] == snap["swap_in"] == snap["preemptions"]
    assert snap["blocks_used"] == 0
    for a, b, c in zip(outs, roomy, _offline(tm, work)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_int8_pressured_greedy_streams_match_the_jax_engine(models):
    """The same over-committed int8 pool in both packages, greedy: both
    preempt, and the streams are equal."""
    jm, tm = models
    work = _workload(1, 6, n_lo=12, n_hi=30, p_lo=4, p_hi=20)
    eng = jm.serve(max_slots=4, cache_dtype="int8",
                   paged=JPagedConfig(block_size=8, num_blocks=10))
    hs = [eng.submit(JRequest(w["prompt"], max_new_tokens=w["n_new"],
                              temperature=0.0)) for w in work]
    eng.run_until_complete(max_steps=4000)
    want = [np.asarray(h.result().tokens) for h in hs]
    assert eng.stats.snapshot()["paged"]["preemptions"] > 0
    eng.close()
    got, snap = _serve(tm, work, max_slots=4, num_blocks=10)
    assert snap["preemptions"] > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------ arena and images


def _arena(quant=True, block=4):
    return PagedKVArena(PagedConfig(block_size=block, num_blocks=8), 2, 3, 8,
                        torch.float32, 32, torch.device("cpu"), quant=quant)


def test_int8_swap_round_trips_both_leaves():
    """``swap_out`` then ``swap_in`` into other blocks on an int8 pool:
    values and scales come back byte for byte, the image carries both
    leaves and ``quant``."""
    arena = _arena()
    assert arena.pool_k[0].dtype == torch.int8
    assert arena.pool_k[1].shape == (2, 9, 3, 4)
    rng = np.random.RandomState(0)
    for pool in (arena.pool_k, arena.pool_v):
        q, s = _int8_pool(rng, tuple(pool[0].shape))
        pool[0].copy_(q)
        pool[1].copy_(s)
    src = arena.alloc(3)
    img = arena.swap_out(src, 2)
    assert img.quant and img.n_data == 2 and img.width == 8
    assert img.kc[0].dtype == torch.int8 and img.kc[1].shape == (2, 1, 3, 8)
    assert img.nbytes == 2 * (2 * 3 * 8 * 8 + 4 * 2 * 3 * 8)
    dst = arena.alloc(3)
    arena.swap_in(img, dst)
    for pool in (arena.pool_k, arena.pool_v):
        for leaf in pool:
            assert torch.equal(leaf[:, dst[:2]], leaf[:, src[:2]])
    snap = arena.snapshot()
    assert snap["quant"] and (snap["swap_out"], snap["swap_in"]) == (1, 1)
    arena.unregister()


def test_kvimage_refuses_to_mix_dense_and_int8():
    """A dense image into an int8 pool and an int8 image into a dense
    pool fail typed before any scatter; so does an int8 image whose
    scales were changed after packing."""
    dense, quant = _arena(quant=False), _arena(quant=True)
    d_img = dense.swap_out(dense.alloc(2), 2)
    q_img = quant.swap_out(quant.alloc(2), 2)
    before = [t.clone() for t in quant.pool_k + quant.pool_v]
    with pytest.raises(KVImageError, match="quant"):
        quant.swap_in(d_img, quant.alloc(2))
    with pytest.raises(KVImageError, match="quant"):
        dense.swap_in(q_img, dense.alloc(2))
    q_img.kc[1][0, 0, 0, 0] += 1.0
    with pytest.raises(KVImageError, match="corrupted"):
        quant.swap_in(q_img, quant.alloc(2))
    after = quant.pool_k + quant.pool_v
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert quant.snapshot()["swap_in"] == 0
    dense.unregister()
    quant.unregister()
