"""Preemption and swap in the port's paged engine (``serve/engine.py``,
``serve/paged.py`` ``swap_out`` / ``swap_in``, ``serve/kvimage.py``),
the scenarios of ``tests/test_paged.py`` held on the port.

The JAX tests hold pressured streams against the slot-arena engine,
which the port does not have; here they are held against the port's
offline ``generate`` and against the same traffic on an engine whose
pool never runs out, and one greedy run against the JAX package's paged
engine under the same pressure.  ``GPT2Config.tiny(dropout=0.0)``, on
the CPU (``paged_attn`` runs its plain version).  Streams compare for
identity: the swap is a byte copy and the request's threefry key rides
it.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU: tests/conftest.py)
import torch

from singa_tpu import tensor as jtensor
from singa_tpu.models.gpt2 import GPT2Config as JGPT2Config
from singa_tpu.models.gpt2 import GPT2LMHead as JGPT2LMHead
from singa_tpu.serve import GenerationRequest as JRequest
from singa_tpu.serve import PagedConfig as JPagedConfig
from singa_tpu_torch import device, tensor
from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
from singa_tpu_torch.serve import (EngineFailedError, GenerationRequest,
                                   PagedConfig, PagedKVArena)
from singa_tpu_torch.serve.kvimage import KVImageError, pack_image


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


def _workload(seed, n, p_lo=3, p_hi=14, n_lo=2, n_hi=9, sampled=False):
    """``tests/test_paged.py``'s traffic generator."""
    rng = np.random.RandomState(seed)
    return [dict(prompt=rng.randint(0, 256, rng.randint(p_lo, p_hi))
                 .astype(np.int32),
                 n_new=int(rng.randint(n_lo, n_hi)),
                 temperature=(float(rng.choice([0.0, 0.9])) if sampled
                              else 0.0),
                 seed=int(rng.randint(0, 1000))) for _ in range(n)]


def _run(tm, work, max_slots, block_size=8, num_blocks=64, **kw):
    eng = tm.serve(max_slots=max_slots, paged=PagedConfig(
        block_size=block_size, num_blocks=num_blocks), **kw)
    hs = [eng.submit(GenerationRequest(
        w["prompt"], max_new_tokens=w["n_new"],
        temperature=w["temperature"], seed=w["seed"])) for w in work]
    eng.run_until_complete(max_steps=4000)
    outs = [h.result().tokens for h in hs]
    snap = eng.stats.snapshot()
    eng.check_block_accounting()
    eng.close()
    return outs, snap


def _offline(tm, work):
    return [tm.generate(w["prompt"], max_new_tokens=w["n_new"],
                        temperature=w["temperature"], seed=w["seed"])
            for w in work]


def test_preempt_resume_byte_parity(models):
    """An over-committed pool (4 slots, 10 blocks of 8) forces swaps in
    the middle of decoding; the resumed streams, greedy and sampled,
    equal offline ``generate`` and a run that never preempts, and the
    drained pool holds no block."""
    _, tm = models
    work = _workload(1, 6, n_lo=12, n_hi=30, p_lo=4, p_hi=20, sampled=True)
    assert {w["temperature"] for w in work} == {0.0, 0.9}
    roomy, snap0 = _run(tm, work, max_slots=4)
    outs, snap = _run(tm, work, max_slots=4, num_blocks=10)
    assert snap0["paged"]["preemptions"] == 0
    for a, b, c in zip(outs, roomy, _offline(tm, work)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    pg = snap["paged"]
    assert pg["preemptions"] > 0 and pg["swap_in"] > 0
    assert pg["swap_out"] == pg["swap_in"] == pg["preemptions"]
    assert pg["blocks_used"] == 0, "leaked blocks after the drain"


def test_pressured_greedy_streams_match_the_jax_paged_engine(models):
    """The same over-committed pool in both packages: the JAX engine
    preempts too, and the greedy streams are equal."""
    jm, tm = models
    work = _workload(1, 6, n_lo=12, n_hi=30, p_lo=4, p_hi=20)
    eng = jm.serve(max_slots=4,
                   paged=JPagedConfig(block_size=8, num_blocks=10))
    hs = [eng.submit(JRequest(w["prompt"], max_new_tokens=w["n_new"],
                              temperature=0.0)) for w in work]
    eng.run_until_complete(max_steps=4000)
    want = [np.asarray(h.result().tokens) for h in hs]
    assert eng.stats.snapshot()["paged"]["preemptions"] > 0
    eng.close()
    got, snap = _run(tm, work, max_slots=4, num_blocks=10)
    assert snap["paged"]["preemptions"] > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_priority_preemption_ordering(models):
    """A high-priority arrival whose blocks do not fit preempts the
    strictly-lower-priority live request instead of waiting behind it:
    the urgent request finishes first and the victim resumes
    byte-identically."""
    _, tm = models
    rng = np.random.RandomState(8)
    p_lo = rng.randint(0, 256, 10).astype(np.int32)
    p_hi = rng.randint(0, 256, 12).astype(np.int32)
    base_lo = tm.generate(p_lo, max_new_tokens=16, temperature=0.0)
    base_hi = tm.generate(p_hi, max_new_tokens=8, temperature=0.0)
    eng = tm.serve(max_slots=2, scheduler="priority",
                   paged=PagedConfig(block_size=8, num_blocks=4))
    h_lo = eng.submit(GenerationRequest(p_lo, max_new_tokens=16,
                                        temperature=0.0, priority=0))
    for _ in range(8):
        eng.step()
    h_hi = eng.submit(GenerationRequest(p_hi, max_new_tokens=8,
                                        temperature=0.0, priority=5))
    eng.run_until_complete(max_steps=2000)
    np.testing.assert_array_equal(h_lo.result().tokens, base_lo)
    np.testing.assert_array_equal(h_hi.result().tokens, base_hi)
    assert eng.stats.snapshot()["paged"]["preemptions"] >= 1
    assert h_hi.result().finished_step <= h_lo.result().finished_step
    eng.close()


def test_equal_priorities_never_preempt_each_other(models):
    """Admission waits rather than preempt an equal-priority slot, and a
    victim is the lowest priority, then the latest admitted."""
    _, tm = models
    eng = tm.serve(max_slots=3, scheduler="priority",
                   paged=PagedConfig(block_size=8, num_blocks=6))
    prompts = [np.arange(15, dtype=np.int32) + i for i in range(3)]
    hs = [eng.submit(GenerationRequest(p, max_new_tokens=2, priority=pr,
                                       temperature=0.0))
          for p, pr in zip(prompts, (1, 1, 1))]
    eng.step()
    assert eng.live_slots == 3 and eng.paged_arena.blocks_free == 0
    assert eng._alloc_blocks(1, priority=1) is None
    assert eng._pick_victim(1) is None
    assert eng.stats.snapshot()["paged"]["preemptions"] == 0
    for i, slot in enumerate(eng._slots):
        slot.admitted_step = i
    assert eng._pick_victim(2) == 2   # all at 1: the latest admitted
    eng.run_until_complete(max_steps=100)
    for h, p in zip(hs, prompts):
        np.testing.assert_array_equal(
            h.result().tokens, tm.generate(p, max_new_tokens=2,
                                           temperature=0.0))
    eng.close()


def test_block_accounting_under_churn(models):
    """Across admit / preempt / resume / retire churn, ``free + used ==
    num_blocks`` and every used block is a live slot's at every step;
    the drained engine holds none."""
    _, tm = models
    work = _workload(9, 12, n_lo=6, n_hi=24, p_lo=3, p_hi=20)
    eng = tm.serve(max_slots=4, paged=PagedConfig(block_size=8,
                                                  num_blocks=12))
    arena = eng.paged_arena
    pending = list(work)
    hs = []
    while pending or eng.pending:
        if pending:
            w = pending.pop(0)
            hs.append(eng.submit(GenerationRequest(
                w["prompt"], max_new_tokens=w["n_new"], temperature=0.0)))
        eng.step()
        assert arena.blocks_free + arena.blocks_used == arena.num_blocks
        assert arena.blocks_used == eng.check_block_accounting()
    assert all(h.done() for h in hs)
    assert arena.blocks_used == 0
    assert eng.stats.snapshot()["paged"]["preemptions"] > 0
    eng.close()


def test_fail_rejects_swapped_started_true(models):
    """An engine failure with swapped-out work: swapped requests have
    STARTED (tokens streamed), so they are rejected with
    ``started=True`` and ``live_request_ids`` holds them."""
    _, tm = models
    eng = tm.serve(max_slots=2, paged=PagedConfig(block_size=8,
                                                  num_blocks=6))
    rng = np.random.RandomState(10)
    hs = [eng.submit(GenerationRequest(
        rng.randint(0, 256, 10).astype(np.int32), max_new_tokens=20,
        temperature=0.0)) for _ in range(4)]
    steps = 0
    while not eng._swapped and steps < 60:
        eng.step()
        steps += 1
    assert eng._swapped, "pool never over-committed"
    swapped_ids = {sw.request.request_id for sw in eng._swapped}
    assert swapped_ids <= eng.live_request_ids

    def fault(*a, **k):
        raise RuntimeError("injected decode fault")

    eng._x.paged_decode_step = fault
    with pytest.raises(EngineFailedError):
        while eng.pending:
            eng.step()
    for h in hs:
        assert h.done()
        if h.request.request_id in swapped_ids:
            with pytest.raises(EngineFailedError) as ei:
                h.result()
            assert ei.value.started is True
    assert not eng._swapped
    eng.close(force=True)


def _arena(block=4, dtype=torch.float32):
    return PagedKVArena(PagedConfig(block_size=block, num_blocks=8), 2, 3, 8,
                        dtype, 32, torch.device("cpu"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_swap_round_trips_the_lanes_byte_for_byte(dtype):
    """``swap_out`` then ``swap_in`` into other blocks: the blocks'
    bytes come back exactly (bf16 included), and the counters move."""
    arena = _arena(dtype=dtype)
    src = arena.alloc(3)
    arena.pool_k.copy_(torch.randn(arena.pool_k.shape).to(dtype))
    arena.pool_v.copy_(torch.randn(arena.pool_v.shape).to(dtype))
    img = arena.swap_out(src, 2)
    assert img.n_data == 2 and img.width == 8 and img.kc.dtype == dtype
    assert not img.kc.is_cuda and img.nbytes == 2 * 2 * 3 * 8 * 8 * (
        torch.finfo(dtype).bits // 8)
    dst = arena.alloc(3)
    arena.swap_in(img, dst)
    for pool in (arena.pool_k, arena.pool_v):
        assert torch.equal(pool[:, dst[:2]], pool[:, src[:2]])
    snap = arena.snapshot()
    assert (snap["swap_out"], snap["swap_in"]) == (1, 1)
    arena.unregister()


def test_swap_in_refuses_a_mismatched_image():
    """The image is checked against the pool before any scatter: block
    size, head dim, dtype, and leaves changed after packing."""
    arena = _arena()
    blocks = arena.alloc(2)
    img = arena.swap_out(blocks, 2)
    before = arena.pool_k.clone()
    for other in (_arena(block=8), _arena(dtype=torch.bfloat16)):
        with pytest.raises(KVImageError):
            other.swap_in(img, other.alloc(2))
        other.unregister()
    narrow = pack_image(img.kc[..., :4].contiguous(),
                        img.vc[..., :4].contiguous(), 4, 2)
    with pytest.raises(KVImageError, match="head-dim"):
        arena.swap_in(narrow, blocks)
    img.kc[0, 0, 0, 0, 0] += 1.0          # mutated after packing
    with pytest.raises(KVImageError, match="corrupted"):
        arena.swap_in(img, blocks)
    img.kc = img.kc[:, :, :, :4]          # truncated
    with pytest.raises(KVImageError, match="header"):
        arena.swap_in(img, blocks)
    long = pack_image(img.vc, img.vc, 4, 3)
    with pytest.raises(KVImageError, match="n_data"):
        arena.swap_in(long, blocks)
    assert torch.equal(arena.pool_k, before)
    assert arena.snapshot()["swap_in"] == 0
    arena.unregister()
