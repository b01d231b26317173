"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without a GPU (the kernels
have no CPU mode).  On a machine with one:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q

This file imports only torch, numpy, the port and ``chip_smoke.py``
(run from the repo root), so it runs where JAX is not installed.  The
kernel-vs-plain comparisons are ``chip_smoke.check_case`` over
``chip_smoke.edge_cases()`` (flash attention) and
``chip_smoke.check_bottleneck_case`` over
``chip_smoke.bottleneck_edge_cases()`` (the ResNet bottleneck), with
``chip_smoke.check_paged_case`` over ``chip_smoke.paged_edge_cases()``
(paged decode attention, allclose at ``chip_smoke.PAGED_TOL``: float32
2e-5, bf16 1e-2, float16 2e-3, by q's dtype on int8 pools too; the
cases take one split of the key range or several; fork groups' tables,
several slots naming the same blocks, and a ship destination's tables
among them), the device threefry draw against the host chain
(``chip_smoke.threefry_check``),
with their tolerances (``chip_smoke.TOL``): flash
attention allclose with
float32 rtol = atol = 1e-4, bf16 rtol = atol = 2e-2 and float16 rtol =
atol = 1e-2 (bf16 and float16 with D <= 128 run the tensor-core
kernels); the bottleneck
per element (``chip_smoke.bottleneck_stats``: within 1 bf16 ulp +
2^-7 rms, at most 0.2% of elements differing at all).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from singa_tpu_torch.ops import bottleneck as tbk
from singa_tpu_torch.ops import flash_attention as tfa
from singa_tpu_torch.ops import paged_attention as tpa

B, H = 2, 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the port's kernels run only there")
    return torch.device("cuda")


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("name,case", [
    pytest.param(name, case, id=name)
    for name, case in chip_smoke.edge_cases()])
def test_kernels_match_plain(cuda_device, dtype, name, case):
    chip_smoke.check_case(f"{name}/{dtype}", dtype=getattr(torch, dtype),
                          seed=0, **case)


@pytest.mark.cuda
def test_cuda_tensors_launch_each_kernel_once(cuda_device):
    rng = np.random.RandomState(0)
    q, k, v = (torch.tensor(_rand(rng, B, H, 64, 64), device=cuda_device,
                            requires_grad=True) for _ in range(3))
    before = (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
              tfa.flash_bwd_dkv.launches)
    tfa.flash_attention(q, k, v, causal=True).sum().backward()
    torch.cuda.synchronize()
    after = (tfa.flash_fwd.launches, tfa.flash_bwd_dq.launches,
             tfa.flash_bwd_dkv.launches)
    assert after == tuple(n + 1 for n in before)


@pytest.mark.cuda
def test_bf16_calls_take_the_tensor_core_route(cuda_device):
    """bf16 and float16 at D = 64 run the forward, dQ and dK/dV on the
    tensor-core kernels; float32 runs the CUDA-core ones and leaves those
    counters."""
    rng = np.random.RandomState(0)
    counters = (tfa.flash_fwd, tfa.flash_bwd_dq, tfa.flash_bwd_dkv)
    for dtype, moved in ((torch.bfloat16, 1), (torch.float16, 1),
                         (torch.float32, 0)):
        q, k, v = (torch.tensor(_rand(rng, B, H, 64, 64), device=cuda_device)
                   .to(dtype).requires_grad_(True) for _ in range(3))
        before = [c.tensor_core_launches for c in counters]
        tfa.flash_attention(q, k, v, causal=True).float().sum().backward()
        torch.cuda.synchronize()
        assert [c.tensor_core_launches - b
                for c, b in zip(counters, before)] == [moved] * 3


@pytest.mark.cuda
def test_unsupported_inputs_raise(cuda_device):
    """Past D = 1792 (the CUDA-core kernels' widest rung, 8 rows a tile;
    D = 640 to 1792 are edge cases above), another dtype (float64:
    float16 runs, in the kernel-vs-plain cases above), and malformed
    lse / delta raise."""
    q = torch.zeros(1, 8, 1800, device=cuda_device)
    with pytest.raises(ValueError, match="head dims up to 1792"):
        tfa.flash_fwd(q, q, q, None, None, None, 1.0, False, None)
    h = torch.zeros(1, 8, 64, device=cuda_device, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        tfa.flash_fwd(h, h, h, None, None, None, 1.0, False, None)
    # lse and delta are read as raw float arrays: wrong dtype, layout or
    # contiguity raises instead of reading out of bounds
    x = torch.zeros(2, 8, 64, device=cuda_device)
    rows = torch.zeros(2, 8, device=cuda_device)
    strided = torch.zeros(8, 2, device=cuda_device).t()
    bad = [rows.bfloat16(), rows[:, None, :], strided]
    cfg = (None, None, None, 1.0, False, None)
    for wrong in bad:
        for fn in (tfa.flash_bwd_dq, tfa.flash_bwd_dkv):
            with pytest.raises(ValueError, match="lse"):
                fn(x, x, x, *cfg, x, wrong, rows)
            with pytest.raises(ValueError, match="delta"):
                fn(x, x, x, *cfg, x, rows, wrong)


@pytest.mark.cuda
def test_tiny_gpt2_trains_through_the_kernels(cuda_device):
    from singa_tpu_torch import device, opt, tensor
    from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead

    dev = device.create_cuda_gpu()
    dev.SetRandSeed(0)
    ids = np.random.RandomState(1).randint(0, 256, (2, 64)).astype(np.int32)
    x = tensor.from_numpy(ids, dev)
    y = tensor.from_numpy(np.roll(ids, -1, axis=1).astype(np.int32), dev)
    m = GPT2LMHead(GPT2Config.tiny(dropout=0.0, attn_impl="flash"))
    m.set_optimizer(opt.SGD(lr=0.1, momentum=0.9))
    m.compile([x], is_train=True)
    before = tfa.flash_fwd.launches
    losses = [m(x, y)[1].item() for _ in range(3)]
    assert tfa.flash_fwd.launches - before == 3 * m.cfg.n_layer
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


#: the edge cases that take the tensor-core route in bf16 (D <= 128):
#: S = 1, 65, 129, 1000; D = 8, 13 (padded to 16), 72, 96, 128; windows
#: of 1 and 130 keys; the four general-mask shapes; the dead row
TENSOR_CORE_CASES = [(name, case) for name, case in chip_smoke.edge_cases()
                     if case["d"] <= tfa.TENSOR_CORE_MAX_HEAD_DIM]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("name,case", [
    pytest.param(name, case, id=name) for name, case in TENSOR_CORE_CASES])
def test_bf16_edge_cases_run_the_hopper_kernels(cuda_device, dtype, name,
                                                case):
    """Every bf16 and float16 edge case with D <= 128 matches the plain
    versions at ``chip_smoke.TOL`` through one launch each of the
    tensor-core route: ``fwd_wg_kernel``, ``dq_tc_kernel``,
    ``dkv_wg_kernel``."""
    counters = (tfa.flash_fwd, tfa.flash_bwd_dq, tfa.flash_bwd_dkv)
    before = [c.tensor_core_launches for c in counters]
    chip_smoke.check_case(f"{name}/{dtype}", dtype=getattr(torch, dtype),
                          seed=0, **case)
    assert [c.tensor_core_launches - b
            for c, b in zip(counters, before)] == [1, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "ragged"])
def test_bert_shape_matches_plain(cuda_device, dtype, masked):
    """BERT-base's attention (16 x 12 x 512 x 64, non-causal) matches the
    plain versions at ``chip_smoke.TOL`` on the tensor-core route: with
    no mask, as a training step runs it, and under a ragged key-padding
    mask, as an ``attention_mask`` gives it."""
    sh = chip_smoke.BERT_SHAPE
    mask = chip_smoke.bert_key_mask(sh["b"], sh["s"]) if masked else None
    counters = (tfa.flash_fwd, tfa.flash_bwd_dq, tfa.flash_bwd_dkv)
    before = [c.tensor_core_launches for c in counters]
    chip_smoke.check_case(f"bert_base/{dtype}", dtype=getattr(torch, dtype),
                          seed=1, mask=mask, **sh)
    assert [c.tensor_core_launches - b
            for c, b in zip(counters, before)] == [1, 1, 1]


def _flash_inputs(b, h, s, d, seed):
    (q, k, v), cfg, do, dlse = chip_smoke._case_inputs(
        b, h, s, d, torch.bfloat16, seed, causal=True)
    return q, k, v, cfg, do, dlse


def _flash_step(q, k, v, cfg, do, dlse):
    o, lse = tfa.flash_fwd(q, k, v, *cfg)
    delta = ((do.float() * o.float()).sum(-1) - dlse).contiguous()
    args = (q, k, v, *cfg, do, lse, delta)
    return (o, lse, tfa.flash_bwd_dq(*args), *tfa.flash_bwd_dkv(*args))


@pytest.mark.cuda
def test_dkv_is_bitwise_deterministic(cuda_device):
    """dK/dV walks its query tiles inside the block that owns the keys
    (no atomics): two launches on the same inputs agree to the bit."""
    q, k, v, cfg, do, dlse = _flash_inputs(2, 3, 1000, 64, 0)
    o, lse = tfa.flash_fwd(q, k, v, *cfg)
    delta = ((do.float() * o.float()).sum(-1) - dlse).contiguous()
    args = (q, k, v, *cfg, do, lse, delta)
    first = tfa.flash_bwd_dkv(*args)
    second = tfa.flash_bwd_dkv(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 13, 128])
def test_flash_captured_in_a_graph_equals_eager(cuda_device, d):
    """The forward and backward captured in one CUDA graph, replayed
    after the inputs change in place, equal the eager calls on the new
    inputs bit for bit: the tensor maps that the Hopper kernels take by
    value are captured with their launches (D = 13: the padded copies
    inside the capture too)."""
    q, k, v, cfg, do, dlse = _flash_inputs(2, 3, 200, d, 0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _flash_step(q, k, v, cfg, do, dlse)  # eager first: smem limits set
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = _flash_step(q, k, v, cfg, do, dlse)
    q2, k2, v2, _, do2, dlse2 = _flash_inputs(2, 3, 200, d, 1)
    for dst, src in ((q, q2), (k, k2), (v, v2), (do, do2), (dlse, dlse2)):
        dst.copy_(src)
    graph.replay()
    eager = _flash_step(q, k, v, cfg, do, dlse)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(captured, eager))


@pytest.mark.cuda
@pytest.mark.parametrize("name,case", [
    pytest.param(name, case, id=name)
    for name, case in chip_smoke.bottleneck_edge_cases()])
def test_bottleneck_matches_plain(cuda_device, name, case):
    chip_smoke.check_bottleneck_case(name, seed=0, **case)


@pytest.mark.cuda
def test_bottleneck_counts_one_launch_per_call(cuda_device):
    args = chip_smoke.bottleneck_inputs(1, 7, 7, 64, 16, seed=0)
    before = tbk.megakernel_block.launches
    tbk.megakernel_block(*args)
    tbk.megakernel_block(*args)
    torch.cuda.synchronize()
    assert tbk.megakernel_block.launches == before + 2


@pytest.mark.cuda
def test_bottleneck_unsupported_inputs_raise(cuda_device):
    args = list(chip_smoke.bottleneck_inputs(1, 7, 7, 64, 16, seed=0))
    with pytest.raises(TypeError, match="x must be"):
        tbk.megakernel_block(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        tbk.megakernel_block(args[0].transpose(1, 2), *args[1:])
    # CM = 12 is not a multiple of 8; CM = 136 is over MAX_CM
    for cm in (12, 136):
        bad = chip_smoke.bottleneck_inputs(1, 7, 7, 64, cm, seed=0)
        with pytest.raises(ValueError, match="multiples of 8"):
            tbk.megakernel_block(*bad)
    # 512-wide rows at CM = 128 need more than 227 KB of shared memory
    wide = chip_smoke.bottleneck_inputs(1, 2, 512, 64, 128, seed=0)
    with pytest.raises(ValueError, match="shared memory"):
        tbk.megakernel_block(*wide)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("seed,name,case", [
    pytest.param(seed, name, case, id=name)
    for seed, (name, case) in enumerate(chip_smoke.paged_edge_cases())])
def test_paged_kernel_matches_plain(cuda_device, dtype, seed, name, case):
    chip_smoke.check_paged_case(f"{name}/{dtype}", getattr(torch, dtype),
                                seed, **case)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("seed,name,case", [
    pytest.param(seed, name, case, id=name)
    for seed, (name, case) in enumerate(chip_smoke.paged_edge_cases())])
def test_paged_int8_kernel_matches_plain(cuda_device, dtype, seed, name,
                                         case):
    """int8 pools ((values, scales) pairs) with float32, bf16 or
    float16 q."""
    chip_smoke.check_paged_case(f"{name}/int8/{dtype}",
                                getattr(torch, dtype), seed, quant=True,
                                **case)


@pytest.mark.cuda
@pytest.mark.parametrize("quant,dtype", [(False, "float32"),
                                         (False, "bfloat16"),
                                         (True, "bfloat16")])
@pytest.mark.parametrize("seed,name,case", [
    pytest.param(seed, name, case, id=name) for seed, (name, case)
    in enumerate(chip_smoke.paged_serving_cases(), start=100)])
def test_paged_kernel_at_serving_shapes(cuda_device, quant, dtype, seed,
                                        name, case):
    """The speculative verify step's (Q = 4) and the windowed steps'
    shapes (tables of dropped blocks, read from entry 0), on float32,
    bf16 and int8 pools."""
    chip_smoke.check_paged_case(f"{name}/{dtype}", getattr(torch, dtype),
                                seed, quant=quant, **case)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", ["fork_shared_blocks", "fork_q1"])
def test_paged_kernel_at_fork_tables(cuda_device, quant, name):
    """Fork groups' tables, several slots naming the same prompt blocks
    (the edge case and the ``fork`` phase's step shape), on bf16 pools
    and on int8 pools with bf16 q."""
    cases = dict(chip_smoke.paged_edge_cases()
                 + chip_smoke.paged_serving_cases())
    case = cases[name]
    tables = chip_smoke.paged_inputs(dtype=torch.bfloat16, seed=7,
                                     **case)["tables"].cpu().numpy()
    named = tables[:, :min(n for _, n in case["share"])]
    assert max((named == b).any(1).sum() for b in np.unique(named)) >= 2
    chip_smoke.check_paged_case(f"{name}/bf16", torch.bfloat16, 7,
                                quant=quant, **case)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_kernel_at_a_ship_destination(cuda_device, quant):
    """A decode replica's tables after KV ships (row 5d's shape): long
    slots on blocks a shipped image landed in, two naming one shipped
    prefix, on bf16 pools and on int8 pools with bf16 q."""
    case = dict(chip_smoke.paged_serving_cases())["ship_q1"]
    chip_smoke.check_paged_case("ship_q1/bf16", torch.bfloat16, 11,
                                quant=quant, **case)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,vocab", [(8, 50257), (3, 257)])
def test_threefry_draw_matches_the_host_chain(cuda_device, rows, vocab):
    """The device draw (``ops/prng.py``'s torch threefry): bits and
    uniforms of one key a row equal the numpy chain's bit for bit, the
    Gumbels within ``chip_smoke.GUMBEL_TOL``, and the known answers
    taken from ``jax.random``."""
    got = chip_smoke.threefry_check(cuda_device, rows=rows, vocab=vocab,
                                    seed=rows)
    assert got["bits_equal"] and got["uniforms_equal"]
    assert got["known_answers_equal"]


@pytest.mark.cuda
def test_paged_kernel_counts_chunk_and_window_launches(cuda_device):
    """A launch at Q > 1 counts in ``chunk_launches`` too, one with a
    window in ``window_launches``."""
    counts = ("launches", "chunk_launches", "window_launches")
    for name, case in chip_smoke.paged_serving_cases():
        before = [getattr(tpa.paged_attn, c) for c in counts]
        tpa.paged_attn(**chip_smoke.paged_inputs(dtype=torch.bfloat16,
                                                 seed=0, **case))
        torch.cuda.synchronize()
        got = [getattr(tpa.paged_attn, c) - b
               for c, b in zip(counts, before)]
        assert got == [1, int(case["nq"] > 1),
                       int(case.get("window") is not None)], (name, got)


@pytest.mark.cuda
def test_paged_kernel_counts_its_launches(cuda_device):
    """One count a launch (the split and combine kernels together), and
    on int8 pools one in ``int8_launches`` too; D past 1024 raises;
    D = 96, 512 and 1024 run and agree with
    the plain version, a GQA group of 5 heads at D = 256 runs as two
    launches, and more query positions than one launch holds run as runs
    of them: Q = 24 at D = 64 in two launches, Q = 5 at D = 256 in two,
    and ``max_positions(64)`` (3632) in 227, whose combine fills the
    227 KB of shared memory; one position more raises."""
    args = chip_smoke.paged_inputs(lens=[9, 0], block=8, d=64, n_kv=2, g=1,
                                   nq=1, dtype=torch.float32, seed=0)
    before = tpa.paged_attn.launches
    before8 = tpa.paged_attn.int8_launches
    tpa.paged_attn(**args)
    torch.cuda.synchronize()
    assert tpa.paged_attn.launches == before + 1
    assert tpa.paged_attn.int8_launches == before8
    int8 = chip_smoke.paged_inputs(lens=[9, 0], block=8, d=64, n_kv=2, g=1,
                                   nq=1, dtype=torch.bfloat16, seed=0,
                                   quant=True)
    out = tpa.paged_attn(**int8)
    assert out.dtype == torch.bfloat16
    assert tpa.paged_attn.launches == before + 2
    assert tpa.paged_attn.int8_launches == before8 + 1
    for d in (96, 512, 1024):
        ok = chip_smoke.paged_inputs(lens=[9, 300], block=8, d=d, n_kv=1,
                                     g=1, nq=1, dtype=torch.float32, seed=0)
        torch.testing.assert_close(tpa.paged_attn(**ok),
                                   tpa.paged_attn_plain(**ok),
                                   rtol=2e-5, atol=2e-5)
    five = chip_smoke.paged_inputs(lens=[9, 40], block=8, d=256, n_kv=1,
                                   g=5, nq=1, dtype=torch.float32, seed=1)
    before = tpa.paged_attn.launches
    torch.testing.assert_close(tpa.paged_attn(**five),
                               tpa.paged_attn_plain(**five),
                               rtol=2e-5, atol=2e-5)
    assert tpa.paged_attn.launches == before + 2
    for d, nq in ((64, 24), (256, 5)):
        many = chip_smoke.paged_inputs(lens=[9, 40], block=8, d=d, n_kv=2,
                                       g=1, nq=nq, dtype=torch.float32,
                                       seed=2)
        before = tpa.paged_attn.launches
        torch.testing.assert_close(tpa.paged_attn(**many),
                                   tpa.paged_attn_plain(**many),
                                   rtol=2e-5, atol=2e-5)
        assert tpa.paged_attn.launches == before + 2
    most = tpa.max_positions(64)
    full = chip_smoke.paged_inputs(lens=[9, 40], block=8, d=64, n_kv=1, g=1,
                                   nq=most, dtype=torch.float32, seed=3)
    before = tpa.paged_attn.launches
    torch.testing.assert_close(tpa.paged_attn(**full),
                               tpa.paged_attn_plain(**full),
                               rtol=2e-5, atol=2e-5)
    assert tpa.paged_attn.launches == before + -(-most // tpa.max_rows(64))
    over = chip_smoke.paged_inputs(lens=[9], block=8, d=64, n_kv=1, g=1,
                                   nq=most + 1, dtype=torch.float32, seed=0)
    with pytest.raises(ValueError, match="query positions"):
        tpa.paged_attn(**over)
    bad = chip_smoke.paged_inputs(lens=[9], block=8, d=1040, n_kv=1, g=1,
                                  nq=1, dtype=torch.float32, seed=0)
    with pytest.raises(ValueError, match="head dims"):
        tpa.paged_attn(**bad)


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [True, False], ids=["d64", "d16"])
def test_tiny_gpt2_serves_through_the_paged_kernel(cuda_device, wide):
    """Engine streams equal offline generate on the card, float32, and the
    kernel launches once a layer a decode step; at D = 64 and at
    ``GPT2Config.tiny``'s own D = 16."""
    from singa_tpu_torch import device, tensor
    from singa_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHead
    from singa_tpu_torch.serve import GenerationRequest, PagedConfig

    dev = device.create_cuda_gpu()
    dev.SetRandSeed(0)
    m = GPT2LMHead(GPT2Config.tiny(dropout=0.0, n_embd=128, n_head=2)
                   if wide else GPT2Config.tiny(dropout=0.0))
    m.compile([tensor.from_numpy(np.zeros((1, 8), np.int32), dev)],
              is_train=False)
    rng = np.random.RandomState(2)
    work = [(rng.randint(0, 256, rng.randint(3, 40)).astype(np.int32),
             int(rng.randint(2, 20)), float(t), int(rng.randint(0, 999)))
            for t in (0.0, 0.9, 0.0, 0.9, 0.0)]
    eng = m.serve(max_slots=2, paged=PagedConfig(block_size=8,
                                                 num_blocks=32))
    before = tpa.paged_attn.launches
    hs = [eng.submit(GenerationRequest(p, max_new_tokens=n, temperature=t,
                                       seed=s)) for p, n, t, s in work]
    eng.run_until_complete(max_steps=500)
    steps = eng.stats.decode_steps
    assert tpa.paged_attn.launches - before == 2 * steps
    for h, (p, n, t, s) in zip(hs, work):
        want = m.generate(p, max_new_tokens=n, temperature=t, seed=s)
        np.testing.assert_array_equal(h.result().tokens, want)
    assert eng.paged_arena.blocks_used == 0
    eng.close()


def _zoo_on_card(module, factory, kwargs, shape, classes, seed=0):
    """A zoo model's maker and a batch on the card (float32, amp off)."""
    from singa_tpu_torch import device

    dev = device.create_cuda_gpu()
    x, y = chip_smoke.zoo_batch(shape, classes, seed, dev)
    return (chip_smoke.zoo_maker(module, factory, kwargs, x, dev, seed),
            x, y, dev)


@pytest.mark.cuda
def test_zoo_model_captured_steps_equal_eager(cuda_device):
    """MobileNetV2 (width 0.25, depthwise convs, batch norm, dropout) on
    the card: four graph-mode steps (eager, captured, two replays) equal
    four eager steps from the same state and generator seed, losses and
    weights within rtol 1e-5.  Deterministic algorithms run
    (``chip_smoke.deterministic``, cuDNN's among them): cuDNN left
    to its own choice in float32 at this size, the two runs differed by
    7e-5 of the loss after one step and 1% after three, which batch norm
    at batch 32 grows from a sum taken in another order."""
    build, x, y, dev = _zoo_on_card("mobilenet", "mobilenet_v2",
                                    dict(num_classes=10, width_mult=0.25),
                                    (3, 64, 64), 10)
    with chip_smoke.deterministic():
        graph = build(True)
        eager = build(False)
        eager.set_states({k: v.detach().clone()
                          for k, v in graph.get_states().items()})
        losses = {}
        for name, m in (("eager", eager), ("graph", graph)):
            dev.SetRandSeed(1)
            losses[name] = [m(x, y)[1].item() for _ in range(4)]
    np.testing.assert_allclose(losses["graph"], losses["eager"], rtol=1e-5)
    for k, v in graph.get_states().items():
        torch.testing.assert_close(v, eager.get_states()[k], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.cuda
def test_checkpoint_round_trip_on_the_card(cuda_device, tmp_path):
    """``chip_smoke.checkpoint_check`` on a small VGG-11 with batch norm:
    the step after a reload, and after an ``async_save`` taken between
    replays, equals the uninterrupted step bit for bit; and the
    ``ExponentialDecay`` rate read off replayed steps follows its
    formula."""
    build, x, y, dev = _zoo_on_card("vgg", "vgg11",
                                    dict(num_classes=10, hidden=64,
                                         batch_norm=True), (3, 32, 32), 10)
    rep = chip_smoke.checkpoint_check(build, x, y, dev,
                                      str(tmp_path / "vgg11.zip"))
    assert rep["reload_step_bitwise_equal"]
    assert rep["async_save_step_bitwise_equal"]
    chip_smoke.schedule_probe(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_onnx_export_runs_the_flash_forward(cuda_device, dtype):
    """A tiny BERT with ``use_flash=True`` exported on the card: the flash
    forward kernel launches inside the export's record (float32: the
    CUDA-core kernel, whatever the amp dtype, since the export computes
    in float32), and the imported graph's outputs equal the native
    model's flash forward (float32 atol 1e-4; under bf16 amp 2^-5,
    ``chip_smoke.BERT_LOGITS_ATOL``)."""
    from singa_tpu_torch import amp, device, sonnx, tensor
    from singa_tpu_torch.models.bert import BertConfig, BertModel

    dev = device.create_cuda_gpu()
    dev.SetRandSeed(0)
    m = BertModel(BertConfig.tiny(use_flash=True, hidden_dropout=0.0,
                                  attn_dropout=0.0))
    ids = np.random.RandomState(0).randint(0, 1000, (2, 64))
    x = tensor.from_numpy(ids.astype(np.int32), dev)
    m.compile([x], is_train=False)
    limit = 1e-4 if dtype == "float32" else 2.0 ** -5
    amp.enable(dtype == "bfloat16")
    try:
        tfa.flash_fwd.launches = tfa.flash_fwd.tensor_core_launches = 0
        proto = sonnx.to_onnx(m, [x])
        assert tfa.flash_fwd.launches == m.cfg.num_hidden_layers
        assert tfa.flash_fwd.tensor_core_launches == 0
        rep = sonnx.prepare(proto.serialize(), dev)
        with torch.no_grad():
            want = m(x)
            got = rep.run([x])
        for g, w in zip(got, want):
            assert g.is_cuda and torch.isfinite(g).all()
            assert (g.float() - w.float()).abs().max().item() <= limit
    finally:
        amp.enable(False)
