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
2e-5, bf16 1e-2; the cases take one split of the key range or several),
with their tolerances (``chip_smoke.TOL``): flash
attention allclose with
float32 rtol = atol = 1e-4 and bf16 rtol = atol = 2e-2 (bf16 with
D <= 128 runs the tensor-core kernels); the bottleneck
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
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
    """bf16 at D = 64 runs the forward, dQ and dK/dV on the tensor-core
    kernels; float32 runs the CUDA-core ones and leaves those counters."""
    rng = np.random.RandomState(0)
    counters = (tfa.flash_fwd, tfa.flash_bwd_dq, tfa.flash_bwd_dkv)
    for dtype, moved in ((torch.bfloat16, 1), (torch.float32, 0)):
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
    D = 640 to 1792 are edge cases above), another dtype, and malformed
    lse / delta raise."""
    q = torch.zeros(1, 8, 1800, device=cuda_device)
    with pytest.raises(ValueError, match="head dims up to 1792"):
        tfa.flash_fwd(q, q, q, None, None, None, 1.0, False, None)
    h = torch.zeros(1, 8, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed,name,case", [
    pytest.param(seed, name, case, id=name)
    for seed, (name, case) in enumerate(chip_smoke.paged_edge_cases())])
def test_paged_kernel_matches_plain(cuda_device, dtype, seed, name, case):
    chip_smoke.check_paged_case(f"{name}/{dtype}", getattr(torch, dtype),
                                seed, **case)


@pytest.mark.cuda
def test_paged_kernel_counts_its_launches_and_refuses_int8(cuda_device):
    """One count a launch (the split and combine kernels together); int8
    pools, D past 1024 and more than 4 query positions past D = 128
    raise; D = 96, 512 and 1024 run and agree with the plain version, and
    a GQA group of 5 heads at D = 256 runs as two launches."""
    args = chip_smoke.paged_inputs(lens=[9, 0], block=8, d=64, n_kv=2, g=1,
                                   nq=1, dtype=torch.float32, seed=0)
    before = tpa.paged_attn.launches
    tpa.paged_attn(**args)
    torch.cuda.synchronize()
    assert tpa.paged_attn.launches == before + 1
    int8 = dict(args, pool_k=args["pool_k"].to(torch.int8),
                pool_v=args["pool_v"].to(torch.int8))
    with pytest.raises(TypeError, match="int8"):
        tpa.paged_attn(**int8)
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
    for d, nq in ((1040, 1), (256, 5)):
        bad = chip_smoke.paged_inputs(lens=[9], block=8, d=d, n_kv=1, g=1,
                                      nq=nq, dtype=torch.float32, seed=0)
        with pytest.raises(ValueError, match="head dims|positions"):
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
