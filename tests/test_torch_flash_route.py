"""Which flash kernels a CUDA call runs, and how ``chip_smoke.py`` finds
them in a profile; no GPU needed.

``singa_tpu_torch.ops.flash_attention.route`` is the one rule, and
returns the C entry points' ``kind``: bf16 and float16 with D <= 128 run
the forward, dQ and dK/dV on the tensor-core kernels (``fwd_wg_kernel``
and ``dkv_wg_kernel``, Hopper's wgmma warpgroups fed by TMA, and
``dq_tc_kernel`` on mma.sync, each instantiated for both types; a D
that is not a multiple of 8 through a zero-padded copy); float32, and
bf16 and float16 with 128 < D <= 1792, run the CUDA-core kernels (past
D = 512 their 8-row rung); another dtype (float64, integers) raises
``TypeError``.  The build check refuses a tensor-core kernel without
tensor-core instructions, and a ``*_wg_kernel`` without HGMMA and
UTMALDG.  The
kernels themselves are held against their plain versions on the card
(tests/test_torch_kernels_cuda.py, ``chip_smoke.py``).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import chip_smoke
from singa_tpu_torch.ops import flash_attention as tfa

CU = (pathlib.Path(__file__).resolve().parents[1] / "singa_tpu_torch" /
      "csrc" / "flash_attention.cu")


TC, BF16_CC, F32_CC = (tfa.BF16_TENSOR_CORE, tfa.BF16_CUDA_CORE,
                      tfa.F32_CUDA_CORE)
F16_TC, F16_CC = tfa.F16_TENSOR_CORE, tfa.F16_CUDA_CORE


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 1, TC),
    (torch.bfloat16, 8, TC),
    (torch.bfloat16, 64, TC),
    (torch.bfloat16, 96, TC),
    (torch.bfloat16, 128, TC),
    (torch.bfloat16, 129, BF16_CC),
    (torch.bfloat16, 160, BF16_CC),
    (torch.bfloat16, 256, BF16_CC),
    (torch.bfloat16, 257, BF16_CC),
    (torch.bfloat16, 320, BF16_CC),
    (torch.bfloat16, 512, BF16_CC),
    (torch.bfloat16, 640, BF16_CC),
    (torch.bfloat16, 1792, BF16_CC),
    (torch.float32, 8, F32_CC),
    (torch.float32, 64, F32_CC),
    (torch.float32, 128, F32_CC),
    (torch.float32, 160, F32_CC),
    (torch.float32, 256, F32_CC),
    (torch.float32, 257, F32_CC),
    (torch.float32, 512, F32_CC),
    (torch.float32, 1024, F32_CC),
    (torch.float16, 1, F16_TC),
    (torch.float16, 13, F16_TC),
    (torch.float16, 64, F16_TC),
    (torch.float16, 128, F16_TC),
    (torch.float16, 129, F16_CC),
    (torch.float16, 640, F16_CC),
    (torch.float16, 1792, F16_CC),
])
def test_route(dtype, d, want):
    assert tfa.route(dtype, d) == want


def test_route_kinds_are_the_c_dispatchs():
    """``route`` returns the ``kind`` argument of the C entry points:
    ``dispatch`` in the source must read each number the same way."""
    src = CU.read_text()
    for kind, target in ((F32_CC, "dispatch_d<float>"),
                         (BF16_CC, "dispatch_d<bf16>"),
                         (TC, "dispatch_tc<bf16>"),
                         (F16_CC, "dispatch_d<f16>"),
                         (F16_TC, "dispatch_tc<f16>")):
        assert re.search(rf"if \(kind == {kind}\) return {re.escape(target)}"
                         rf"\(which", src), (kind, target)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
@pytest.mark.parametrize("d", [1793, 2048])
def test_route_raises_past_the_widest_head(dtype, d):
    with pytest.raises(ValueError, match="head dims up to 1792"):
        tfa.route(dtype, d)


def test_every_cuda_core_rung_fits_shared_memory():
    """``dispatch_d``'s rungs cover every head dim up to ``MAX_HEAD_DIM``,
    and at each rung the forward's, dQ's and dK/dV's shared memory (the
    source's ``smem_bytes``, in floats) fits the 227 KB a block may use.
    The 8-row rung's row is the widest that fits, in whole 32-column
    lanes' shares: 32 columns more would not."""
    src = CU.read_text()
    body = src[src.index("int dispatch_d("):]
    body = body[:body.index("\n}\n")]
    rungs = [(int(d), int(br), int(dt)) for d, br, dt in re.findall(
        r"if \(a\.D <= (\d+)\) return launch<T, (\d+), (\d+)>", body)]
    assert rungs[-1][0] == tfa.MAX_HEAD_DIM
    def fits(br, dt):
        floats = (3 * br * (dt + 1) + br * (br + 1),
                  4 * br * (dt + 1) + br * (br + 1),
                  4 * br * (dt + 1) + 2 * br * (br + 1) + 2 * br)
        return max(floats) * 4 <= 232448

    for d, br, dt in rungs:
        assert d <= dt and (br % 16 == 0 or (br == 8 and dt % 32 == 0))
        assert fits(br, dt), (d, br, dt)
    assert re.search(r"return launch<T, 16, 512>", body)
    assert rungs[-1][1:] == (8, 1792) and not fits(8, 1792 + 32)
    assert not fits(16, 1024)  # why the widest rung takes 8 rows


def test_route_raises_on_other_dtypes():
    """float16 has its own kinds (above); float64 and integer types
    raise."""
    for dtype in (torch.float64, torch.int32):
        with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
            tfa.route(dtype, 64)


def _global_functions(src):
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                      r"(\w+)\s*\(", src)


def test_every_flash_kernel_lands_in_the_profiles_flash_group():
    """A kernel whose name the profile's pattern missed would count as
    "other" and hide flash time; the profiler names a kernel
    ``name<template args>(...)``."""
    names = _global_functions(CU.read_text())
    assert set(names) == {"fwd_kernel", "dq_kernel", "dkv_kernel",
                          "fwd_wg_kernel", "dq_tc_kernel", "dkv_wg_kernel",
                          "fwd_narrow_kernel", "dq_narrow_kernel",
                          "dkv_narrow_kernel"}
    pattern = dict(chip_smoke.KERNEL_GROUPS)["flash_attention"]
    for name in names:
        profiled = f"void (anonymous namespace)::{name}<64, 4>(Args)"
        group = next(g for g, rx in chip_smoke.KERNEL_GROUPS + (
            ("other", re.compile("")),) if rx.search(profiled))
        assert group == "flash_attention", name
        assert pattern.search(profiled)


def test_compare_script_needs_a_gpu(monkeypatch, capsys):
    """``tools/compare_flash_kernels.py`` times kernels only on a card:
    without one it exits 1 and prints no timing line."""
    import runpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    script = CU.parents[2] / "tools" / "compare_flash_kernels.py"
    mod = runpy.run_path(str(script), run_name="compare_flash_kernels")
    assert mod["main"]([]) == 1
    assert capsys.readouterr().out == ""


def test_cpu_calls_leave_the_tensor_core_counters():
    counters = (tfa.flash_fwd, tfa.flash_bwd_dq, tfa.flash_bwd_dkv)
    before = [c.tensor_core_launches for c in counters]
    rng = np.random.RandomState(0)
    q, k, v = (torch.tensor(rng.randn(1, 2, 32, 64).astype(np.float32))
               .bfloat16().requires_grad_(True) for _ in range(3))
    tfa.flash_attention(q, k, v, causal=True).float().sum().backward()
    assert k.grad is not None
    assert q.grad is not None
    assert [c.tensor_core_launches for c in counters] == before


def test_every_tensor_core_kernel_is_in_the_build_check():
    """``chip_smoke.TENSOR_CORE_KERNELS`` names every ``*_tc_kernel`` and
    ``*_wg_kernel`` of every source, so the build phase fails when one of
    them has lost its tensor-core (or TMA) instructions."""
    csrc = CU.parent
    for lib, names in chip_smoke.TENSOR_CORE_KERNELS.items():
        found = {n for n in _global_functions(
            (csrc / f"{lib}.cu").read_text())
            if n.endswith(("_tc_kernel", "_wg_kernel"))}
        assert found == set(names), lib
    assert set(chip_smoke.TENSOR_CORE_KERNELS) == set(chip_smoke.SOURCES)


def _report(counts):
    """A build report as ``chip_smoke.kernel_report`` gives it: ``counts``
    holds each tensor-core kernel's instructions, a number (its
    tensor-core instructions: HGMMA with as many UTMALDG for a
    ``*_wg_kernel``, HMMA for a ``*_tc_kernel``) or a dict of the
    report's own keys."""
    ns = "void (anonymous namespace)::"
    tma = "(Args, CUtensorMap, CUtensorMap, CUtensorMap)"

    def row(n, wg=False):
        if not isinstance(n, dict):
            n = dict(hgmma=n, utmaldg=n) if wg else dict(hmma=n)
        return {"registers": 128, "hmma": 0, "hgmma": 0, "utmaldg": 0, **n}

    return {
        "flash_attention": {
            f"{ns}fwd_wg_kernel<64, 2>{tma}": row(counts["fwd"], True),
            f"{ns}dq_tc_kernel<64, 4>(Args)": row(counts["dq"]),
            f"{ns}dkv_wg_kernel<64, 2>{tma[:-1]}, CUtensorMap)":
                row(counts["dkv"], True),
            f"{ns}dq_kernel<float, 64, 64>(Args)": row(0),
        },
        "resnet_bottleneck": {
            f"{ns}bottleneck_tc_kernel<64>(Params)":
                row(counts["bottleneck"]),
        },
    }


FULL = {"fwd": 64, "dq": 96, "dkv": 64, "bottleneck": 96}


def test_build_check_passes_tensor_core_kernels_with_hmma():
    tc = chip_smoke.check_tensor_cores(_report(FULL))
    # the CUDA-core dq_kernel is not held to tensor-core instructions
    assert len(tc) == 4 and not any("dq_kernel<float" in k for k in tc)


@pytest.mark.parametrize("bare", sorted(FULL))
def test_build_check_refuses_a_kernel_without_hmma(bare):
    with pytest.raises(AssertionError, match="without HMMA"):
        chip_smoke.check_tensor_cores(_report(dict(FULL, **{bare: 0})))


@pytest.mark.parametrize("kernel", ["fwd", "dkv"])
@pytest.mark.parametrize("counts", [
    dict(hmma=64), dict(hgmma=64), dict(hmma=64, utmaldg=8)],
    ids=["hmma_only", "no_tma", "hmma_and_tma"])
def test_build_check_refuses_a_hopper_kernel_without_hgmma_and_tma(
        kernel, counts):
    """A ``*_wg_kernel`` on mma.sync alone, or with its operands loaded
    by anything but TMA, is not the Hopper design."""
    with pytest.raises(AssertionError, match="without HGMMA and UTMALDG"):
        chip_smoke.check_tensor_cores(_report(dict(FULL, **{kernel: counts})))


@pytest.mark.parametrize("lib,name", [
    ("flash_attention", "dq_tc_kernel<64, 4>(Args)"),
    ("resnet_bottleneck", "bottleneck_tc_kernel<64>(Params)")])
def test_build_check_refuses_a_missing_kernel(lib, name):
    report = _report(FULL)
    del report[lib]["void (anonymous namespace)::" + name]
    with pytest.raises(AssertionError, match="no .* in the build report"):
        chip_smoke.check_tensor_cores(report)
