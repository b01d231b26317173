"""The port's CUDA kernel sources run on the CPU through
``tools/cuda_emulator`` (``tools/emulate_kernels.py``), against their
plain PyTorch versions at ``chip_smoke.TOL``.

The emulator runs each CUDA thread as a fiber, with the warp-level PTX
the kernels use (``ldmatrix``, ``mma.sync``, ``cp.async`` landing at
``wait_group``), Hopper's mbarriers, TMA tiled loads (128-byte swizzle,
zero fill) and warpgroup ``wgmma`` (operands read at ``wait_group``),
and shared memory that starts as garbage.  So these tests
catch indexing, masking, tiling and synchronisation faults in the
kernels without a card.  It sums each ``mma`` exactly, so the card's own
rounding is held on the card (tests/test_torch_kernels_cuda.py,
``chip_smoke.py``).  Cases: small ``chip_smoke`` edge cases, bf16 for
flash attention (the tensor-core route: ``fwd_wg_kernel``,
``dq_tc_kernel``, ``dkv_wg_kernel``, D = 13 padded as the wrapper pads
it; the CUDA-core kernels at D = 512
and their 8-row rung at D = 640 and 1024, there in float32 too), and
float16 for four flash cases (the Hopper kernels' float16
instantiations, and the CUDA-core rung at D = 160) and two paged cases
(float16 pools, and int8 pools with float16 q), the
ragged and narrow ones for the bottleneck; for paged attention, the
split and combine kernels in float32 and bf16 at ``chip_smoke.PAGED_TOL``,
launched as the wrapper launches them (the table width as the bound of
the blocks read, which the kernel narrows from the positions on the
device; launches of at most ``max_rows(D)`` query rows), on eight cases
at the split count the wrapper would choose (dead slots with all-trash
tables, GQA g = 3 with Q = 4 at D = 128, a window over Q = 4, D = 640,
D = 1024 with 6 heads, 32 query rows at D = 64, Q = 24 positions of 2
heads under a window in runs of 16, fork groups whose slots' tables
name the same blocks) and on D = 16 and a long
slot beside short ones at D = 64 over one split and over three, each
also on int8 pools ((values, scales) pairs) with float32 and bf16 q at
the q dtype's tolerance; the split plan itself, int8 pools
included; and a swizzled TMA tile read back through the wgmma
descriptors.  Needs a C++ compiler.
"""

import importlib.util
import pathlib
import shutil

import numpy as np
import pytest
import torch

import chip_smoke

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLASH = ("s65_causal", "s129_causal", "d13_s100", "window1", "neg_inf_row",
         "general_mask_mBH", "d512_window", "d640_window",
         "d1024_general_mask")
#: float16: the Hopper kernels past a tile's edge, with D padded, under a
#: general mask, and the CUDA-core rung at D = 160
FLASH_F16 = ("s65_causal", "d13_s100", "general_mask_mBH", "d160_window")
BOTTLENECK = ("hw7_bands_ragged", "c128_cm32", "odd_h5_w9_cm8")
PAGED = ("dead_slots_all_trash", "g3_q4_d128", "window_q4_g3", "d640",
         "d1024_g6", "g8_q4_32_rows", "q24_g2_window", "fork_shared_blocks")


@pytest.fixture(scope="module")
def emu():
    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("needs a C++ compiler to build the emulated kernels")
    spec = importlib.util.spec_from_file_location(
        "emulate_kernels", ROOT / "tools" / "emulate_kernels.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def build_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("emulated_kernels"))


@pytest.fixture
def cpu_inputs(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", torch.device("cpu"))


@pytest.mark.parametrize("name", FLASH)
def test_flash_kernels_match_plain(emu, build_dir, cpu_inputs, name):
    seed, kw = next((i, kw) for i, (n, kw)
                    in enumerate(chip_smoke.edge_cases()) if n == name)
    lib = emu.load("flash_attention", build_dir)
    res = emu.flash_case(lib, dtype=torch.bfloat16, seed=seed, **kw)
    assert all(ok for _, ok in res.values()), res


@pytest.mark.parametrize("name", ["d640_window", "d1024_general_mask"])
def test_flash_narrow_rung_matches_plain_in_float32(emu, build_dir,
                                                    cpu_inputs, name):
    seed, kw = next((i, kw) for i, (n, kw)
                    in enumerate(chip_smoke.edge_cases()) if n == name)
    lib = emu.load("flash_attention", build_dir)
    res = emu.flash_case(lib, dtype=torch.float32, seed=seed, **kw)
    assert all(ok for _, ok in res.values()), res


@pytest.mark.parametrize("name", FLASH_F16)
def test_flash_kernels_match_plain_in_float16(emu, build_dir, cpu_inputs,
                                              name):
    """The float16 instantiations of the Hopper forward, dQ and dK/dV
    (``f16`` operands of mma.sync and wgmma, float16 tensor maps), and
    of the CUDA-core kernels past D = 128, at ``chip_smoke.TOL``'s
    float16 tolerance."""
    seed, kw = next((i, kw) for i, (n, kw)
                    in enumerate(chip_smoke.edge_cases()) if n == name)
    lib = emu.load("flash_attention", build_dir)
    res = emu.flash_case(lib, dtype=torch.float16, seed=seed, **kw)
    assert all(ok for _, ok in res.values()), res


@pytest.mark.parametrize("quant", [False, True],
                         ids=["float16_pools", "int8_pools_float16_q"])
@pytest.mark.parametrize("name", ["g3_q4_d128", "long_beside_short"])
def test_paged_kernels_match_plain_in_float16(emu, build_dir, cpu_inputs,
                                              name, quant):
    seed, kw = next((i, kw) for i, (n, kw)
                    in enumerate(chip_smoke.paged_edge_cases())
                    if n == name)
    lib = emu.load("paged_attention", build_dir)
    err, ok = emu.paged_case(lib, torch.float16, seed, quant=quant, **kw)
    assert ok, err


@pytest.mark.parametrize("name", BOTTLENECK)
def test_bottleneck_kernel_matches_plain(emu, build_dir, cpu_inputs, name):
    seed, kw = next((i, kw) for i, (n, kw)
                    in enumerate(chip_smoke.bottleneck_edge_cases())
                    if n == name)
    lib = emu.load("resnet_bottleneck", build_dir)
    stats = emu.bottleneck_case(lib, seed=seed, **kw)
    assert stats["ok"], stats


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("name", PAGED)
def test_paged_kernel_matches_plain(emu, build_dir, cpu_inputs, name, dtype):
    seed, kw = next((i, kw) for i, (n, kw)
                    in enumerate(chip_smoke.paged_edge_cases())
                    if n == name)
    lib = emu.load("paged_attention", build_dir)
    err, ok = emu.paged_case(lib, dtype, seed, **kw)
    assert ok, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("n_split", [1, 3])
@pytest.mark.parametrize("name", ["d16", "long_beside_short"])
def test_paged_split_and_combine_kernels(emu, build_dir, cpu_inputs, name,
                                         n_split, dtype):
    seed, kw = next((i, kw) for i, (n, kw)
                    in enumerate(chip_smoke.paged_edge_cases())
                    if n == name)
    lib = emu.load("paged_attention", build_dir)
    err, ok = emu.paged_case(lib, dtype, seed, n_split, **kw)
    assert ok, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32_q", "bf16_q"])
@pytest.mark.parametrize("name", PAGED)
def test_paged_int8_kernel_matches_plain(emu, build_dir, cpu_inputs, name,
                                         dtype):
    """The int8 instantiations (int8 pools, q float32 or bf16)."""
    seed, kw = next((i, kw) for i, (n, kw)
                    in enumerate(chip_smoke.paged_edge_cases())
                    if n == name)
    lib = emu.load("paged_attention", build_dir)
    err, ok = emu.paged_case(lib, dtype, seed, quant=True, **kw)
    assert ok, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32_q", "bf16_q"])
@pytest.mark.parametrize("n_split", [1, 3])
@pytest.mark.parametrize("name", ["d16", "long_beside_short"])
def test_paged_int8_split_and_combine_kernels(emu, build_dir, cpu_inputs,
                                              name, n_split, dtype):
    """D = 16 (one 16-byte chunk an int8 row) and a long slot beside
    short ones on int8 pools, over one split and over three."""
    seed, kw = next((i, kw) for i, (n, kw)
                    in enumerate(chip_smoke.paged_edge_cases())
                    if n == name)
    lib = emu.load("paged_attention", build_dir)
    err, ok = emu.paged_case(lib, dtype, seed, n_split, quant=True, **kw)
    assert ok, err


def test_paged_split_plan(emu, build_dir):
    """The C plan on an H100's 132 SMs: about 4 blocks an SM, at least
    128 keys a split, whole tiles a warp; none past D = 1024.  The serve
    step plans from its table width (32 blocks of 32)."""
    from singa_tpu_torch.ops import paged_attention as pa

    lib = emu.load("paged_attention", build_dir)

    def plan(n_blk, block, pairs, d=64, dtype=torch.bfloat16, blk_lo=0):
        return pa.split_count(d, dtype, n_blk, blk_lo, block, pairs, 132,
                              lib)

    assert plan(16, 32, 8 * 12) == 4      # a serve step: 8 slots, 512 keys
    assert plan(32, 32, 8 * 12) == 4      # ... planned from the table width
    assert plan(32, 32, 2 * 12) == 8      # two 1000-lane slots
    assert plan(4, 32, 2) == 1            # 128 keys: one split
    assert plan(32, 32, 600) == 1         # enough pairs to fill the card
    assert plan(32, 32, 2, blk_lo=28) == 1
    assert plan(300, 1, 6, d=256, dtype=torch.float32) == 2
    assert plan(16, 32, 96, d=1040) == 0
    # int8 pools plan as their rows' bytes give warps: 4 to D = 128, 2 at
    # 256 (as bf16 at 128), 1 past it
    assert plan(16, 32, 8 * 12, dtype=torch.int8) == 4
    assert plan(300, 1, 6, d=256, dtype=torch.int8) == \
        plan(300, 1, 6, d=128, dtype=torch.bfloat16)
    assert plan(64, 8, 2, d=512, dtype=torch.int8) == \
        plan(64, 8, 2, d=256, dtype=torch.bfloat16)


@pytest.mark.parametrize("mn_major", [False, True],
                         ids=["k_major", "mn_major"])
@pytest.mark.parametrize("s,d,dt", [(64, 64, 64), (50, 40, 64),
                                    (64, 128, 128), (70, 96, 128)])
def test_swizzled_tma_tile_reads_back_through_wgmma_descriptors(
        emu, build_dir, s, d, dt, mn_major):
    """A (S, D) bf16 matrix loaded by the emulated TMA through the
    source's tensor map (128-byte swizzle, zeros past S and D) and read
    back through the source's K-major or MN-major wgmma descriptors, as
    the emulated wgmma decodes them, is the matrix again, for tiles of
    DT = 64 and 128 (two boxes a row)."""
    rng = np.random.RandomState(s + d)
    x = torch.from_numpy(rng.randn(s, d).astype(np.float32)).bfloat16()
    want = torch.zeros(64, dt)
    want[:min(s, 64), :d] = x[:64].float()
    lib = emu.load("flash_attention", build_dir)
    assert torch.equal(emu.tile_readback(lib, x, dt, mn_major), want)


def test_every_inline_ptx_helper_is_emulated(emu):
    """The translation leaves no inline PTX in any source: each helper
    that holds some is one the emulator replaces."""
    for name in ("flash_attention", "resnet_bottleneck", "paged_attention"):
        text = (ROOT / "singa_tpu_torch" / "csrc" / f"{name}.cu").read_text()
        assert "asm" not in emu.emulated_source(text).replace(
            "emu.h", "")
