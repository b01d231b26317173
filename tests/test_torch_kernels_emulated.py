"""The port's CUDA kernel sources run on the CPU through
``tools/cuda_emulator`` (``tools/emulate_kernels.py``), against their
plain PyTorch versions at ``chip_smoke.TOL``.

The emulator runs each CUDA thread as a fiber, with the warp-level PTX
the kernels use (``ldmatrix``, ``mma.sync``, ``cp.async`` landing at
``wait_group``) and shared memory that starts as garbage.  So these tests
catch indexing, masking, tiling and synchronisation faults in the
kernels without a card.  It sums each ``mma`` exactly, so the card's own
rounding is held on the card (tests/test_torch_kernels_cuda.py,
``chip_smoke.py``).  Cases: small ``chip_smoke`` edge cases, bf16 for
flash attention (the tensor-core route, the CUDA-core kernels at D = 512
and their 8-row rung at D = 640 and 1024, there in float32 too), the
ragged and narrow ones for the bottleneck; for paged attention, the
split and combine kernels in float32 and bf16 at ``chip_smoke.PAGED_TOL``,
launched as the wrapper launches them (the table width as the bound of
the blocks read, which the kernel narrows from the positions on the
device; launches of at most ``max_rows(D)`` query rows), on seven cases
at the split count the wrapper would choose (dead slots with all-trash
tables, GQA g = 3 with Q = 4 at D = 128, a window over Q = 4, D = 640,
D = 1024 with 6 heads, 32 query rows at D = 64, Q = 24 positions of 2
heads under a window in runs of 16) and on D = 16 and a long
slot beside short ones at D = 64 over one split and over three, each
also on int8 pools ((values, scales) pairs) with float32 and bf16 q at
the q dtype's tolerance; and the split plan itself, int8 pools
included.  Needs a C++ compiler.
"""

import importlib.util
import pathlib
import shutil

import pytest
import torch

import chip_smoke

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLASH = ("s65_causal", "s129_causal", "d13_s100", "window1", "neg_inf_row",
         "general_mask_mBH", "d512_window", "d640_window",
         "d1024_general_mask")
BOTTLENECK = ("hw7_bands_ragged", "c128_cm32", "odd_h5_w9_cm8")
PAGED = ("dead_slots_all_trash", "g3_q4_d128", "window_q4_g3", "d640",
         "d1024_g6", "g8_q4_32_rows", "q24_g2_window")


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


def test_every_inline_ptx_helper_is_emulated(emu):
    """The translation leaves no inline PTX in any source: each helper
    that holds some is one the emulator replaces."""
    for name in ("flash_attention", "resnet_bottleneck", "paged_attention"):
        text = (ROOT / "singa_tpu_torch" / "csrc" / f"{name}.cu").read_text()
        assert "asm" not in emu.emulated_source(text).replace(
            "emu.h", "")
