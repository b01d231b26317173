"""The port's CUDA kernel sources run on the CPU through
``tools/cuda_emulator`` (``tools/emulate_kernels.py``), against their
plain PyTorch versions at ``chip_smoke.TOL``.

The emulator runs each CUDA thread as a fiber, with the warp-level PTX
the kernels use (``ldmatrix``, ``mma.sync``, ``cp.async`` landing at
``wait_group``) and shared memory that starts as garbage.  So these tests
catch indexing, masking, tiling and synchronisation faults in the
tensor-core kernels without a card.  It sums each ``mma`` exactly, so the
card's own rounding is held on the card (tests/test_torch_kernels_cuda.py,
``chip_smoke.py``).  Cases: small ``chip_smoke`` edge cases, bf16 for
flash attention (the tensor-core route), the ragged and narrow ones for
the bottleneck.  Needs a C++ compiler.
"""

import importlib.util
import pathlib
import shutil

import pytest
import torch

import chip_smoke

ROOT = pathlib.Path(__file__).resolve().parents[1]
FLASH = ("s65_causal", "s129_causal", "d13_s100", "window1", "neg_inf_row",
         "general_mask_mBH")
BOTTLENECK = ("hw7_bands_ragged", "c128_cm32", "odd_h5_w9_cm8")


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


@pytest.mark.parametrize("name", BOTTLENECK)
def test_bottleneck_kernel_matches_plain(emu, build_dir, cpu_inputs, name):
    seed, kw = next((i, kw) for i, (n, kw)
                    in enumerate(chip_smoke.bottleneck_edge_cases())
                    if n == name)
    lib = emu.load("resnet_bottleneck", build_dir)
    stats = emu.bottleneck_case(lib, seed=seed, **kw)
    assert stats["ok"], stats


def test_every_inline_ptx_helper_is_emulated(emu):
    """The translation leaves no inline PTX in either source: each helper
    that holds some is one the emulator replaces."""
    for name in ("flash_attention", "resnet_bottleneck"):
        text = (ROOT / "singa_tpu_torch" / "csrc" / f"{name}.cu").read_text()
        assert "asm" not in emu.emulated_source(text).replace(
            "emu.h", "")
