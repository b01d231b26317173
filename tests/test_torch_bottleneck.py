"""The conv2_x bottleneck block of the port (``ops/bottleneck.py``)
against the JAX experiment it replaces, ``experiments/resnet_megakernel.py``
(loaded from its file, unedited).

At the block's true widths (56 x 56, C = 256, CM = 64) with the
experiment's batch ``B`` set to 2, ``megakernel_block_plain`` is held
against the experiment's ``xla_chain`` and its Pallas
``megakernel_block`` in interpret mode.  All three round y1, y2 and the
output to bf16 after float32 sums taken in different orders, so an
element may land one bf16 ulp apart, in the output or in a y2 it sums:
allclose rtol 2^-7 (one ulp of the output) and atol 2^-6 (one ulp of a
y2 of magnitude 2-4, times a w3 entry, near an output that cancels to
~0), on outputs of magnitude O(1-10); and at most 0.5% of elements
differing at all.  (The experiment's own two functions differ from each
other by as much.)

``fold_bottleneck`` is held against the port's own eval-mode
``Bottleneck``: its bf16 weights, cast back to float32, drive the plain
version in float32 (the block's conv weights are bf16-representable, so
the cast is exact): atol 1e-4 on outputs of magnitude O(1-10).
"""

import importlib.util
import pathlib

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU: tests/conftest.py)
import jax.numpy as jnp
import torch

from singa_tpu import tensor as jtensor
from singa_tpu.models import resnet as jresnet
from singa_tpu_torch.models import resnet
from singa_tpu_torch.ops import bottleneck

ROOT = pathlib.Path(__file__).resolve().parents[1]
HW, C, CM = 56, 256, 64
RTOL, ATOL = 2.0 ** -7, 2.0 ** -6


@pytest.fixture(scope="module")
def experiment():
    spec = importlib.util.spec_from_file_location(
        "resnet_megakernel", ROOT / "experiments" / "resnet_megakernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(b, seed, c=C, cm=CM, hw=HW):
    """numpy float32 arguments (x and weights already bf16-representable):
    weights ~ N(0, 2/fan_in) so every stage is O(1), random folded BN."""
    rng = np.random.RandomState(seed)

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).bfloat16().float(
            ).numpy()

    x = bf16(rng.randn(b, hw, hw, c))
    w1 = bf16(rng.randn(c, cm) * np.sqrt(2.0 / c))
    w2 = bf16(rng.randn(3, 3, cm, cm) * np.sqrt(2.0 / (9 * cm)))
    w3 = bf16(rng.randn(cm, c) * np.sqrt(2.0 / cm))
    sb = []
    for n in (cm, cm, c):
        sb += [rng.uniform(0.5, 1.5, n).astype(np.float32),
               (rng.randn(n) * 0.5).astype(np.float32)]
    s1, b1, s2, b2, s3, b3 = sb
    return x, w1, s1, b1, w2, s2, b2, w3, s3, b3


def _torch_args(args):
    x, w1, s1, b1, w2, s2, b2, w3, s3, b3 = (torch.from_numpy(a)
                                              for a in args)
    return (x.bfloat16(), w1.bfloat16(), s1, b1, w2.bfloat16(), s2, b2,
            w3.bfloat16(), s3, b3)


def _jax_args(args):
    bf = {0, 1, 4, 7}  # x, w1, w2, w3
    return tuple(jnp.asarray(a).astype(jnp.bfloat16) if i in bf
                 else jnp.asarray(a) for i, a in enumerate(args))


def _close_in_bf16(got, want):
    got, want = got.astype(np.float32), want.astype(np.float32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.mean(got != want) <= 5e-3


@pytest.mark.parametrize("reference", ["xla_chain", "megakernel_block"])
def test_plain_matches_jax_at_true_widths(experiment, monkeypatch,
                                          reference):
    monkeypatch.setattr(experiment, "B", 2)
    args = _inputs(2, seed=0)
    want = np.asarray(getattr(experiment, reference)(*_jax_args(args))
                      .astype(jnp.float32))
    got = bottleneck.megakernel_block_plain(*_torch_args(args))
    assert got.shape == (2, HW, HW, C) and got.dtype == torch.bfloat16
    _close_in_bf16(got.float().numpy(), want)


def test_halo_is_zero_not_relu_b1(experiment, monkeypatch):
    """b1 = +1: the 3x3 conv's SAME padding of y1 is 0 in both packages,
    not relu(b1)."""
    monkeypatch.setattr(experiment, "B", 1)
    args = list(_inputs(1, seed=1))
    args[2] = np.ones(CM, np.float32)   # s1
    args[3] = np.ones(CM, np.float32)   # b1
    want = np.asarray(experiment.xla_chain(*_jax_args(args))
                      .astype(jnp.float32))
    got = bottleneck.megakernel_block_plain(*_torch_args(args))
    _close_in_bf16(got.float().numpy(), want)


def _carried_block(seed=0):
    """The port's resnet50 ``layer1[1]`` holding the states of a JAX
    ``Bottleneck(64)`` with BN statistics away from their initial values
    and bf16-representable conv weights, in eval mode; and an input for it
    (NCHW float32)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, C, 12, 12).astype(np.float32)
    jb = jresnet.Bottleneck(CM)
    jb(jtensor.from_numpy(x))
    jb.set_name("Bottleneck")
    tm = resnet.resnet50()
    tm.compile([torch.from_numpy(rng.randn(1, 3, 32, 32).astype(
        np.float32))], is_train=False)
    block = tm.layer1[1]
    states = {}
    for k, v in jb.get_states().items():
        v = jtensor.to_numpy(v)
        if k.endswith(("running_var", ".scale")):
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith(("running_mean", ".bias")):
            v = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k.endswith(".W"):
            v = torch.from_numpy(v).bfloat16().float().numpy()
        states[block.name + k[len("Bottleneck"):]] = v
    block.set_states(states)
    block.eval()
    return block, torch.from_numpy(x)


def test_fold_bottleneck_gives_the_eval_block(experiment):
    block, x = _carried_block()
    assert block.name == "ResNet.layer11"
    w1, s1, b1, w2, s2, b2, w3, s3, b3 = bottleneck.fold_bottleneck(block)
    assert (w1.shape, w2.shape, w3.shape) == ((C, CM), (3, 3, CM, CM),
                                              (CM, C))
    assert w1.dtype == w2.dtype == w3.dtype == torch.bfloat16
    assert s3.dtype == b3.dtype == torch.float32 and s3.shape == (C,)
    with torch.no_grad():
        want = block(x).permute(0, 2, 3, 1)
        got = bottleneck.megakernel_block_plain(
            x.permute(0, 2, 3, 1).contiguous(), w1.float(), s1, b1,
            w2.float(), s2, b2, w3.float(), s3, b3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4,
                               rtol=0)


def test_fold_bottleneck_refuses_what_the_kernel_cannot_fold():
    block, _ = _carried_block()
    block.train()
    with pytest.raises(ValueError, match="eval"):
        bottleneck.fold_bottleneck(block)
    tm = resnet.resnet50()
    tm.compile([torch.zeros(1, 3, 32, 32)], is_train=False)
    with pytest.raises(ValueError, match="identity skip"):
        bottleneck.fold_bottleneck(tm.layer1[0])


def test_cpu_wrapper_runs_the_plain_version_and_counts_nothing():
    args = _torch_args(_inputs(1, seed=2, hw=7))
    before = bottleneck.megakernel_block.launches
    got = bottleneck.megakernel_block(*args)
    assert bottleneck.megakernel_block.launches == before
    assert torch.equal(got, bottleneck.megakernel_block_plain(*args))


@pytest.mark.parametrize("affine", ["random", "b1_plus_one"])
def test_chip_smoke_gate_refuses_planted_faults(monkeypatch, affine):
    """``chip_smoke``'s per-element gate passes the plain version against
    itself and refuses both planted faults (a relu(b1) ring, a skip left
    out of one column)."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEVICE", torch.device("cpu"))
    args = chip_smoke.bottleneck_inputs(2, 14, 14, C, CM, seed=3,
                                        affine=affine)
    want = bottleneck.megakernel_block_plain(*args)
    assert chip_smoke.bottleneck_stats(want, want,
                                       chip_smoke.TOL["bottleneck"])["ok"]
    faults = chip_smoke.refuse_planted_faults(args, want)
    assert set(faults) == {"halo_relu_b1", "no_skip_one_column"}
    assert all(f["share_past_limit"] > 0 for f in faults.values())


@pytest.mark.parametrize("affine", ["random", "b1_plus_one"])
def test_f64_reference_rounds_where_the_plain_version_does(monkeypatch,
                                                           affine):
    """``chip_smoke.bottleneck_f64`` (float64 sums, taken a few images at
    a time) rounds y1, y2 and the output where the plain version does: the
    two pass the gate, and the float64 witness passes the plain version
    against itself."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEVICE", torch.device("cpu"))
    args = chip_smoke.bottleneck_inputs(3, 9, 11, C, CM, seed=4,
                                        affine=affine)
    exact = chip_smoke.bottleneck_f64(*args, images=2)
    plain = bottleneck.megakernel_block_plain(*args)
    assert chip_smoke.bottleneck_stats(plain, exact,
                                       chip_smoke.TOL["bottleneck"])["ok"]
    assert chip_smoke.f64_witness(plain, plain, exact)["ok"]


@pytest.mark.parametrize("fault", ["halo_relu_b1", "no_skip_one_column"])
def test_f64_witness_refuses_planted_faults(monkeypatch, fault):
    """A kernel output farther from float64 than the plain version's, here
    each planted fault, fails the witness."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEVICE", torch.device("cpu"))
    args = chip_smoke.bottleneck_inputs(2, 14, 14, C, CM, seed=5,
                                        affine="b1_plus_one")
    wrong = chip_smoke.planted_faults(*args)[fault]
    res = chip_smoke.f64_witness(wrong, bottleneck.megakernel_block_plain(
        *args), chip_smoke.bottleneck_f64(*args))
    assert not res["ok"], res


@pytest.fixture(scope="module")
def kernel_band_rows(tmp_path_factory):
    """The kernel's own band height for a width W
    (``resnet_bottleneck_band_rows`` of ``csrc/resnet_bottleneck.cu``, built
    for the CPU by ``tools/emulate_kernels.py``)."""
    import shutil

    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("needs a C++ compiler to build the kernel's source")
    spec = importlib.util.spec_from_file_location(
        "emulate_kernels", ROOT / "tools" / "emulate_kernels.py")
    emu = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(emu)
    lib = emu.load("resnet_bottleneck",
                   str(tmp_path_factory.mktemp("emulated_bottleneck")))
    return lib.resnet_bottleneck_band_rows


def _bands_plain(r, x, w1, s1, b1, w2, s2, b2, w3, s3, b3):
    """The block computed band by band as the kernel cuts the image: bands
    of ``r`` output rows (the last may be shorter), each with
    y1 for one halo row on either side, zero for halo rows outside the
    image and a zero SAME ring of columns; the plain arithmetic (float32
    sums, y1 and y2 rounded to x's dtype) inside each band; the bands
    stitched."""
    n, h, w, c = x.shape
    dt = x.dtype
    out = torch.empty_like(x)
    for h0 in range(0, h, r):
        rb = min(r, h - h0)
        rows = [x[:, i].float() if 0 <= i < h else torch.zeros(n, w, c)
                for i in range(h0 - 1, h0 + rb + 1)]
        y1 = torch.relu(torch.stack(rows, 1) @ w1.float() * s1 + b1)
        live = torch.tensor([0 <= i < h for i in range(h0 - 1, h0 + rb + 1)])
        y1 = (y1 * live[None, :, None, None]).to(dt).float()
        y1 = torch.nn.functional.pad(y1, (0, 0, 1, 1))  # the W ring
        y2 = sum(y1[:, di:di + rb, dj:dj + w] @ w2[di, dj].float()
                 for di in range(3) for dj in range(3))
        y2 = torch.relu(y2 * s2 + b2).to(dt).float()
        band = x[:, h0:h0 + rb].float()
        out[:, h0:h0 + rb] = torch.relu(y2 @ w3.float() * s3 + b3 + band).to(dt)
    return out


@pytest.mark.parametrize("name,case", [
    pytest.param(name, case, id=name)
    for name, case in __import__("chip_smoke").bottleneck_edge_cases()])
def test_band_decomposition_matches_the_whole_image(monkeypatch,
                                                   kernel_band_rows, name,
                                                   case):
    """The kernel's cut of the image into bands (its band height, halo
    rows, zero ring, short last band) gives the block of
    ``megakernel_block_plain`` at every edge shape ``chip_smoke.py`` holds
    the kernel to, within the gate that holds the kernel (the sums run in
    another order)."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEVICE", torch.device("cpu"))
    args = chip_smoke.bottleneck_inputs(seed=0, **case)
    n, h, w, c = args[0].shape
    r = kernel_band_rows(w)
    assert r >= 1
    got = _bands_plain(r, *args)
    stats = chip_smoke.bottleneck_stats(
        got, bottleneck.megakernel_block_plain(*args),
        chip_smoke.TOL["bottleneck"])
    assert stats["ok"], stats
