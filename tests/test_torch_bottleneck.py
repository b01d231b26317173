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
