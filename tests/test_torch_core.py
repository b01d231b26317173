"""The port's core (``singa_tpu_torch``): import hygiene, devices, tensors,
the cross-entropy op and the optimizers against the JAX package.

Optimizer updates compare one float32 parameter over three steps at
atol 1e-6 (values O(1); both packages do the same float32 arithmetic in
another order).
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU: tests/conftest.py)
import torch

from singa_tpu import autograd as jautograd
from singa_tpu import layer as jlayer
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu_torch import autograd, device, layer, opt, tensor

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "singa_tpu_torch"


def test_import_pulls_in_neither_jax_nor_singa_tpu():
    code = ("import sys, singa_tpu_torch\n"
            "from singa_tpu_torch import amp, autograd, device, layer, "
            "model, opt, tensor\n"
            "from singa_tpu_torch.models import (alexnet, cnn, common, "
            "gpt2, gpt2_decode, mlp, mobilenet, resnet, unet, vgg, "
            "xceptionnet)\n"
            "from singa_tpu_torch import resilience, utils\n"
            "from singa_tpu_torch.utils import logging, metrics, timer\n"
            "from singa_tpu_torch.ops import (batchnorm, bottleneck, conv, "
            "flash_attention, padding, paged_attention, pooling)\n"
            "from singa_tpu_torch import serve\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'singa_tpu' or "
            "m.startswith('singa_tpu.') or m == 'singa' or "
            "m.startswith('singa.') or m == 'experiments' or "
            "m.startswith('experiments.') or 'resnet_megakernel' in m]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_sources_never_import_jax_or_singa_tpu():
    """No file of the port says ``import jax``, names a ``singa_tpu.``
    module (``singa_tpu_torch.`` is the port itself) or imports from
    ``experiments/``."""
    offenders = [
        str(path.relative_to(ROOT))
        for path in sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
        if re.search(r"\bimport jax\b|\bfrom jax\b|\bsinga_tpu\.|"
                     r"^\s*(import|from) (singa|experiments)\b",
                     path.read_text(), re.M)]
    assert not offenders, offenders


def test_default_device_is_cuda_or_raises():
    if torch.cuda.is_available():
        assert device.get_default_device().torch_device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device.get_default_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            device.create_cuda_gpu()


def test_cpu_device_on_request():
    cpu = device.create_cpu_device()
    assert cpu.torch_device.type == "cpu"
    assert device.create_cpu_device() is cpu
    cpu.SetRandSeed(3)
    a = torch.rand(4, generator=cpu.generator)
    cpu.SetRandSeed(3)
    assert torch.equal(a, torch.rand(4, generator=cpu.generator))


def test_tensor_round_trip_copies():
    cpu = device.create_cpu_device()
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    t = tensor.from_numpy(x, cpu)
    back = tensor.to_numpy(t)
    np.testing.assert_array_equal(back, x)
    back[0, 0] = 42.0
    assert t[0, 0].item() == 0.0
    assert tensor.to_numpy(t.to(torch.bfloat16)).dtype == np.float32


def test_softmax_cross_entropy_matches_jax_including_ignored_rows():
    """Forward and gradient equal the JAX op's, ignored (−1) rows too:
    the JAX op's hand-written gradient gives those rows p/N rather than
    zero, and the port keeps that for parity."""
    rng = np.random.RandomState(0)
    x = rng.randn(6, 5).astype(np.float32)
    t = np.array([1, -1, 2, 4, -1, 0], np.int32)
    xj = jtensor.from_numpy(x)
    xj.requires_grad = xj.stores_grad = True
    prev = jautograd.training
    jautograd.set_training(True)
    try:
        lj = jautograd.softmax_cross_entropy(xj, jtensor.from_numpy(t))
        gj = {id(p): g for p, g in jautograd.backward(lj)}[id(xj)]
    finally:
        jautograd.set_training(prev)
    xt = torch.tensor(x, requires_grad=True)
    lt = autograd.softmax_cross_entropy(xt, torch.from_numpy(t))
    (gt,) = torch.autograd.grad(lt, xt)
    np.testing.assert_allclose(lt.item(), float(jtensor.to_numpy(lj)),
                               rtol=1e-6)
    np.testing.assert_allclose(gt.numpy(), jtensor.to_numpy(gj), atol=1e-7)
    assert np.abs(gt.numpy()[t < 0]).min() > 0


def test_linear_keeps_the_jax_layout():
    """``layer.Linear`` holds W as (in, out) with y = x @ W + b, so the JAX
    layer's weights load without a transpose and give the same output."""
    rng = np.random.RandomState(1)
    x = rng.randn(4, 6).astype(np.float32)
    jl = jlayer.Linear(3)
    yj = jtensor.to_numpy(jl(jtensor.from_numpy(x)))
    tl = layer.Linear(3)
    xt = tensor.from_numpy(x, device.create_cpu_device())
    tl(xt)
    tl.set_name("Linear")
    assert tuple(tl.W.shape) == (6, 3)
    tl.set_states({"Linear.W": jtensor.to_numpy(jl.W),
                   "Linear.b": jtensor.to_numpy(jl.b)})
    with torch.no_grad():
        np.testing.assert_allclose(tl(xt).numpy(), yj, atol=1e-6)


# ------------------------------------------------------------- optimizers

OPTIMIZERS = {
    "sgd_plain": (lambda m: m.SGD(lr=0.1)),
    "sgd_momentum_dampening": (
        lambda m: m.SGD(lr=0.1, momentum=0.9, dampening=0.2)),
    "sgd_nesterov_weight_decay": (
        lambda m: m.SGD(lr=0.05, momentum=0.8, nesterov=True,
                        weight_decay=0.01)),
    "adam": (lambda m: m.Adam(lr=1e-2)),
    "adam_weight_decay": (lambda m: m.Adam(lr=1e-2, weight_decay=0.1)),
    "adamw": (lambda m: m.AdamW(lr=1e-2, weight_decay=0.1)),
    "sgd_clip_norm": (lambda m: m.SGD(lr=0.1, momentum=0.9, clip_norm=0.5)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_jax(name):
    rng = np.random.RandomState(sorted(OPTIMIZERS).index(name))
    w = rng.randn(3, 4).astype(np.float32)
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](opt)
    pj = jtensor.from_numpy(w)
    pj.name = "w"
    pt = torch.nn.Parameter(torch.from_numpy(w.copy()))
    for _ in range(3):
        g = rng.randn(3, 4).astype(np.float32)
        gj, gt = jtensor.from_numpy(g), torch.from_numpy(g)
        if jo.clip_norm is not None:
            ((_, gj),) = jo._clip_pairs([(pj, gj)])
            ((_, gt),) = to._clip_pairs([(pt, gt)])
            np.testing.assert_allclose(gt.numpy(), jtensor.to_numpy(gj),
                                       atol=1e-6)
        jo.apply("w", pj, gj)
        jo.step()
        with torch.no_grad():
            to.apply("w", pt, gt)
        to.step()
        np.testing.assert_allclose(pt.detach().numpy(),
                                   jtensor.to_numpy(pj), atol=1e-6)
    js, ts = jo.get_states(), to.get_states()
    assert set(ts) == set(js)
    for k, v in js.items():
        np.testing.assert_allclose(ts[k], v, atol=1e-6, err_msg=k)


def test_nesterov_requires_momentum():
    with pytest.raises(ValueError, match="nesterov"):
        opt.SGD(lr=0.1, nesterov=True)


def test_clip_norm_must_be_positive():
    with pytest.raises(ValueError, match="clip_norm"):
        opt.SGD(lr=0.1, clip_norm=0.0)
