"""The port's CNN zoo (``singa_tpu_torch/models``: MLP, CNN, AlexNet, VGG,
MobileNetV2, Xception, U-Net) against the JAX package's
(``singa_tpu/models``), and ``examples/mlp/train.py``'s flow.

* State names and shapes equal the JAX model's at small widths, and the
  parameter count equals it at full width (the published widths and
  input sizes), counted from shapes without running either model: the
  JAX model compiled under ``jax.eval_shape``, the port's on torch's
  ``meta`` device.
* Eval logits from the same weights (the port's initial weights, BN
  scales, biases and running statistics moved off 1/0/0/1, carried into
  the JAX model by ``set_states``): atol 1e-4 · max(1, max |logit|),
  float32 through up to 17 conv blocks summed in other orders (XLA's and
  oneDNN's convolutions).  AlexNet and Xception, whose widths are fixed,
  are compared by this forward alone at batch 1 (63² and 71²: their
  smallest inputs that keep every stage non-empty).
* Two SGD(0.05, momentum 0.9) steps (dropout 0), JAX in graph mode,
  each from the JAX model's state (the second with its momentum), as
  ``tests/test_torch_resnet.py`` does: losses rtol 1e-4, weights atol
  1e-4 after each step (gradients through batch norm at batch 4 amplify
  the packages' rounding differences to ~1e-5; MobileNetV2 at 64² so its
  last batch norms see 2 × 2 positions).
* The ``examples/mlp/train.py`` flow (its data generator copied below,
  ``MLP(2, 3, 2)``, SGD(0.05, 0.9, wd 1e-5), batch 64, the
  ``tensor.Tensor`` placeholder, graph mode): the losses of 20 steps
  within rtol 1e-4 of the JAX package's from the same initial weights,
  and the same eval accuracy (> 0.9).

Inputs and labels come from numpy seeds.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from singa_tpu import autograd as jautograd
from singa_tpu import device as jdevice
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu_torch import device, layer, opt, tensor
from singa_tpu_torch import device as tdevice

#: name -> (module, class, small kwargs, small input shape, classes)
ZOO = {
    "mlp": ("mlp", "MLP", dict(data_size=6, perceptron_size=8,
                               num_classes=3), (4, 6), 3),
    "cnn": ("cnn", "CNN", dict(num_classes=10), (4, 1, 28, 28), 10),
    "vgg11_bn": ("vgg", "vgg11", dict(num_classes=10, hidden=16,
                                      batch_norm=True, dropout=0.0),
                 (4, 3, 32, 32), 10),
    "mobilenet_v2": ("mobilenet", "mobilenet_v2",
                     dict(num_classes=10, width_mult=0.25, dropout=0.0),
                     (4, 3, 64, 64), 10),
    "unet": ("unet", "UNet", dict(num_classes=2, base_channels=4, depth=2),
             (4, 3, 16, 16), 2),
    "alexnet": ("alexnet", "AlexNet", dict(num_classes=10), (1, 3, 63, 63),
                10),
    "xception": ("xceptionnet", "Xception", dict(num_classes=10),
                 (1, 3, 71, 71), 10),
}
FORWARD_ONLY = ("alexnet", "xception")

#: name -> (module, factory, kwargs, published input shape)
FULL = {
    "mlp": ("mlp", "MLP", {}, (1, 10)),
    "cnn": ("cnn", "CNN", {}, (1, 1, 28, 28)),
    "alexnet": ("alexnet", "AlexNet", {}, (1, 3, 224, 224)),
    "vgg16": ("vgg", "vgg16", {}, (1, 3, 224, 224)),
    "vgg19_bn": ("vgg", "vgg19", dict(batch_norm=True), (1, 3, 224, 224)),
    "mobilenet_v2": ("mobilenet", "mobilenet_v2", {}, (1, 3, 224, 224)),
    "xception": ("xceptionnet", "Xception", {}, (1, 3, 299, 299)),
    "unet": ("unet", "UNet", dict(num_classes=2, base_channels=16, depth=3),
             (1, 3, 256, 256)),
}


@pytest.fixture(autouse=True)
def _restore_jax_training_flag():
    prev = jautograd.training
    yield
    jautograd.set_training(prev)


def _cpu():
    return device.create_cpu_device()


def _jax_cls(mod, cls):
    return getattr(importlib.import_module(f"singa_tpu.models.{mod}"), cls)


def _port_cls(mod, cls):
    return getattr(importlib.import_module(f"singa_tpu_torch.models.{mod}"),
                   cls)


def jax_shaped(m, shape, use_graph=False):
    """``m.compile`` without running the model (``jax.eval_shape``; the
    device key the initializers split is put back)."""
    dev = jdevice.get_default_device()
    key = dev._rng_key
    try:
        jax.eval_shape(
            lambda a: m.compile([jtensor.Tensor(data=a)], is_train=True,
                                use_graph=use_graph) or 0,
            jax.ShapeDtypeStruct(shape, jnp.float32))
    finally:
        dev._rng_key = key
    return m


class _MetaDevice:
    """Stands in for a singa device while the port's model is compiled on
    torch's ``meta`` device (shapes only, no values)."""

    generator = None

    def EnableGraph(self, on):
        pass


def port_shaped(m, shape, monkeypatch):
    real = tdevice.device_of

    def device_of(t):
        return _MetaDevice() if t.device.type == "meta" else real(t)

    monkeypatch.setattr(tdevice, "device_of", device_of)
    monkeypatch.setattr(layer, "device_of", device_of)
    m.compile([torch.zeros(shape, device="meta")], is_train=True)
    return m


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_width_parameter_count_equals_jax(name, monkeypatch):
    mod, cls, kw, shape = FULL[name]
    jm = jax_shaped(_jax_cls(mod, cls)(**kw), shape)
    tm = port_shaped(_port_cls(mod, cls)(**kw), shape, monkeypatch)
    js = {k: tuple(v.shape) for k, v in jm.get_states().items()}
    ts = {k: tuple(v.shape) for k, v in tm.get_states().items()}
    assert ts == js
    count = sum(int(np.prod(v.shape)) for v in jm.get_params().values())
    assert sum(p.numel() for p in tm.get_params().values()) == count
    published = {"vgg16": 138_357_544, "mobilenet_v2": 3_504_872,
                 "alexnet": 61_100_840}
    assert count == published.get(name, count)


def _pair(name, use_graph=False):
    """(JAX model, port model, x, y): the port's initial weights, with BN
    scales, biases and running statistics moved off 1/0/0/1, in both."""
    mod, cls, kw, shape, classes = ZOO[name]
    rng = np.random.RandomState(len(name))
    x = rng.randn(*shape).astype(np.float32)
    lab_shape = (shape[0], shape[2], shape[3]) if cls == "UNet" \
        else (shape[0],)
    y = rng.randint(0, classes, lab_shape).astype(np.int32)
    cpu = _cpu()
    cpu.SetRandSeed(len(name))
    tm = _port_cls(mod, cls)(**kw)
    tm.set_optimizer(opt.SGD(lr=0.05, momentum=0.9))
    tm.compile([tensor.from_numpy(x, cpu)], is_train=True,
               use_graph=use_graph)
    states = {}
    for k, v in tm.get_states().items():
        v = v.detach().numpy().copy()
        if k.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith(("running_mean", ".bias")) or (
                k.endswith(".scale") and v.ndim == 1):
            v = v + rng.uniform(-0.2, 0.2, v.shape).astype(np.float32)
        states[k] = v
    tm.set_states(states)
    jm = _jax_cls(mod, cls)(**kw)
    jm.set_optimizer(jopt.SGD(lr=0.05, momentum=0.9))
    jax_shaped(jm, shape, use_graph=use_graph)
    assert set(jm.get_states()) == set(states)
    jm.set_states(states)
    return jm, tm, x, y


def _jax_eval_logits(jm, x):
    """The JAX model's eval forward, jitted (its weights are constants of
    the trace; the device key is put back)."""
    jm.eval()
    dev = jdevice.get_default_device()
    key = dev._rng_key
    try:
        return np.asarray(jax.jit(
            lambda a: jm.forward(jtensor.Tensor(data=a)).data)(x))
    finally:
        dev._rng_key = key


@pytest.mark.parametrize("name", sorted(ZOO))
def test_eval_logits_from_carried_weights_match_jax(name):
    jm, tm, x, _ = _pair(name)
    want = _jax_eval_logits(jm, x)
    tm.eval()
    with torch.no_grad():
        got = tm(tensor.from_numpy(x, _cpu())).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("name", sorted(n for n in ZOO
                                        if n not in FORWARD_ONLY))
def test_two_sgd_steps_from_one_state_match_jax(name):
    jm, tm, x, y = _pair(name, use_graph=True)
    cpu = _cpu()
    for step in range(2):
        # each step from the JAX model's state, momentum included: over
        # chained steps a rounding difference that moves a ReLU input
        # across zero grows (ROADMAP "Divergences by design")
        tm.set_states({k: jtensor.to_numpy(v)
                       for k, v in jm.get_states().items()})
        tm.optimizer.set_states(jm.optimizer.get_states())
        _, jl = jm(jtensor.from_numpy(x), jtensor.from_numpy(y))
        _, tl = tm(tensor.from_numpy(x, cpu), tensor.from_numpy(y, cpu))
        np.testing.assert_allclose(tl.item(), float(jtensor.to_numpy(jl)),
                                   rtol=1e-4, err_msg=f"loss, step {step}")
        js = jm.get_states()
        for k, v in tm.get_states().items():
            np.testing.assert_allclose(v.detach().numpy(),
                                       jtensor.to_numpy(js[k]), atol=1e-4,
                                       err_msg=f"{k}, step {step}")


# ------------------------------------------------- the examples/mlp flow


def load_data(n=400, seed=0):
    """``examples/mlp/train.py``'s data: two gaussian blobs, 2 classes."""
    rng = np.random.RandomState(seed)
    x0 = rng.randn(n // 2, 2).astype(np.float32) + np.array([2, 2],
                                                            np.float32)
    x1 = rng.randn(n // 2, 2).astype(np.float32) + np.array([-2, -2],
                                                            np.float32)
    x = np.concatenate([x0, x1])
    y = np.concatenate([np.zeros(n // 2), np.ones(n // 2)]).astype(np.int32)
    idx = rng.permutation(n)
    return x[idx], y[idx]


def mlp_flow(pkg, mlp_cls, dev, states=None, steps=20, batch=64):
    """``examples/mlp/train.py``'s ``run`` with ``--use-graph``: compile
    on a ``tensor.Tensor`` placeholder, train ``steps`` batches in epoch
    order, then the eval accuracy on the held-out fifth.  Returns
    (losses, accuracy, initial states)."""
    x_np, y_np = load_data()
    n_train = int(0.8 * len(x_np))
    m = mlp_cls(data_size=2, perceptron_size=3, num_classes=2)
    m.set_optimizer(pkg.opt.SGD(lr=0.05, momentum=0.9, weight_decay=1e-5))
    m.compile([pkg.tensor.Tensor((batch, 2), dev)], is_train=True,
              use_graph=True, sequential=False)
    if states is not None:
        m.set_states(states)
    init = {k: np.array(pkg.tensor.to_numpy(v)) for k, v in
            m.get_states().items()}
    losses = []
    starts = list(range(0, n_train - batch + 1, batch))
    while len(losses) < steps:
        for i in starts[:steps - len(losses)]:
            xb = pkg.tensor.from_numpy(x_np[i:i + batch], dev)
            yb = pkg.tensor.from_numpy(y_np[i:i + batch], dev)
            _, loss = m(xb, yb)
            losses.append(float(pkg.tensor.to_numpy(loss)))
    m.eval()
    out = m(pkg.tensor.from_numpy(x_np[n_train:], dev))
    acc = float((pkg.tensor.to_numpy(out).argmax(-1)
                 == y_np[n_train:]).mean())
    return losses, acc, init


def test_examples_mlp_flow_loss_trajectory_matches_jax():
    import types

    import singa_tpu
    import singa_tpu_torch
    from singa_tpu.models.mlp import MLP as JMLP
    from singa_tpu_torch.models.mlp import MLP

    jpkg = types.SimpleNamespace(opt=singa_tpu.opt, tensor=singa_tpu.tensor)
    tpkg = types.SimpleNamespace(opt=singa_tpu_torch.opt,
                                 tensor=singa_tpu_torch.tensor)
    jdev = jdevice.get_default_device()
    jdev.SetRandSeed(0)
    j_losses, j_acc, init = mlp_flow(jpkg, JMLP, jdev)
    t_losses, t_acc, _ = mlp_flow(tpkg, MLP, _cpu(), states=init)
    assert len(t_losses) == len(j_losses) == 20
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-4)
    assert t_acc == j_acc > 0.9
