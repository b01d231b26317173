"""ResNet in the port (``singa_tpu_torch``) against the JAX package, from
the same weights, and the conv, pooling and batch-norm ops it is made of.

Both packages build the model; the JAX model's ``get_states()`` (with BN
scales, biases and running statistics set away from their initial values,
so the eval path is exercised) is carried into the port by
``Model.set_states``.  JAX runs eagerly on the CPU.

Tolerances, float32 unless stated; the two packages sum in different
orders (XLA's and oneDNN's convolutions):

* op level: atol 1e-5 on outputs and gradients of magnitude O(1);
* eval logits: atol 1e-4 · max(1, max |logit|), through 8 (resnet18) or
  16 (resnet50) residual blocks;
* two SGD-momentum steps of resnet18 (lr 0.1), each from the same
  state: losses rtol 1e-5, weights and running statistics atol 1e-5,
  momentum buffers (the gradients, O(0.1-1)) atol 5e-5;
* the bf16 amp forward: atol 5e-2 · max(1, max |logit|): bf16 keeps 8
  significant bits (2^-8 ≈ 0.4%) and the packages round activations at
  different points.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU: tests/conftest.py)
import torch

from singa_tpu import amp as jamp
from singa_tpu import autograd as jautograd
from singa_tpu import device as jdevice
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models import resnet as jresnet
from singa_tpu.ops import batchnorm as jbn
from singa_tpu.ops import conv as jconv
from singa_tpu.ops import pooling as jpool
from singa_tpu_torch import amp, device, opt, tensor
from singa_tpu_torch.models import resnet
from singa_tpu_torch.ops import batchnorm, conv, pooling


@pytest.fixture(autouse=True)
def _restore_jax_training_flag():
    """JAX's Model.train/eval set a process-wide flag; leave it as found."""
    prev = jautograd.training
    yield
    jautograd.set_training(prev)


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _perturb(states, seed):
    """BN scales, biases and running statistics away from 1/0/0/1."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in states.items():
        v = jtensor.to_numpy(v)
        if k.endswith(("running_var", ".scale")):
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith(("running_mean", ".bias")):
            v = _rand(rng, *v.shape, scale=0.1)
        out[k] = v
    return out


def _pair(name, x, num_classes, make_opt=None):
    """(jax model, port model) holding the same perturbed states."""
    jdevice.get_default_device().SetRandSeed(0)
    jm = jresnet.create_model(name, num_classes=num_classes)
    tm = resnet.create_model(name, num_classes=num_classes)
    if make_opt is not None:
        jo, to = make_opt()
        jm.set_optimizer(jo)
        tm.set_optimizer(to)
    train = make_opt is not None
    jm.compile([jtensor.from_numpy(x)], is_train=train, use_graph=False)
    tm.compile([tensor.from_numpy(x, device.create_cpu_device())],
               is_train=train)
    states = _perturb(jm.get_states(), seed=1)
    jm.set_states(states)
    tm.set_states(states)
    return jm, tm


def _logits(jm, tm, x):
    jm.eval()
    tm.eval()
    jl = jtensor.to_numpy(jm(jtensor.from_numpy(x)))
    with torch.no_grad():
        tl = tensor.to_numpy(tm(torch.from_numpy(x)))
    return jl, tl


@pytest.fixture(scope="module")
def resnet50_pair():
    x = _rand(np.random.RandomState(0), 4, 3, 64, 64)
    return _pair("resnet50", x, 1000) + (x,)


def test_resnet50_states_match_jax(resnet50_pair):
    jm, tm, _ = resnet50_pair
    js = {k: tuple(v.shape) for k, v in jm.get_states().items()}
    ts = {k: tuple(v.shape) for k, v in tm.get_states().items()}
    assert ts == js
    assert len(ts) == 267
    for name in ("ResNet.conv1.W", "ResNet.bn1.running_mean",
                 "ResNet.layer10.conv1.W", "ResNet.layer10.downsample.conv.W",
                 "ResNet.layer11.bn3.running_var", "ResNet.layer35.bn2.scale",
                 "ResNet.fc.W"):
        assert name in ts, name
    n_params = sum(p.numel() for p in tm.get_params().values())
    assert n_params == sum(int(np.prod(v.shape))
                           for v in jm.get_params().values()) == 25_557_032


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_eval_logits_match_jax(name, resnet50_pair):
    if name == "resnet50":
        jm, tm, x = resnet50_pair
    else:
        x = _rand(np.random.RandomState(0), 4, 3, 64, 64)
        jm, tm = _pair(name, x, 1000)
    jl, tl = _logits(jm, tm, x)
    assert tl.shape == (4, 1000) and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(jl).max()))


def test_training_steps_match_jax():
    """Two SGD-momentum steps (lr 0.1) of resnet18; the second starts
    from the JAX package's weights, running statistics and momentum
    buffers carried into the port, so each step is compared from the
    same state.  Chained instead, the first step's float rounding moves
    some ReLU input across zero in the second and changes a gradient by
    a whole term.  64 x 64 images keep 2 x 2 x 4 values in each of
    layer4's batch statistics."""
    rng = np.random.RandomState(2)
    x = _rand(rng, 4, 3, 64, 64)
    y = rng.randint(0, 10, 4).astype(np.int32)
    jm, tm = _pair("resnet18", x, 10, lambda: (
        jopt.SGD(lr=0.1, momentum=0.9), opt.SGD(lr=0.1, momentum=0.9)))
    start = {k: jtensor.to_numpy(v) for k, v in jm.get_states().items()}
    jm.train()
    tm.train()
    for step in range(2):
        if step:
            tm.set_states({k: jtensor.to_numpy(v)
                           for k, v in jm.get_states().items()})
            tm.optimizer.set_states(jm.optimizer.get_states())
        _, jl = jm(jtensor.from_numpy(x), jtensor.from_numpy(y))
        _, tl = tm(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(tl.item(), float(jtensor.to_numpy(jl)),
                                   rtol=1e-5)
        js, ts = jm.get_states(), tm.get_states()
        assert set(ts) == set(js)
        for k, v in js.items():
            np.testing.assert_allclose(tensor.to_numpy(ts[k]),
                                       jtensor.to_numpy(v), atol=1e-5,
                                       err_msg=f"step {step}: {k}")
        jos, tos = jm.optimizer.get_states(), tm.optimizer.get_states()
        assert set(tos) == set(jos)
        for k, v in jos.items():
            np.testing.assert_allclose(tos[k], v, atol=5e-5,
                                       err_msg=f"step {step}: {k}")
    moved = [k for k in start if k.endswith("running_mean")
             and not np.allclose(tensor.to_numpy(ts[k]), start[k])]
    assert moved, "training did not update the running means"


def test_amp_bf16_forward_matches_jax():
    x = _rand(np.random.RandomState(3), 2, 3, 32, 32)
    jm, tm = _pair("resnet18", x, 10)
    jamp.enable()
    amp.enable()
    try:
        jl, tl = _logits(jm, tm, x)
    finally:
        jamp.enable(False)
        amp.enable(False)
    assert np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=0,
                               atol=5e-2 * max(1.0, np.abs(jl).max()))


# ------------------------------------------------------------------ ops


def _jt(a, grad=False):
    t = jtensor.from_numpy(a)
    if grad:
        t.requires_grad = t.stores_grad = True
    return t


@pytest.mark.parametrize("kw", [
    dict(padding=1),
    dict(padding=0, stride=2),
    dict(pad_mode="SAME_UPPER", stride=2),
    dict(pad_mode="SAME_LOWER", stride=2),
    dict(padding=((0, 2), (1, 0))),
    dict(padding=1, dilation=2, group=2),
], ids=["sym", "stride2", "same_upper", "same_lower", "asym", "dil_group"])
def test_conv2d_matches_jax(kw):
    rng = np.random.RandomState(4)
    x = _rand(rng, 2, 4, 9, 8)
    w = _rand(rng, 6, 4 // kw.get("group", 1), 3, 3, scale=0.3)
    b = _rand(rng, 6)
    want = jtensor.to_numpy(jconv.conv2d(_jt(x), _jt(w), _jt(b), **kw))
    got = conv.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b), **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("is_max", [True, False], ids=["max", "avg"])
@pytest.mark.parametrize("kw", [
    dict(kernel=(3, 3), stride=(2, 2), padding=(1, 1)),
    dict(kernel=(2, 3), stride=(1, 2), padding=((0, 1), (1, 1))),
    dict(kernel=(3, 3), stride=(2, 2), pad_mode="SAME_UPPER"),
    dict(kernel=(2, 2), stride=(2, 2), padding=(1, 1)),
], ids=["resnet_stem", "asym", "same_upper", "pad_equals_half"])
def test_pooling_matches_jax(is_max, kw):
    x = _rand(np.random.RandomState(5), 2, 3, 9, 10)
    want = jtensor.to_numpy(jpool.pooling2d(_jt(x), is_max=is_max, **kw))
    got = pooling.pooling2d(torch.from_numpy(x), is_max=is_max, **kw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_batchnorm_train_matches_jax_with_running_update():
    """Training BN: output, gradients of x, scale and bias (the JAX op's
    custom VJP against the port's), and the running-statistic update
    with the biased batch variance and the reference's momentum."""
    rng = np.random.RandomState(6)
    x = _rand(rng, 4, 3, 5, 6, scale=2.0) + 3.0
    dy = _rand(rng, 4, 3, 5, 6)
    s, b = _rand(rng, 3), _rand(rng, 3)
    rm, rv = _rand(rng, 3, scale=0.1), rng.uniform(0.5, 1.5, 3).astype(
        np.float32)
    xj, sj, bj = _jt(x, True), _jt(s, True), _jt(b, True)
    rmj, rvj = _jt(rm), _jt(rv)
    jautograd.set_training(True)
    yj = jbn.batchnorm2d(xj, sj, bj, rmj, rvj, momentum=0.9, eps=1e-5)
    loss = jautograd.reduce_sum(jautograd.mul(yj, _jt(dy)))
    gj = {id(p): jtensor.to_numpy(g) for p, g in jautograd.backward(loss)}

    xt, st, bt = (torch.tensor(a, requires_grad=True) for a in (x, s, b))
    rmt, rvt = torch.tensor(rm), torch.tensor(rv)
    yt = batchnorm.batchnorm2d(xt, st, bt, rmt, rvt, momentum=0.9,
                               eps=1e-5, training=True)
    gt = torch.autograd.grad(yt, (xt, st, bt), torch.from_numpy(dy))
    np.testing.assert_allclose(yt.detach().numpy(), jtensor.to_numpy(yj),
                               atol=1e-5)
    for got, want in zip(gt, (xj, sj, bj)):
        np.testing.assert_allclose(got.numpy(), gj[id(want)], atol=1e-5)
    np.testing.assert_allclose(rmt.numpy(), jtensor.to_numpy(rmj),
                               atol=1e-6)
    np.testing.assert_allclose(rvt.numpy(), jtensor.to_numpy(rvj),
                               atol=1e-6)
    # the biased variance, and momentum weighting the old value
    var = x.var(axis=(0, 2, 3))
    np.testing.assert_allclose(rvt.numpy(), 0.9 * rv + 0.1 * var,
                               rtol=1e-5)


def test_batchnorm_eval_matches_jax():
    rng = np.random.RandomState(7)
    x = _rand(rng, 2, 3, 4, 4)
    s, b, rm = _rand(rng, 3), _rand(rng, 3), _rand(rng, 3)
    rv = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    jautograd.set_training(False)
    want = jtensor.to_numpy(jbn.batchnorm2d(
        _jt(x), _jt(s), _jt(b), _jt(rm), _jt(rv)))
    rmt, rvt = torch.tensor(rm), torch.tensor(rv)
    got = batchnorm.batchnorm2d(torch.from_numpy(x), torch.from_numpy(s),
                                torch.from_numpy(b), rmt, rvt,
                                training=False)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_array_equal(rmt.numpy(), rm)
    np.testing.assert_array_equal(rvt.numpy(), rv)


def test_eval_switches_batchnorm_to_running_stats():
    """``Model.eval()`` reaches every BN layer; a forward in eval mode
    leaves the running statistics alone, one in training mode moves
    them."""
    x = torch.from_numpy(_rand(np.random.RandomState(8), 2, 3, 32, 32))
    tm = resnet.resnet18(num_classes=10)
    tm.compile([x], is_train=False)
    bns = [m for m in tm.modules() if isinstance(m, resnet.layer.BatchNorm2d)]
    assert len(bns) == 20 and not any(m.training for m in bns)
    before = {k: v.clone() for k, v in tm.get_states().items()}
    with torch.no_grad():
        tm(x)
    assert all(torch.equal(before[k], v)
               for k, v in tm.get_states().items())
    tm.train()
    assert all(m.training for m in bns)
    with torch.no_grad():
        tm.forward(x)
    assert not torch.equal(before["ResNet.bn1.running_mean"],
                           tm.get_states()["ResNet.bn1.running_mean"])


def test_dist_options_other_than_plain_raise():
    from singa_tpu_torch.models.common import apply_dist_option

    for mode in ("fp16", "partialUpdate", "sparseTopK", "sparseThreshold"):
        with pytest.raises(NotImplementedError, match="DistOpt"):
            apply_dist_option(None, None, mode)
    with pytest.raises(ValueError, match="unknown"):
        apply_dist_option(None, None, "nope")
