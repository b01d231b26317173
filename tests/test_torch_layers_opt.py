"""The port's layers, optimizers and schedules against the JAX package's.

Layers (``singa_tpu_torch/layer.py`` against ``singa_tpu/layer.py``):
each of ``ReLU6``, ``LeakyReLU``, ``Sigmoid``, ``Tanh``, ``Gelu``,
``SoftMax``, ``Reshape``, ``Cat``, ``CrossEntropy``, ``MSELoss``,
``BinaryCrossEntropy`` and ``ConvTranspose2d`` runs on the same inputs
(numpy, seeded) and, for ``ConvTranspose2d``, the same weights carried by
``set_states``; outputs and gradients of ``Σ y · w`` compared at float32
atol 1e-5 (rtol 1e-5).  ``conv_transpose2d`` itself is held against the
JAX op at (lo, hi) pads and output padding.  ``Dropout`` draws its mask
from ``jax.random`` in one package and a torch generator in the other, so
it is held by statistics: in both packages the kept share of 200,000
elements passes a χ² test at α = 0.001 (1 degree of freedom, 10.83), kept
elements equal x / (1 − p) exactly, eval is the identity, and in the port
one seed gives one mask and another seed another.

Optimizers (``singa_tpu_torch/opt.py`` against ``singa_tpu/opt.py``):
``RMSProp``, ``AdaGrad``, ``Lion``, and SGD with momentum under
``ExponentialDecay`` and ``StepDecay`` learning rates, five eager steps
of the MLP from one state: losses rtol 1e-5, parameters and optimizer
states atol 2e-5 (Lion's step is ±lr a coordinate: a sign that flips on
a near-zero argument would differ by 2·lr, which these data do not hit),
state names and step counters equal.  The schedules' rates at steps
0 … 12 equal the JAX ones within rtol 1e-6 (float32 ``pow``).
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU: tests/conftest.py)
import torch

from singa_tpu import autograd as jautograd
from singa_tpu import device as jdevice
from singa_tpu import layer as jlayer
from singa_tpu import opt as jopt
from singa_tpu import tensor as jtensor
from singa_tpu.models.mlp import MLP as JMLP
from singa_tpu.ops import conv as jconv
from singa_tpu_torch import autograd, device, layer, opt, tensor
from singa_tpu_torch.models.mlp import MLP
from singa_tpu_torch.ops import conv

ATOL = RTOL = 1e-5
CHI2_CRIT_DF1 = 10.83  # α = 0.001


@pytest.fixture(autouse=True)
def _training():
    prev = jautograd.training
    jautograd.set_training(True)
    yield
    jautograd.set_training(prev)


def _cpu():
    return device.create_cpu_device()


def _rand(rng, shape, kind="std"):
    if kind == "unit":
        return (rng.rand(*shape) * 0.9 + 0.05).astype(np.float32)
    if kind == "probs":
        e = np.exp(rng.randn(*shape))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)
    return rng.randn(*shape).astype(np.float32)


#: name -> (make(module), input (shape, kind) list, call(layer, *xs))
LAYERS = {
    "ReLU6": (lambda L: L.ReLU6(), [((3, 5), "wide")], None),
    "LeakyReLU": (lambda L: L.LeakyReLU(0.2), [((3, 5), "std")], None),
    "Sigmoid": (lambda L: L.Sigmoid(), [((3, 5), "std")], None),
    "Tanh": (lambda L: L.Tanh(), [((3, 5), "std")], None),
    "Gelu": (lambda L: L.Gelu(), [((3, 5), "std")], None),
    "SoftMax": (lambda L: L.SoftMax(axis=0), [((3, 5), "std")], None),
    "Reshape": (lambda L: L.Reshape((5, 3)), [((3, 5), "std")], None),
    "Cat": (lambda L: L.Cat(axis=1), [((3, 2), "std"), ((3, 4), "std")],
            lambda lay, a, b: lay([a, b])),
    "CrossEntropy": (lambda L: L.CrossEntropy(),
                     [((4, 5), "probs"), ((4, 5), "onehot")], None),
    "MSELoss": (lambda L: L.MSELoss(), [((4, 5), "std"), ((4, 5), "std")],
                None),
    "BinaryCrossEntropy": (lambda L: L.BinaryCrossEntropy(),
                           [((4, 5), "unit"), ((4, 5), "unit")], None),
}


def _inputs(name, specs):
    rng = np.random.RandomState(sum(map(ord, name)))
    out = []
    for shape, kind in specs:
        if kind == "wide":
            out.append((rng.randn(*shape) * 4).astype(np.float32))
        elif kind == "onehot":
            out.append(np.eye(shape[-1], dtype=np.float32)[
                rng.randint(0, shape[-1], shape[:-1])])
        else:
            out.append(_rand(rng, shape, kind))
    return out


def _jax_forward_backward(lay, arrays, call, extra=()):
    xs = []
    for a in arrays:
        t = jtensor.from_numpy(a)
        t.requires_grad = t.stores_grad = True
        xs.append(t)
    y = call(lay, *xs) if call else lay(*xs)
    rng = np.random.RandomState(7)
    w = jtensor.from_numpy(np.asarray(rng.randn(*y.shape), np.float32))
    grads = dict(jautograd.backward(jautograd.reduce_sum(
        jautograd.mul(y, w))))
    return (jtensor.to_numpy(y),
            [jtensor.to_numpy(grads[t]) if t in grads else None
             for t in list(xs) + list(extra)])


def _port_forward_backward(lay, arrays, call, extra=()):
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y = call(lay, *xs) if call else lay(*xs)
    rng = np.random.RandomState(7)
    w = torch.from_numpy(np.asarray(rng.randn(*y.shape), np.float32))
    grads = autograd.gradients((y * w).sum())
    return (y.detach().numpy(),
            [grads[t].numpy() if t in grads else None
             for t in list(xs) + list(extra)])


def _close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None and g is None:
            continue
        w = np.zeros_like(g) if w is None else w
        g = np.zeros_like(w) if g is None else g
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {i}")


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    make, specs, call = LAYERS[name]
    arrays = _inputs(name, specs)
    jy, jg = _jax_forward_backward(make(jlayer), arrays, call)
    ty, tg = _port_forward_backward(make(layer), arrays, call)
    np.testing.assert_allclose(ty, jy, rtol=RTOL, atol=ATOL)
    _close(tg, jg, f"{name} gradient")


CONVT = {
    "unet_up_k2_s2": dict(nb_kernels=4, kernel_size=2, stride=2),
    "k3_s2_p1_outpad1": dict(nb_kernels=3, kernel_size=3, stride=2,
                             padding=1, output_padding=1),
    "k3_dilation2_p2": dict(nb_kernels=5, kernel_size=3, dilation=2,
                            padding=2, bias=False),
    "k3_s2_group2": dict(nb_kernels=6, kernel_size=3, stride=2, group=2,
                         padding=1),
}


@pytest.mark.parametrize("name", sorted(CONVT))
def test_conv_transpose2d_layer_matches_jax(name):
    """The JAX weight layout (in, out/group, kH, kW) and padding
    arithmetic: the same weights give the same output shape, values and
    gradients of the input, weight and bias."""
    kw = CONVT[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    x = rng.randn(2, 4, 5, 6).astype(np.float32)
    jl = jlayer.ConvTranspose2d(**kw)
    tl = layer.ConvTranspose2d(**kw)
    jl(jtensor.from_numpy(x))
    tl(torch.from_numpy(x))
    states = {k: rng.randn(*jtensor.to_numpy(v).shape).astype(np.float32)
              for k, v in jl.get_states().items()}
    assert {k: v.shape for k, v in states.items()} == {
        k: tuple(v.shape) for k, v in tl.get_states().items()}
    jl.set_states(states)
    tl.set_states(states)
    jparams = [jl.W] + ([jl.b] if kw.get("bias", True) else [])
    tparams = [tl.W] + ([tl.b] if kw.get("bias", True) else [])
    for p in jparams:
        p.requires_grad = p.stores_grad = True
    jy, jg = _jax_forward_backward(jl, [x], None, extra=jparams)
    ty, tg = _port_forward_backward(tl, [x], None, extra=tparams)
    assert ty.shape == jy.shape
    np.testing.assert_allclose(ty, jy, rtol=RTOL, atol=ATOL)
    _close(tg, jg, f"{name} gradient")


@pytest.mark.parametrize("padding,output_padding,stride", [
    (((1, 0), (0, 2)), (0, 0), (2, 2)),
    (((2, 1), (1, 1)), (1, 0), (2, 1)),
    ((0, 0), (2, 2), (3, 3)),
])
def test_conv_transpose2d_op_asymmetric_pads_match_jax(padding,
                                                       output_padding,
                                                       stride):
    """(lo, hi) pads and output padding, which ``F.conv_transpose2d``
    alone cannot express: the full transposed conv, cropped."""
    rng = np.random.RandomState(5)
    x = rng.randn(1, 2, 4, 5).astype(np.float32)
    w = rng.randn(2, 3, 3, 3).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    want = jtensor.to_numpy(jconv.conv_transpose2d(
        jtensor.from_numpy(x), jtensor.from_numpy(w), jtensor.from_numpy(b),
        stride=stride, padding=padding, output_padding=output_padding))
    got = conv.conv_transpose2d(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        stride=stride, padding=padding, output_padding=output_padding)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------- dropout


def _chi2_kept(kept, n, p):
    keep = 1.0 - p
    return (kept - n * keep) ** 2 / (n * keep * p)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_statistics_match_the_jax_layer(p):
    n = 200_000
    x = np.random.RandomState(1).rand(n).astype(np.float32) + 0.5
    jdevice.get_default_device().SetRandSeed(3)
    jd = jlayer.Dropout(p)
    jy = jtensor.to_numpy(jd(jtensor.from_numpy(x)))
    cpu = _cpu()
    cpu.SetRandSeed(3)
    td = layer.Dropout(p)
    ty = td(torch.from_numpy(x)).numpy()
    for y in (jy, ty):
        kept = y != 0
        assert _chi2_kept(int(kept.sum()), n, p) < CHI2_CRIT_DF1
        np.testing.assert_array_equal(y[kept],
                                      x[kept] / np.float32(1.0 - p))
    td.eval()
    assert np.array_equal(td(torch.from_numpy(x)).numpy(), x)
    jautograd.set_training(False)
    assert np.array_equal(jtensor.to_numpy(jd(jtensor.from_numpy(x))), x)


def test_dropout_is_seeded_in_the_port():
    x = torch.ones(10_000)
    cpu = _cpu()
    d = layer.Dropout(0.3)
    masks = []
    for seed in (4, 4, 5):
        cpu.SetRandSeed(seed)
        masks.append(d(x) != 0)
    assert torch.equal(masks[0], masks[1])
    assert not torch.equal(masks[0], masks[2])


# -------------------------------------------------------------- optimizers


SCHEDULES = {
    "exponential": (lambda m: m.ExponentialDecay(0.1, 3, 0.5), 0),
    "exponential_staircase": (lambda m: m.ExponentialDecay(
        0.2, 4, 0.7, staircase=True), 0),
    "step": (lambda m: m.StepDecay(0.1, 5, gamma=0.3), 0),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_rate_at_each_step_equals_the_jax_one(name):
    make = SCHEDULES[name][0]
    js, ts = make(jopt), make(opt)
    for step in range(13):
        want = float(np.asarray(js(np.float32(step))))
        got = ts(torch.tensor(float(step)))
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), want, rtol=1e-6,
                                   err_msg=f"step {step}")


def test_a_schedule_is_taken_and_a_constant_stays_a_float():
    """``_as_scheduler`` takes every schedule (it raised for all but a
    constant before); a constant costs no device op."""
    sched = opt.ExponentialDecay(0.1, 2, 0.5)
    assert opt._as_scheduler(sched) is sched
    assert opt._as_scheduler(0.3)(torch.tensor(7.0)) == 0.3
    sgd = opt.SGD(lr=opt.StepDecay(0.1, 2), momentum=opt.ExponentialDecay(
        0.9, 10, 0.9), weight_decay=opt.Constant(1e-4))
    assert sgd.state_slots == ("momentum",)


OPTIMIZERS = {
    "rmsprop": lambda m: m.RMSProp(lr=0.01, rho=0.8, weight_decay=1e-3),
    "adagrad": lambda m: m.AdaGrad(lr=0.05, weight_decay=1e-3),
    "lion": lambda m: m.Lion(lr=1e-3, beta_1=0.8, beta_2=0.95,
                             weight_decay=0.1),
    "sgd_exponential_decay": lambda m: m.SGD(
        lr=m.ExponentialDecay(0.1, 2, 0.5), momentum=0.9,
        weight_decay=1e-4),
    "sgd_step_decay_nesterov": lambda m: m.SGD(
        lr=m.StepDecay(0.2, 2, gamma=0.5), momentum=0.8, nesterov=True),
    "adam_exponential_decay": lambda m: m.Adam(
        lr=m.ExponentialDecay(0.01, 3, 0.8, staircase=True)),
}
SLOTS = {"rmsprop": ("sq",), "adagrad": ("accum",), "lion": ("m",),
         "sgd_exponential_decay": ("momentum",),
         "sgd_step_decay_nesterov": ("momentum",),
         "adam_exponential_decay": ("m", "v")}


def _mlp_pair(make_opt, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(16, 6).astype(np.float32)
    y = rng.randint(0, 4, 16).astype(np.int32)
    jm = JMLP(data_size=6, perceptron_size=8, num_classes=4)
    jm.set_optimizer(make_opt(jopt))
    jm.compile([jtensor.from_numpy(x)], is_train=True, use_graph=False)
    tm = MLP(data_size=6, perceptron_size=8, num_classes=4)
    tm.set_optimizer(make_opt(opt))
    tm.compile([tensor.from_numpy(x, _cpu())], is_train=True,
               use_graph=False)
    tm.set_states({k: jtensor.to_numpy(v) for k, v in
                   jm.get_states().items()})
    return jm, tm, x, y


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_steps_match_jax(name):
    jm, tm, x, y = _mlp_pair(OPTIMIZERS[name])
    for step in range(5):
        _, jl = jm(jtensor.from_numpy(x), jtensor.from_numpy(y))
        _, tl = tm(tensor.from_numpy(x, _cpu()), tensor.from_numpy(y, _cpu()))
        np.testing.assert_allclose(tl.item(), float(jtensor.to_numpy(jl)),
                                   rtol=1e-5, err_msg=f"loss, step {step}")
    for k, v in jm.get_states().items():
        np.testing.assert_allclose(tm.get_states()[k].detach().numpy(),
                                   jtensor.to_numpy(v), atol=2e-5,
                                   err_msg=k)
    js, ts = jm.optimizer.get_states(), tm.optimizer.get_states()
    assert set(js) == set(ts)
    assert float(ts["__step_counter__"]) == float(
        js["__step_counter__"]) == 5.0
    for k, v in js.items():
        np.testing.assert_allclose(ts[k], v, atol=2e-5, err_msg=k)
        if k != "__step_counter__":
            assert k.rpartition(":")[2] in SLOTS[name]
    assert tm.optimizer.state_slots == SLOTS[name]
