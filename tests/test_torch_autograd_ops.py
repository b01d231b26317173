"""The port's autograd ops (``singa_tpu_torch/autograd.py``) against the
JAX package's (``singa_tpu/autograd.py``), forward and gradient, the
counterpart of ``tests/test_autograd.py`` and ``tests/test_operations.py``.

Each case makes its inputs with numpy from a seed and runs the op in both
packages; the loss is ``Σ y · w`` for a fixed random ``w`` (over every
output of a multi-output op), so every element's gradient counts.  The
JAX side runs eagerly on its tape (``autograd.set_training(True)``), the
port's on torch autograd.  An input the JAX tape gives no gradient (a
target, a condition) and one torch gives none are compared as zeros.
float32, atol 1e-5 and rtol 1e-5: both packages evaluate the same
formulas on O(1) values, in other orders; bf16 results (``cast``) are
compared exactly, as both round to nearest even.  Ops with integer or
boolean meaning (``sign``, the comparisons, a cast to int32) are compared
forward only.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU: tests/conftest.py)
import torch

from singa_tpu import autograd as jautograd
from singa_tpu import tensor as jtensor
from singa_tpu_torch import autograd, device

ATOL = RTOL = 1e-5
SHAPE = (3, 4)


def std(rng, *s):
    return rng.randn(*s).astype(np.float32)


def pos(rng, *s):
    return (rng.rand(*s) + 0.5).astype(np.float32)


def unit(rng, *s):
    return (rng.rand(*s) * 0.9 + 0.05).astype(np.float32)


def wide(rng, *s):
    return (rng.randn(*s) * 4).astype(np.float32)


def small_ints(rng, *s):
    return rng.randint(-1, 2, s).astype(np.float32)


def labels(rng, *s):
    return rng.randint(0, s[-1], s[:-1]).astype(np.int32)


def onehot(rng, *s):
    return np.eye(s[-1], dtype=np.float32)[rng.randint(0, s[-1], s[:-1])]


def probs(rng, *s):
    e = np.exp(rng.randn(*s))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def log_probs(rng, *s):
    return np.log(probs(rng, *s)).astype(np.float32)


#: name -> (call(module, *inputs), input makers, forward only[, shapes])
OPS = {
    "relu": (lambda A, x: A.relu(x), [std], False),
    "leakyrelu": (lambda A, x: A.leakyrelu(x, 0.1), [std], False),
    "elu": (lambda A, x: A.elu(x, 0.7), [std], False),
    "selu": (lambda A, x: A.selu(x), [std], False),
    "gelu_tanh": (lambda A, x: A.gelu(x), [std], False),
    "gelu_erf": (lambda A, x: A.gelu(x, approximate=False), [std], False),
    "sigmoid": (lambda A, x: A.sigmoid(x), [std], False),
    "tanh": (lambda A, x: A.tanh(x), [std], False),
    "softplus": (lambda A, x: A.softplus(x), [wide], False),
    "softsign": (lambda A, x: A.softsign(x), [std], False),
    "relu6": (lambda A, x: A.relu6(x), [wide], False),
    "swish": (lambda A, x: A.swish(x), [std], False),
    "hardsigmoid": (lambda A, x: A.hardsigmoid(x, 0.3, 0.4), [wide], False),
    "abs": (lambda A, x: A.abs(x), [std], False),
    "exp": (lambda A, x: A.exp(x), [std], False),
    "log": (lambda A, x: A.log(x), [pos], False),
    "sqrt": (lambda A, x: A.sqrt(x), [pos], False),
    "square": (lambda A, x: A.square(x), [std], False),
    "sign": (lambda A, x: A.sign(x), [std], True),
    "sin": (lambda A, x: A.sin(x), [std], False),
    "cos": (lambda A, x: A.cos(x), [std], False),
    "negative": (lambda A, x: A.negative(x), [std], False),
    "reciprocal": (lambda A, x: A.reciprocal(x), [pos], False),
    "clip": (lambda A, x: A.clip(x, -0.5, 0.7), [std], False),
    "clip_min_only": (lambda A, x: A.clip(x, -0.5), [std], False),
    "add": (lambda A, a, b: A.add(a, b), [std, std], False),
    "sub": (lambda A, a, b: A.sub(a, b), [std, std], False),
    "mul": (lambda A, a, b: A.mul(a, b), [std, std], False),
    "div": (lambda A, a, b: A.div(a, b), [std, pos], False),
    "pow": (lambda A, a, b: A.pow(a, b), [pos, std], False),
    "mul_scalar": (lambda A, x: A.mul_scalar(x, 2.5), [std], False),
    "minimum": (lambda A, a, b: A.minimum(a, b), [std, std], False),
    "maximum": (lambda A, a, b: A.maximum(a, b), [std, std], False),
    "erf": (lambda A, x: A.erf(x), [std], False),
    "cast_bf16": (lambda A, x: A.cast(x, "bfloat16"), [std], False),
    "cast_int32": (lambda A, x: A.cast(x, np.int32), [wide], True),
    "equal": (lambda A, a, b: A.equal(a, b), [small_ints, small_ints], True),
    "greater": (lambda A, a, b: A.greater(a, b), [small_ints, small_ints],
                True),
    "less": (lambda A, a, b: A.less(a, b), [small_ints, small_ints], True),
    "where_op": (lambda A, c, a, b: A.where_op(c, a, b),
                 [small_ints, std, std], False),
    "identity": (lambda A, x: A.identity(x), [std], False),
    "matmul": (lambda A, a, b: A.matmul(a, A.transpose(b, (1, 0))),
               [std, std], False),
    "gemm_transB": (lambda A, a, b, c: A.gemm(a, b, c, alpha=2.0, beta=0.5,
                                              transB=True),
                    [std, std, std], False, [(3, 4), (5, 4), (3, 5)]),
    "gemm_transA": (lambda A, a, b: A.gemm(a, b, alpha=0.5, transA=True),
                    [std, std], False),
    "add_bias": (lambda A, x, b: A.add_bias(x, b), [std, std], False,
                 [(3, 4), (4,)]),
    "reshape": (lambda A, x: A.reshape(x, (2, 6)), [std], False),
    "transpose": (lambda A, x: A.transpose(x, (1, 0)), [std], False),
    "flatten": (lambda A, x: A.flatten(A.reshape(x, (3, 2, 2)), 1), [std],
                False),
    "cat": (lambda A, a, b: A.cat([a, b], axis=1), [std, std], False),
    "split": (lambda A, x: A.split(x, 1, [1, 3]), [std], False),
    "squeeze": (lambda A, x: A.squeeze(A.reshape(x, (3, 1, 4)), 1), [std],
                False),
    "unsqueeze": (lambda A, x: A.unsqueeze(x, [0, 3]), [std], False),
    "gather": (lambda A, x: A.gather(x, 1, [[3, 0], [-1, 1]]), [std],
               False),
    "mean_of_three": (lambda A, a, b, c: A.mean(a, b, c), [std, std, std],
                      False),
    "sum_of_three": (lambda A, a, b, c: A.sum(a, b, c), [std, std, std],
                     False),
    "reduce_mean": (lambda A, x: A.reduce_mean(x, axes=(1,), keepdims=True),
                    [std], False),
    "reduce_sum": (lambda A, x: A.reduce_sum(x, axes=(0,)), [std], False),
    "reduce_sum_all": (lambda A, x: A.reduce_sum(x), [std], False),
    "softmax": (lambda A, x: A.softmax(x, axis=1), [std], False),
    "log_softmax": (lambda A, x: A.log_softmax(x, axis=0), [std], False),
    "cross_entropy_labels": (lambda A, p, t: A.cross_entropy(p, t),
                             [probs, labels], False),
    "cross_entropy_onehot": (lambda A, p, t: A.cross_entropy(p, t),
                             [probs, onehot], False),
    "softmax_cross_entropy": (lambda A, x, t: A.softmax_cross_entropy(x, t),
                              [std, labels], False),
    "mse_loss": (lambda A, a, b: A.mse_loss(a, b), [std, std], False),
    "binary_cross_entropy": (lambda A, p, t: A.binary_cross_entropy(p, t),
                             [unit, unit], False),
    "nll_loss": (lambda A, lp, t: A.nll_loss(lp, t), [log_probs, labels],
                 False),
}


@pytest.fixture(autouse=True)
def _training():
    """The JAX tape records only in training; leave both flags as found."""
    prev = jautograd.training
    jautograd.set_training(True)
    yield
    jautograd.set_training(prev)
    autograd.set_training(False)
    torch.set_grad_enabled(True)


def _inputs(name):
    rng = np.random.RandomState(sum(map(ord, name)))
    makers = OPS[name][1]
    shapes = OPS[name][3] if len(OPS[name]) > 3 else [SHAPE] * len(makers)
    return [m(rng, *s) for m, s in zip(makers, shapes)]


def _outputs(y):
    return list(y) if isinstance(y, (list, tuple)) else [y]


def _jax_run(name, arrays, fwd_only):
    call = OPS[name][0]
    xs = []
    for a in arrays:
        t = jtensor.from_numpy(a)
        if a.dtype == np.float32:
            t.requires_grad = t.stores_grad = True
        xs.append(t)
    outs = [np.asarray(jtensor.to_numpy(y)) for y in
            _outputs(call(jautograd, *xs))]
    if fwd_only:
        return outs, None
    ys = _outputs(call(jautograd, *xs))
    rng = np.random.RandomState(7)
    loss = None
    for y in ys:
        w = jtensor.from_numpy(np.asarray(rng.randn(*y.shape), np.float32))
        term = jautograd.reduce_sum(jautograd.mul(
            jautograd.cast(y, np.float32), w))
        loss = term if loss is None else jautograd.add(loss, term)
    got = dict(jautograd.backward(loss))
    grads = [np.asarray(jtensor.to_numpy(got[t])) if t in got else None
             for t in xs]
    return outs, grads


def _port_run(name, arrays, fwd_only):
    call = OPS[name][0]
    cpu = device.create_cpu_device().torch_device
    xs = [torch.from_numpy(a).to(cpu).requires_grad_(
        a.dtype == np.float32 and not fwd_only) for a in arrays]
    ys = _outputs(call(autograd, *xs))
    outs = [y.detach().float().numpy() if y.dtype == torch.bfloat16
            else y.detach().numpy() for y in ys]
    if fwd_only:
        return outs, None
    rng = np.random.RandomState(7)
    loss = 0
    for y in ys:
        w = torch.from_numpy(np.asarray(rng.randn(*y.shape), np.float32))
        loss = loss + (y.float() * w).sum()
    got = autograd.gradients(loss)
    return outs, [got[t].numpy() if t in got else None for t in xs]


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_forward_and_gradient_match_jax(name):
    fwd_only = OPS[name][2]
    arrays = _inputs(name)
    j_out, j_grads = _jax_run(name, arrays, fwd_only)
    t_out, t_grads = _port_run(name, arrays, fwd_only)
    assert len(j_out) == len(t_out)
    for a, b in zip(j_out, t_out):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a.astype(b.dtype), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{name} forward")
    if fwd_only:
        return
    for i, (jg, tg, a) in enumerate(zip(j_grads, t_grads, arrays)):
        if a.dtype != np.float32:
            continue
        jg = np.zeros_like(a) if jg is None else jg
        tg = np.zeros_like(a) if tg is None else tg
        np.testing.assert_allclose(tg, jg, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} gradient of input {i}")


def test_every_reference_op_has_a_case():
    """The ported functions of ``singa_tpu/autograd.py`` that a script
    calls are all held above (the tape internals are not ported)."""
    for fn in ("leakyrelu", "elu", "selu", "sigmoid", "tanh", "softplus",
               "softsign", "relu6", "swish", "hardsigmoid", "abs", "exp",
               "log", "sqrt", "square", "sign", "sin", "cos", "negative",
               "reciprocal", "clip", "sub", "div", "pow", "mul_scalar",
               "minimum", "maximum", "erf", "cast", "equal", "greater",
               "less", "where_op", "identity", "gemm", "cat", "split",
               "squeeze", "unsqueeze", "gather", "mean", "reduce_sum",
               "sum", "softmax", "log_softmax", "cross_entropy", "mse_loss",
               "binary_cross_entropy", "nll_loss"):
        assert any(n == fn or n.startswith(fn + "_") for n in OPS), fn
        assert callable(getattr(autograd, fn)), fn


def test_gradients_returns_param_to_grad():
    """``gradients(y)`` is ``backward``'s pairs as a dict, as in
    ``test_autograd.py::test_backward_shared_param_accumulates``."""
    w = torch.tensor([1.0, 2.0], requires_grad=True)
    loss = autograd.reduce_sum(autograd.add(autograd.mul(w, w), w))
    grads = autograd.gradients(loss)
    assert list(grads) == [w]
    np.testing.assert_allclose(grads[w].numpy(), [3.0, 5.0])


def test_backward_yields_the_layer_nearest_the_loss_first():
    """``test_autograd.py::test_backward_generator_yields_incrementally``."""
    x = torch.ones(2, 3)
    w1 = torch.ones(3, 4, requires_grad=True)
    w2 = torch.ones(4, 2, requires_grad=True)
    loss = autograd.reduce_sum(autograd.matmul(autograd.matmul(x, w1), w2))
    order = [p for p, _ in autograd.backward(loss)]
    assert order[0] is w2 and order[1] is w1


def test_set_training_off_records_no_gradient():
    """``test_autograd.py::test_no_tape_when_eval`` and
    ``test_dropout_train_eval``'s eval half: with the switch off an op
    records nothing and the functional dropout is the identity."""
    x = torch.ones(2, 2, requires_grad=True)
    autograd.set_training(False)
    y = autograd.relu(x)
    assert y.grad_fn is None
    assert list(autograd.backward(autograd.reduce_sum(y))) == []
    ones = torch.ones(1000)
    assert torch.equal(autograd.dropout(ones, 0.4), ones)
    autograd.set_training(True)
    assert autograd.relu(x).grad_fn is not None
    kept = autograd.dropout(ones, 0.4) != 0
    assert 0.45 < kept.float().mean().item() < 0.75


def test_checkpoint_op_gives_the_plain_gradients():
    """``checkpoint_op`` recomputes in backward: the same values and
    gradients as the op it wraps."""
    rng = np.random.RandomState(3)
    a = torch.from_numpy(std(rng, 3, 4)).requires_grad_()
    b = torch.from_numpy(std(rng, 4, 5)).requires_grad_()

    def body(u, v, scale):
        return autograd.tanh(autograd.matmul(u, v)) * scale

    y1 = autograd.checkpoint_op(body, a, b, scale=2.0)
    y2 = body(a, b, 2.0)
    assert torch.equal(y1, y2)
    g1 = autograd.gradients(autograd.reduce_sum(autograd.square(y1)))
    g2 = autograd.gradients(autograd.reduce_sum(autograd.square(y2)))
    for t in (a, b):
        torch.testing.assert_close(g1[t], g2[t], rtol=0, atol=1e-6)
