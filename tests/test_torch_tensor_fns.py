"""The module functions of the port's ``tensor.py`` against the JAX
package's ``singa_tpu/tensor.py`` on the same numpy inputs (made from a
seed).

Each case runs one function (or an in-place SINGA idiom: ``ret=``,
``axpy``, the row/column ops, ``SetValue``, ``copy_from_numpy``) in both
packages, the JAX one on its ``Tensor`` wrapper and the port's on plain
``torch.Tensor``s, and compares the results at atol 1e-6 in float32
(the same shapes; integers exactly).  The random fills draw from a
``torch.Generator`` where the JAX package draws from ``jax.random``, so
they are held to their shape, dtype and moments instead.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU: tests/conftest.py)
import torch

from singa_tpu import tensor as jt
from singa_tpu_torch import device, tensor as tt

ATOL = 1e-6
CPU = device.create_cpu_device()


def _data(seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(a=f(3, 4), b=f(3, 4), c=f(4, 5), m=f(3, 4), v4=f(4),
                v3=f(3) + 2.0, pos=np.abs(f(3, 4)) + 0.1, s=f(1, 3, 1, 4),
                cond=(rng.rand(3, 4) > 0.5).astype(np.float32),
                r=rng.randint(-5, 5, (3, 4)).astype(np.float32),
                h=(rng.rand(3, 4) * 4 - 2).astype(np.float32),
                half=np.asarray([0.5, 1.5, 2.5, -0.5, -1.5], np.float32))


def _unary(name, arg="a"):
    return name, lambda T, d: getattr(T, name)(d[arg])


#: (case name, fn(module, {name: tensor of that module}))
CASES = [
    ("add", lambda T, d: T.add(d["a"], d["b"])),
    ("add_ret", lambda T, d: T.add(d["a"], d["b"], d["m"])),
    ("sub", lambda T, d: T.sub(d["a"], d["b"])),
    ("sub_ret", lambda T, d: T.sub(d["a"], d["b"], d["m"])),
    ("eltwise_mult", lambda T, d: T.eltwise_mult(d["a"], d["b"])),
    ("eltwise_mult_ret", lambda T, d: T.eltwise_mult(d["a"], d["b"],
                                                     d["m"])),
    ("div", lambda T, d: T.div(d["a"], d["pos"])),
    ("div_ret", lambda T, d: T.div(d["a"], d["pos"], d["m"])),
    ("mult_gemm", lambda T, d: T.mult(d["a"], d["c"])),
    ("mult_gemm_into_c", lambda T, d: T.mult(
        d["a"].T if T is jt else d["a"].t(), d["b"], T.from_numpy(
            np.ones((4, 4), np.float32), *(() if T is jt else (CPU,))),
        alpha=0.5, beta=2.0)),
    ("matmul", lambda T, d: T.matmul(d["a"], d["c"])),
    ("einsum", lambda T, d: T.einsum("ij,jk->ik", d["a"], d["c"])),
    ("tensordot", lambda T, d: T.tensordot(d["a"], d["c"], axes=1)),
    ("axpy", lambda T, d: T.axpy(0.5, d["a"], d["m"])),
    ("add_row", lambda T, d: T.add_row(d["v4"], d["m"])),
    ("add_column", lambda T, d: T.add_column(d["v3"], d["m"])),
    ("mult_row", lambda T, d: T.mult_row(d["v4"], d["m"])),
    ("mult_column", lambda T, d: T.mult_column(d["v3"], d["m"])),
    ("div_row", lambda T, d: T.div_row(d["v4"], d["m"])),
    ("div_column", lambda T, d: T.div_column(d["v3"], d["m"])),
    ("sum_rows", lambda T, d: T.sum_rows(d["a"])),
    ("sum_columns", lambda T, d: T.sum_columns(d["a"])),
    ("sum_all", lambda T, d: T.sum(d["a"])),
    ("sum_axis", lambda T, d: T.sum(d["a"], axis=1)),
    ("sum_out", lambda T, d: T.sum(d["a"], 0, d["v4"])),
    ("mean", lambda T, d: T.mean(d["a"])),
    ("mean_axis", lambda T, d: T.mean(d["a"], axis=0)),
    ("average", lambda T, d: T.average(d["a"], axis=1)),
    ("softmax", lambda T, d: T.softmax(d["a"])),
    ("softmax_axis0", lambda T, d: T.softmax(d["a"], axis=0)),
    ("softmax_out", lambda T, d: T.softmax(d["a"], -1, d["m"])),
    ("reshape", lambda T, d: T.reshape(d["a"], (4, 3))),
    ("transpose", lambda T, d: T.transpose(d["s"])),
    ("transpose_axes", lambda T, d: T.transpose(d["s"], (3, 1, 0, 2))),
    ("squeeze", lambda T, d: T.squeeze(d["s"])),
    ("squeeze_axis", lambda T, d: T.squeeze(d["s"], 0)),
    ("tile", lambda T, d: T.tile(d["a"], (2, 3))),
    ("repeat", lambda T, d: T.repeat(d["a"], 2)),
    ("repeat_axis", lambda T, d: T.repeat(d["a"], 3, axis=0)),
    ("concatenate", lambda T, d: T.concatenate([d["a"], d["b"]], axis=1)),
    ("stack", lambda T, d: T.stack([d["a"], d["b"], d["m"]], axis=1)),
    ("where", lambda T, d: T.where(d["cond"], d["a"], d["b"])),
    ("clip", lambda T, d: T.clip(d["a"], -0.5, 0.5)),
    ("pow", lambda T, d: T.pow(d["pos"], 1.7)),
    ("pow_out", lambda T, d: T.pow(d["pos"], 2.0, d["m"])),
    ("maximum", lambda T, d: T.maximum(d["a"], d["b"])),
    ("minimum", lambda T, d: T.minimum(d["a"], d["b"])),
    ("lt", lambda T, d: T.lt(d["a"], 0.1)),
    ("le", lambda T, d: T.le(d["r"], 1.0)),
    ("gt", lambda T, d: T.gt(d["a"], d["b"])),
    ("ge", lambda T, d: T.ge(d["r"], 0.0)),
    ("argmax", lambda T, d: T.argmax(d["a"])),
    ("argmax_axis0", lambda T, d: T.argmax(d["a"], axis=0)),
    ("argmin", lambda T, d: T.argmin(d["a"])),
    _unary("abs"), _unary("exp"), ("log", lambda T, d: T.log(d["pos"])),
    _unary("sigmoid"), _unary("sign", "r"),
    ("sqrt", lambda T, d: T.sqrt(d["pos"])), _unary("square"),
    _unary("tanh"), _unary("ceil", "h"), _unary("floor", "h"),
    _unary("round", "half"), _unary("relu"),
    ("zeros_like", lambda T, d: T.zeros_like(d["a"])),
    ("ones_like", lambda T, d: T.ones_like(d["a"])),
    ("zeros", lambda T, d: T.zeros((2, 3), device=_dev(T))),
    ("ones", lambda T, d: T.ones((2, 3), device=_dev(T))),
    ("eye", lambda T, d: T.eye(4, device=_dev(T))),
    ("arange", lambda T, d: T.arange(1, 7, 2, device=_dev(T))),
    ("arange_int32", lambda T, d: T.arange(5, dtype=T.int32,
                                           device=_dev(T))),
    ("copy_data_to_from", lambda T, d: T.copy_data_to_from(d["m"], d["a"])),
    ("to_host", lambda T, d: T.to_host(d["a"])),
    ("from_raw_tensor", lambda T, d: T.from_raw_tensor(
        np.arange(6, dtype=np.float32).reshape(2, 3), _dev(T))),
    ("set_value", lambda T, d: d["m"].SetValue(3.5) if T is jt
     else T.set_value(d["m"], 3.5)),
    ("copy_from_numpy", lambda T, d: (
        d["m"].copy_from_numpy if T is jt
        else lambda a: T.copy_from_numpy(d["m"], a))(
            np.arange(12, dtype=np.float64).reshape(4, 3))),
]


def _dev(T):
    return None if T is jt else CPU


def _run(T, fn, seed):
    wrap = (jt.from_numpy if T is jt
            else lambda a: torch.from_numpy(np.array(a)))
    out = fn(T, {k: wrap(v) for k, v in _data(seed).items()})
    if T is jt:
        return np.asarray(jt.to_numpy(out) if isinstance(out, jt.Tensor)
                          else out)
    return tt.to_numpy(out)


@pytest.mark.parametrize("name,fn", CASES, ids=[c[0] for c in CASES])
def test_function_matches_jax(name, fn):
    want = _run(jt, fn, seed=len(name))
    got = _run(tt, fn, seed=len(name))
    assert got.shape == want.shape, (got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_dtype_names_and_sizes():
    for name in ("float16", "bfloat16", "float32", "int8", "uint8", "int16",
                 "int32", "int64"):
        assert tt.sizeof(getattr(tt, name)) == jt.sizeof(getattr(jt, name))
        assert tt.sizeof(name) == jt.sizeof(name), name
    for k in ("kFloat16", "kFloat32", "kInt", "kInt32", "kInt64", "kChar",
              "kUChar", "kDouble"):
        assert tt.sizeof(getattr(tt, k)) == jt.sizeof(getattr(jt, k)), k
    assert tt.kInt is torch.int32 and tt.kUChar is torch.uint8


@pytest.mark.parametrize("fill", ["gaussian", "uniform", "bernoulli"])
def test_random_fills_moments(fill):
    """The fills write into the given tensor from the given generator:
    shape and dtype kept, moments those of the distribution (100k draws,
    4 standard errors), and the same generator seed repeats the draw."""
    def draw(seed, dtype=torch.float32):
        t = torch.zeros(400, 250, dtype=dtype)
        g = torch.Generator().manual_seed(seed)
        args = {"gaussian": (1.5, 2.0), "uniform": (-1.0, 3.0),
                "bernoulli": (0.3,)}[fill]
        out = getattr(tt, fill)(*args, t, g)
        assert out is t and t.shape == (400, 250) and t.dtype == dtype
        return t

    x = draw(7).double()
    mean, var = {"gaussian": (1.5, 4.0), "uniform": (1.0, 16 / 12),
                 "bernoulli": (0.3, 0.21)}[fill]
    se = (var / x.numel()) ** 0.5
    assert abs(x.mean().item() - mean) < 4 * se
    assert abs(x.var().item() - var) < 0.05 * var
    if fill == "bernoulli":
        assert set(torch.unique(x).tolist()) == {0.0, 1.0}
    assert torch.equal(draw(7), draw(7))
    assert not torch.equal(draw(7), draw(8))
    assert draw(3, torch.bfloat16).dtype == torch.bfloat16
