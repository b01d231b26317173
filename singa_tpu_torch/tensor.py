"""Tensors (counterpart of ``singa_tpu/tensor.py``).

The port's tensors are plain ``torch.Tensor``s and its parameters plain
``nn.Parameter``s, so this module is functions on tensors, not a wrapper
class: the ``Tensor((batch, ...), dev)`` placeholder that
``Model.compile`` takes (a zero-filled ``torch.Tensor``),
``from_numpy``/``to_numpy``, the dtype names (``float32`` ...) and the
SINGA proto-enum names (``kFloat32`` ...), and the JAX module's
module-level functions: arithmetic (``add``, ``sub``, ``eltwise_mult``,
``div``, the GEMM ``mult``, ``axpy``), the row/column ops of 2-D
matrices, reductions, ``softmax``, ``einsum``/``tensordot``/``matmul``,
shape functions, comparisons (0/1 float32 tensors, as SINGA's LT/GT
kernels return), ``where``, ``clip``, ``argmax``/``argmin``, the
constructors, the random fills and the copies.

Where the JAX module rebinds a ``Tensor``'s array (its "in-place" SINGA
idioms: the ``ret=``/``out=`` arguments, ``axpy``, ``add_row`` and
friends, ``SetValue``, ``copy_from_numpy``, ``gaussian(self, ...)``),
the function here writes into the given tensor and returns it.  The
random fills draw from an explicit ``torch.Generator`` (the device's
``generator`` for one a ``Device`` made); the draws are not
``jax.random``'s.
"""

from __future__ import annotations

import numpy as np
import torch

from . import device as device_module

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
uint8 = torch.uint8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
bool_ = torch.bool

# SINGA proto-enum names, for scripts written against the reference
kFloat16 = float16
kFloat32 = float32
kInt = int32
kInt32 = int32
kInt64 = int64
kChar = int8
kUChar = uint8
kDouble = float64

_NAMED = {"float16": float16, "bfloat16": bfloat16, "float32": float32,
          "float64": float64, "int8": int8, "uint8": uint8,
          "int16": int16, "int32": int32, "int64": int64, "bool": bool_}

__all__ = [
    "Tensor", "from_numpy", "to_numpy", "to_host", "from_raw_tensor",
    "sizeof", "float16", "bfloat16", "float32", "float64", "int8", "uint8",
    "int16", "int32", "int64", "bool_", "kFloat16", "kFloat32", "kInt",
    "kInt32", "kInt64", "kChar", "kUChar", "kDouble",
    "abs", "exp", "log", "sigmoid", "sign", "sqrt", "square", "tanh",
    "ceil", "floor", "round", "relu", "pow", "sum", "mean", "average",
    "reshape", "transpose", "squeeze", "concatenate", "stack", "repeat",
    "tile", "add", "sub", "eltwise_mult", "div", "mult", "matmul",
    "einsum", "tensordot", "axpy", "softmax", "lt", "le", "gt", "ge",
    "maximum", "minimum", "clip", "argmax", "argmin", "where",
    "add_column", "add_row", "mult_column", "mult_row", "div_column",
    "div_row", "sum_columns", "sum_rows", "gaussian", "uniform",
    "bernoulli", "zeros_like", "ones_like", "zeros", "ones", "eye",
    "arange", "set_value", "copy_from_numpy", "copy_data_to_from"]


def _torch_device(device):
    if device is None:
        device = device_module.get_default_device()
    if isinstance(device, device_module.Device):
        return device.torch_device
    return torch.device(device)


def _dtype(dt):
    """A dtype given as a torch dtype, a name or a numpy dtype."""
    if dt is None:
        return float32
    if isinstance(dt, torch.dtype):
        return dt
    if isinstance(dt, str) and dt in _NAMED:
        return _NAMED[dt]
    return _NAMED[np.dtype(dt).name]


def Tensor(shape=(), device=None, dtype=float32) -> torch.Tensor:
    """SINGA's ``Tensor(shape, device)`` placeholder, as the example
    scripts pass it to ``Model.compile``: a zero-filled ``torch.Tensor``
    on ``device`` (default: the default device, the GPU)."""
    return torch.zeros(tuple(shape), dtype=_dtype(dtype),
                       device=_torch_device(device))


def from_numpy(np_array, device=None) -> torch.Tensor:
    """Copy a numpy array onto ``device`` (default: the default device,
    which is the GPU).  ``device`` is a singa ``Device``, a
    ``torch.device`` or a device string."""
    arr = np.asarray(np_array)
    # ascontiguousarray makes a 0-d array 1-d: keep the true shape
    return torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape)).to(
        _torch_device(device))


def to_numpy(t) -> np.ndarray:
    """Copy a tensor to the host; the array never shares the tensor's
    memory.  bf16 comes back as float32 (numpy has no bfloat16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().cpu().numpy()
    return t.cpu().numpy().copy() if t.device.type == "cpu" \
        else t.cpu().numpy()


def to_host(t) -> torch.Tensor:
    """A host copy of ``t``; ``t`` keeps its device (the reference's
    module-level ``to_host`` clones, then moves the clone)."""
    return t.detach().to("cpu", copy=True)


def from_raw_tensor(arr, device=None) -> torch.Tensor:
    """A tensor of ``arr`` (a tensor, an array or a scalar) on ``device``
    (default: where ``arr`` is, or the default device for host data)."""
    if isinstance(arr, torch.Tensor):
        return arr if device is None else arr.to(_torch_device(device))
    return torch.as_tensor(np.asarray(arr), device=_torch_device(device))


def sizeof(dtype) -> int:
    """Bytes an element of ``dtype`` takes."""
    return torch.empty((), dtype=_dtype(dtype)).element_size()


# -- elementwise -----------------------------------------------------------

abs = torch.abs  # noqa: A001 - the reference module's names
exp = torch.exp
log = torch.log
sigmoid = torch.sigmoid
sign = torch.sign
sqrt = torch.sqrt
square = torch.square
tanh = torch.tanh
ceil = torch.ceil
floor = torch.floor
round = torch.round  # noqa: A001 - half to even, as jnp.round
relu = torch.relu


def _into(r, out):
    """``r``, written into ``out`` when one is given (the reference's
    ``ret=``/``out=`` arguments)."""
    if out is None:
        return r
    out.copy_(r)
    return out


def pow(t, x, out=None):  # noqa: A001
    return _into(torch.pow(t, x), out)


def sum(t, axis=None, out=None):  # noqa: A001
    return _into(t.sum() if axis is None else t.sum(dim=axis), out)


def mean(t, axis=None):
    return t.mean() if axis is None else t.mean(dim=axis)


def average(t, axis=None):
    return mean(t, axis)


def reshape(t, shape):
    return t.reshape(tuple(shape))


def transpose(t, axes=None):
    """Axes reversed (``axes=None``) or permuted, as ``jnp.transpose``."""
    if axes is None:
        axes = tuple(range(t.dim() - 1, -1, -1))
    return t.permute(*axes)


def squeeze(t, axis=None):
    return t.squeeze() if axis is None else t.squeeze(axis)


def concatenate(tensors, axis=0):
    return torch.cat(list(tensors), dim=axis)


def stack(tensors, axis=0):
    return torch.stack(list(tensors), dim=axis)


def repeat(t, repeats, axis=None):
    """``jnp.repeat``: each element ``repeats`` times; the flattened
    tensor when ``axis`` is None."""
    if axis is None:
        return torch.repeat_interleave(t.reshape(-1), repeats)
    return torch.repeat_interleave(t, repeats, dim=axis)


def tile(t, reps):
    return torch.tile(t, tuple(reps) if not isinstance(reps, int)
                      else (reps,))


def add(lhs, rhs, ret=None):
    return _into(lhs + rhs, ret)


def sub(lhs, rhs, ret=None):
    return _into(lhs - rhs, ret)


def eltwise_mult(lhs, rhs, ret=None):
    return _into(lhs * rhs, ret)


def div(lhs, rhs, ret=None):
    return _into(lhs / rhs, ret)


def mult(A, B, C=None, alpha=1.0, beta=0.0):
    """GEMM: ``alpha * A @ B + beta * C``, written into ``C`` when one is
    given (the reference's ``Mult``, cuBLAS GEMM in ``tensor_math_cuda.h``)."""
    out = alpha * torch.matmul(A, B)
    if C is not None and beta != 0.0:
        out = out + beta * C
    return _into(out, C)


def matmul(A, B):
    return torch.matmul(A, B)


def einsum(spec, *tensors):
    return torch.einsum(spec, *tensors)


def tensordot(A, B, axes=2):
    return torch.tensordot(A, B, dims=axes)


def axpy(alpha, x, y):
    """``y += alpha * x`` in place (BLAS axpy); returns ``y``."""
    y.add_(x, alpha=alpha)
    return y


def softmax(t, axis=-1, out=None):
    return _into(torch.softmax(t, dim=axis), out)


def _flag(c):
    return c.to(torch.float32)


def lt(t, x):
    return _flag(t < x)


def le(t, x):
    return _flag(t <= x)


def gt(t, x):
    return _flag(t > x)


def ge(t, x):
    return _flag(t >= x)


def _as(t, like):
    return t if isinstance(t, torch.Tensor) else torch.as_tensor(
        t, dtype=like.dtype, device=like.device)


def maximum(a, b):
    return torch.maximum(a, _as(b, a))


def minimum(a, b):
    return torch.minimum(a, _as(b, a))


def clip(t, lo, hi):
    return torch.clamp(t, lo, hi)


def argmax(t, axis=-1):
    return torch.argmax(t, dim=axis)


def argmin(t, axis=-1):
    return torch.argmin(t, dim=axis)


def where(cond, a, b):
    """``a`` where ``cond`` is nonzero, else ``b``."""
    return torch.where(cond != 0, a, _as(b, a))


# -- row/column ops of 2-D matrices, in place --------------------------------

def add_column(v, M):
    """``M[:, j] += v`` for every column j (v has M's row count)."""
    M.add_(v[:, None])
    return M


def add_row(v, M):
    M.add_(v[None, :])
    return M


def mult_column(v, M):
    M.mul_(v[:, None])
    return M


def mult_row(v, M):
    M.mul_(v[None, :])
    return M


def div_column(v, M):
    M.div_(v[:, None])
    return M


def div_row(v, M):
    M.div_(v[None, :])
    return M


def sum_columns(M):
    """The sum of M's columns: one value a row."""
    return M.sum(dim=1)


def sum_rows(M):
    """The sum of M's rows: one value a column."""
    return M.sum(dim=0)


# -- random fills, into the given tensor ------------------------------------

def gaussian(mean, std, t, generator=None):
    """Fill ``t`` with ``mean + std * N(0, 1)`` draws from ``generator``
    (float32 draws cast to ``t``'s dtype, as the JAX method does)."""
    z = torch.randn(t.shape, generator=generator,
                    device=t.device, dtype=torch.float32)
    t.copy_(mean + std * z)
    return t


def uniform(low, high, t, generator=None):
    """Fill ``t`` with U[low, high) draws from ``generator``."""
    u = torch.rand(t.shape, generator=generator,
                   device=t.device, dtype=torch.float32)
    t.copy_(low + (high - low) * u)
    return t


def bernoulli(p, t, generator=None):
    """Fill ``t`` with 0/1 draws that are 1 with probability ``p``."""
    u = torch.rand(t.shape, generator=generator,
                   device=t.device, dtype=torch.float32)
    t.copy_(u < p)
    return t


# -- constructors ------------------------------------------------------------

def zeros_like(t):
    return torch.zeros_like(t)


def ones_like(t):
    return torch.ones_like(t)


def zeros(shape, dtype=float32, device=None):
    return Tensor(shape, device, dtype)


def ones(shape, dtype=float32, device=None):
    return torch.ones(tuple(shape), dtype=_dtype(dtype),
                      device=_torch_device(device))


def eye(n, dtype=float32, device=None):
    return torch.eye(n, dtype=_dtype(dtype), device=_torch_device(device))


def arange(*args, dtype=float32, device=None):
    return torch.arange(*args, dtype=_dtype(dtype),
                        device=_torch_device(device))


# -- copies, into the given tensor -------------------------------------------

def set_value(t, x):
    """Fill ``t`` with the scalar ``x`` (SINGA's ``SetValue``)."""
    t.fill_(x)
    return t


def copy_from_numpy(t, np_array):
    """Copy a numpy array of ``t``'s size into ``t`` (cast to its dtype,
    reshaped to its shape)."""
    arr = np.asarray(np_array)
    if arr.size != t.numel():
        raise ValueError(f"array size {arr.size} != tensor size "
                         f"{t.numel()}")
    t.copy_(torch.from_numpy(np.ascontiguousarray(arr)).reshape(t.shape))
    return t


def copy_data_to_from(dst, src, size=None):
    """Copy ``src`` into ``dst`` (shapes must match; cast to ``dst``'s
    dtype).  ``size`` is the reference's element count, unused: the copy
    is whole, as in the JAX module."""
    if tuple(dst.shape) != tuple(src.shape):
        raise ValueError(f"shape mismatch {tuple(src.shape)} vs "
                         f"{tuple(dst.shape)}")
    dst.copy_(src)
    return dst

