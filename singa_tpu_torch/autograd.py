"""Autograd ops (counterpart of ``singa_tpu/autograd.py``).

Torch autograd takes the place of SINGA's tape: each op is a plain
function on ``torch.Tensor`` with the JAX package's semantics (dtype
rules under amp included), differentiable through torch autograd; where
the reference's gradient differs from torch's, the op is a
``torch.autograd.Function`` with the reference's VJP
(``_SoftMaxCrossEntropy``).  ``backward(loss)`` keeps SINGA's generator
contract, yielding ``(param, grad)`` for every leaf tensor that requires
a gradient, and ``gradients(y)`` collects it into a dict.

``training`` is SINGA's tape switch.  ``set_training(False)`` turns
torch's grad mode off in the calling thread, so ops record nothing (the
reference records no tape then), and the functional ``dropout`` is the
identity unless told otherwise; ``set_training(True)`` turns both on.
Layers and models read their own ``Module.training``, which
``Model.train``/``eval`` set, not this flag.

The reference's tape internals (``Operation``, ``Dummy``,
``infer_dependency``, ``_Func``, ``_op``) and its export flag
(``set_exporting``) come with the ONNX slice.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from . import amp

__all__ = [
    "set_training", "backward", "gradients", "checkpoint_op",
    "relu", "leakyrelu", "elu", "selu", "gelu", "repeat_kv", "sigmoid",
    "tanh", "softplus", "softsign", "relu6", "swish", "hardsigmoid",
    "abs", "exp", "log", "sqrt", "square", "sign", "sin", "cos",
    "negative", "reciprocal", "clip", "add", "sub", "mul", "div", "pow",
    "mul_scalar", "minimum", "maximum", "matmul", "add_bias", "gemm",
    "reshape", "flatten", "transpose", "cat", "concat", "split", "squeeze",
    "unsqueeze", "gather", "mean", "reduce_mean", "reduce_sum", "sum",
    "softmax", "log_softmax", "cross_entropy", "softmax_cross_entropy",
    "mse_loss", "binary_cross_entropy", "nll_loss", "dropout", "identity",
    "erf", "cast", "equal", "greater", "less", "where_op", "layer_norm",
    "embedding",
]

#: SINGA's tape switch (module docstring)
training = False


def set_training(flag: bool):
    """Set ``training`` and torch's grad mode in this thread."""
    global training
    training = bool(flag)
    torch.set_grad_enabled(training)


# ---------------------------------------------------------------- backward


def _leaves(loss: torch.Tensor) -> list:
    """Leaf tensors requiring grad that ``loss`` depends on, in the order
    a depth-first walk of its graph meets them."""
    out, seen = [], set()
    stack = [loss.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)  # AccumulateGrad
        if var is not None:
            out.append(var)
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return out


def backward(loss: torch.Tensor, dy=None):
    """Yield ``(param, grad)`` for every leaf that requires grad and that
    ``loss`` depends on (SINGA's ``autograd.backward`` generator).  The
    gradients are computed in one ``torch.autograd.grad`` pass and then
    yielded; ``param.grad`` is left untouched."""
    if loss.grad_fn is None:
        return
    leaves = _leaves(loss)
    if dy is None:
        dy = torch.ones_like(loss)
    grads = torch.autograd.grad(loss, leaves, dy, allow_unused=True)
    for p, g in zip(leaves, grads):
        if g is not None:
            yield p, g


def gradients(y, dy=None):
    """Run backward and return ``{param: grad}``."""
    return {p: g for p, g in backward(y, dy)}


def checkpoint_op(fn, *xs, _name=None, **params):
    """``fn(*xs, **params)`` recomputed in backward instead of keeping its
    intermediates (``torch.utils.checkpoint``): memory traded for
    FLOPs."""
    return torch.utils.checkpoint.checkpoint(
        lambda *a: fn(*a, **params), *xs, use_reentrant=False)


# ------------------------------------------------------------ activations


def relu(x):
    return F.relu(x)


def leakyrelu(x, a=0.01):
    return F.leaky_relu(x, a)


def elu(x, alpha=1.0):
    return F.elu(x, alpha)


def selu(x):
    return F.selu(x)


def gelu(x, approximate=True):
    """GELU; the tanh approximation by default, as ``jax.nn.gelu``."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def repeat_kv(x, repeats):
    """GQA K/V broadcast: repeat (B, H_kv, S, D) heads ``repeats`` times
    along axis 1, element-interleaved (K/V head i serves query heads
    ``[i·repeats, (i+1)·repeats)``)."""
    return torch.repeat_interleave(x, repeats, dim=1)


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def softplus(x):
    return F.softplus(x)


def softsign(x):
    return F.softsign(x)


def relu6(x):
    return F.relu6(x)


def swish(x):
    return F.silu(x)


def hardsigmoid(x, alpha=0.2, gamma=0.5):
    """``clip(alpha·x + gamma, 0, 1)`` (ONNX's HardSigmoid)."""
    return torch.clamp(alpha * x + gamma, 0, 1)


# ------------------------------------------------------------ elementwise


def abs(x):  # noqa: A001
    return torch.abs(x)


def exp(x):
    return torch.exp(x)


def log(x):
    return torch.log(x)


def sqrt(x):
    return torch.sqrt(x)


def square(x):
    return torch.square(x)


def sign(x):
    return torch.sign(x)


def sin(x):
    return torch.sin(x)


def cos(x):
    return torch.cos(x)


def negative(x):
    return torch.neg(x)


def reciprocal(x):
    return torch.reciprocal(x)


def clip(x, min=None, max=None):  # noqa: A002
    return torch.clamp(x, min, max)


def add(a, b):
    return a + b


def sub(a, b):
    return a - b


def mul(a, b):
    return a * b


def div(a, b):
    return a / b


def pow(a, b):  # noqa: A001
    return torch.pow(a, b)


def mul_scalar(a, s):
    """``a · s`` for a Python scalar ``s``."""
    return a * float(s)


def minimum(a, b):
    return torch.minimum(a, b)


def maximum(a, b):
    return torch.maximum(a, b)


def erf(x):
    return torch.erf(x)


def _torch_dtype(to):
    if isinstance(to, torch.dtype):
        return to
    if str(to) in ("bfloat16", "bf16"):
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(to))).dtype


def cast(x, to):
    """``x`` as dtype ``to`` (a torch dtype, or a numpy dtype or name)."""
    return x.to(_torch_dtype(to))


def equal(a, b):
    return (a == b).float()


def greater(a, b):
    return (a > b).float()


def less(a, b):
    return (a < b).float()


def where_op(cond, a, b):
    return torch.where(cond != 0, a, b)


def identity(x):
    return x.view_as(x)


# ---------------------------------------------------- linear algebra, shape


def matmul(a, b):
    """``a @ b`` with the amp cast of both inputs (``autograd.py:446``)."""
    return torch.matmul(*amp.cast_in(a, b))


def add_bias(x, b, axis=0):
    """Bias add; the bias is cast to x's dtype so bf16 activations stay
    bf16 under amp (``autograd.py:453-459``)."""
    b = b.to(x.dtype)
    return x + (b if axis == 0 else b[:, None])


def gemm(A, B, C=None, alpha=1.0, beta=1.0, transA=False, transB=False):
    """ONNX Gemm: ``alpha·op(A)·op(B) + beta·C``, the amp cast on every
    input."""
    a, b = amp.cast_in(A, B)
    a = a.T if transA else a
    b = b.T if transB else b
    y = alpha * torch.matmul(a, b)
    if C is not None:
        y = y + beta * amp.cast_in(C)
    return y


def reshape(x, shape):
    return x.reshape(tuple(int(s) for s in shape))


def transpose(x, shape=None):
    """Permute axes (SINGA names the permutation ``shape``; None reverses
    them)."""
    if shape is None:
        shape = tuple(range(x.dim() - 1, -1, -1))
    return x.permute(*shape)


def flatten(x, axis=1):
    """Collapse the dims from ``axis`` on: ``(prod(shape[:axis]), -1)``."""
    lead = 1
    for s in x.shape[:axis]:
        lead *= int(s)
    return x.reshape(lead, -1)


def cat(xs, axis=0):
    return torch.cat(list(xs), dim=axis)


concat = cat


def split(x, axis, parts):
    """Sizes ``parts`` along ``axis`` -> a tuple of tensors."""
    return tuple(torch.split(x, [int(p) for p in parts], dim=axis))


def squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    return x.squeeze(tuple(axis) if isinstance(axis, (list, tuple))
                     else axis)


def unsqueeze(x, axis):
    """New size-1 axes at the positions ``axis`` of the output (one int or
    several), as ``jnp.expand_dims``."""
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else (axis,)
    n = x.dim() + len(ax)
    for a in sorted(a % n for a in ax):
        x = x.unsqueeze(a)
    return x


def gather(x, axis, indices):
    """``jnp.take(x, indices, axis)`` for host indices (negative ones
    count from the end)."""
    axis = axis % x.dim()
    idx = np.asarray(indices, dtype=np.int64)
    idx = np.where(idx < 0, idx + x.shape[axis], idx)
    flat = torch.from_numpy(idx.reshape(-1)).to(x.device)
    y = torch.index_select(x, axis, flat)
    return y.reshape(tuple(x.shape[:axis]) + idx.shape
                     + tuple(x.shape[axis + 1:]))


# -------------------------------------------------------------- reductions


def _sum_list(vs):
    out = vs[0]
    for v in vs[1:]:
        out = out + v
    return out


def sum(*xs):  # noqa: A001
    """Elementwise sum of several tensors (SINGA's ``autograd.sum``)."""
    return _sum_list(xs)


def mean(*xs):
    """Elementwise mean of several tensors (SINGA's ``Mean``)."""
    return _sum_list(xs) / float(len(xs))


def reduce_mean(x, axes=None, keepdims=False):
    """Mean over ``axes`` (all axes when None), in x's dtype."""
    if axes is None:
        axes = tuple(range(x.dim()))
    return torch.mean(x, dim=tuple(axes), keepdim=bool(keepdims))


def reduce_sum(x, axes=None, keepdims=False):
    """Sum over ``axes`` (all axes when None), in x's dtype."""
    if axes is None:
        axes = tuple(range(x.dim()))
    return torch.sum(x, dim=tuple(axes), keepdim=bool(keepdims))


def softmax(x, axis=1):
    """Softmax over ``axis`` (SINGA's default: 1, for 2-D logits)."""
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=1):
    return torch.log_softmax(x, dim=axis)


# ------------------------------------------------------------------ losses


def _to_one_hot(t, logits_shape):
    """``t`` as float32 one-hot rows over the last axis of
    ``logits_shape``, or ``t`` itself (as float32) if it already has that
    shape.  A label outside ``[0, V)`` gives a zero row, as
    ``jax.nn.one_hot``; made by comparison, so no op syncs the device."""
    if t.dim() == len(logits_shape) and tuple(t.shape) == tuple(logits_shape):
        return t.float()
    classes = torch.arange(logits_shape[-1], device=t.device)
    return (t.long()[..., None] == classes).float()


def cross_entropy(p, t):
    """SINGA's CrossEntropy over probabilities ``p`` (after a softmax)
    and one-hot or integer targets: ``-Σ t·log(p + 1e-10) / N``.  The
    target takes no gradient."""
    t1h = _to_one_hot(t.detach(), p.shape)
    return -(t1h * torch.log(p + 1e-10)).sum() / p.shape[0]


def mse_loss(x, t):
    return torch.mean(torch.square(x - t))


def binary_cross_entropy(p, t):
    eps = 1e-7
    return -torch.mean(t * torch.log(p + eps)
                       + (1 - t) * torch.log(1 - p + eps))


def nll_loss(logp, t):
    """``-Σ onehot(t)·logp / N``."""
    t1h = _to_one_hot(t.detach(), logp.shape)
    return -(t1h * logp).sum() / logp.shape[0]


class _SoftMaxCrossEntropy(torch.autograd.Function):
    """Mean over rows of CE(softmax(x), t) in float32, with the JAX
    package's hand-written VJP ``dx = dy·(p − onehot)/N``
    (``autograd.py:593-608``).  A label of −1 (or any label outside
    ``[0, V)``) gives a zero one-hot row: no loss, and — as in the
    reference's VJP — a gradient of ``p/N`` on that row.  Invalid rows
    are masked rather than selected, so no op has a data-dependent shape
    and the step can be captured in a CUDA graph."""

    @staticmethod
    def forward(ctx, x, t):
        logp = torch.log_softmax(x.float(), dim=-1)
        lab = t.reshape(-1).long()
        valid = (lab >= 0) & (lab < x.shape[-1])
        cols = lab.clamp(0, x.shape[-1] - 1)[:, None]
        picked = logp.gather(1, cols)[:, 0]
        ctx.save_for_backward(logp, cols, valid)
        ctx.x_dtype = x.dtype
        return -torch.where(valid, picked, 0.0).sum() / x.shape[0]

    @staticmethod
    def backward(ctx, dy):
        logp, cols, valid = ctx.saved_tensors
        scale = dy / logp.shape[0]
        dx = logp.exp() * scale
        dx.scatter_add_(1, cols, (-scale * valid.float())[:, None])
        return dx.to(ctx.x_dtype), None


def softmax_cross_entropy(x, t):
    """Fused softmax + cross-entropy over (N, V) logits and (N,) integer
    labels, float32 regardless of amp."""
    return _SoftMaxCrossEntropy.apply(x, t)


# ------------------------------------------------------------------- other


def dropout(x, ratio=0.5, training=None, generator=None):
    """Inverted dropout: keep with probability ``1 − ratio`` and scale by
    ``1/(1 − ratio)``; the identity when not training (``training``:
    default, the module flag).  The mask is drawn from ``generator``
    (default: the generator of the device x lies on, which a captured
    training step registers with its CUDA graph, so each replay draws a
    fresh mask)."""
    if training is None:
        training = globals()["training"]
    if not training or ratio == 0.0:
        return x
    if generator is None:
        from .device import device_of

        generator = device_of(x).generator
    keep = 1.0 - float(ratio)
    mask = torch.empty(x.shape, device=x.device).bernoulli_(
        keep, generator=generator).bool()
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))


def layer_norm(x, scale, bias, eps=1e-12):
    """LayerNorm over the last axis with float32 statistics; the result
    takes x's dtype (``autograd.py:707-719``)."""
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(),
                     eps)
    return y.to(x.dtype)


def embedding(ids, W):
    """Row gather ``W[ids]``; W's gradient is a scatter-add."""
    return F.embedding(ids.long(), W)
