"""The ops GPT-2 and ResNet training use (counterpart of
``singa_tpu/autograd.py``).

Torch autograd takes the place of SINGA's tape: each op is a plain
function on ``torch.Tensor`` with the JAX package's semantics (dtype
rules under amp included), and ``backward(loss)`` keeps SINGA's
generator contract, yielding ``(param, grad)`` for every leaf tensor that
requires a gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import amp

__all__ = [
    "backward", "matmul", "add_bias", "add", "mul", "gelu", "relu",
    "layer_norm", "embedding",
    "softmax_cross_entropy", "dropout", "repeat_kv", "reshape",
    "transpose", "flatten", "reduce_mean",
]


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


# --------------------------------------------------------------------- ops


def matmul(a, b):
    """``a @ b`` with the amp cast of both inputs (``autograd.py:446``)."""
    return torch.matmul(*amp.cast_in(a, b))


def add_bias(x, b, axis=0):
    """Bias add; the bias is cast to x's dtype so bf16 activations stay
    bf16 under amp (``autograd.py:453-459``)."""
    b = b.to(x.dtype)
    return x + (b if axis == 0 else b[:, None])


def add(a, b):
    return a + b


def mul(a, b):
    return a * b


def relu(x):
    return F.relu(x)


def gelu(x, approximate=True):
    """GELU; the tanh approximation by default, as ``jax.nn.gelu``."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def layer_norm(x, scale, bias, eps=1e-12):
    """LayerNorm over the last axis with float32 statistics; the result
    takes x's dtype (``autograd.py:707-719``)."""
    y = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(),
                     eps)
    return y.to(x.dtype)


def embedding(ids, W):
    """Row gather ``W[ids]``; W's gradient is a scatter-add."""
    return F.embedding(ids.long(), W)


def repeat_kv(x, repeats):
    """GQA K/V broadcast: repeat (B, H_kv, S, D) heads ``repeats`` times
    along axis 1, element-interleaved (K/V head i serves query heads
    ``[i·repeats, (i+1)·repeats)``)."""
    return torch.repeat_interleave(x, repeats, dim=1)


def reshape(x, shape):
    return x.reshape(tuple(int(s) for s in shape))


def transpose(x, shape):
    """Permute axes (SINGA names the permutation ``shape``)."""
    return x.permute(*shape)


def flatten(x, axis=1):
    """Collapse the dims from ``axis`` on: ``(prod(shape[:axis]), -1)``."""
    lead = 1
    for s in x.shape[:axis]:
        lead *= int(s)
    return x.reshape(lead, -1)


def reduce_mean(x, axes=None, keepdims=False):
    """Mean over ``axes`` (all axes when None), in x's dtype."""
    if axes is None:
        axes = tuple(range(x.dim()))
    return torch.mean(x, dim=tuple(axes), keepdim=bool(keepdims))


class _SoftMaxCrossEntropy(torch.autograd.Function):
    """Mean over rows of CE(softmax(x), t) in float32, with the JAX
    package's hand-written VJP ``dx = dy·(p − onehot)/N``
    (``autograd.py:593-608``).  A label of −1 (or any label outside
    ``[0, V)``) gives a zero one-hot row: no loss, and — as in the
    reference's VJP — a gradient of ``p/N`` on that row."""

    @staticmethod
    def forward(ctx, x, t):
        logp = torch.log_softmax(x.float(), dim=-1)
        lab = t.reshape(-1).long()
        rows = torch.nonzero((lab >= 0) & (lab < x.shape[-1])).reshape(-1)
        cols = lab[rows]
        ctx.save_for_backward(logp, rows, cols)
        ctx.x_dtype = x.dtype
        return -logp[rows, cols].sum() / x.shape[0]

    @staticmethod
    def backward(ctx, dy):
        logp, rows, cols = ctx.saved_tensors
        scale = dy / logp.shape[0]
        dx = logp.exp() * scale
        dx[rows, cols] -= scale
        return dx.to(ctx.x_dtype), None


def softmax_cross_entropy(x, t):
    """Fused softmax + cross-entropy over (N, V) logits and (N,) integer
    labels, float32 regardless of amp."""
    return _SoftMaxCrossEntropy.apply(x, t)


def dropout(x, ratio=0.5, training=True, generator=None):
    """Inverted dropout: keep with probability ``1 − ratio`` and scale by
    ``1/(1 − ratio)``.  The mask is drawn from ``generator`` (default: the
    generator of the device x lies on).  Identity when not training."""
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
