"""Spatial batch normalization (counterpart of
``singa_tpu/ops/batchnorm.py:36-129``), NCHW.

Same numerics as the JAX op:

* statistics are float32 reductions over the activation kept in its own
  dtype (bf16 under amp); the mean is removed before squaring (two-pass
  variance), and the variance is the biased one;
* training normalizes by the batch statistics and updates the running
  statistics in place as ``running = momentum·running +
  (1 − momentum)·batch`` (the reference's convention; ``F.batch_norm``
  would use the unbiased variance and the opposite momentum, so it is
  not used);
* eval is ``x·a + b`` with ``a = scale·rsqrt(rv + eps)`` and ``b = bias −
  a·rm``;
* the backward is the JAX op's hand-written VJP (``_bn_train_bwd``):
  activation math in x's dtype, per-channel sums in float32, and only x
  and per-channel vectors saved.

Recorded for export as the JAX op: training as ``BatchNorm2d`` (outputs
y and the batch statistics; ``params`` carry ``eps``, ``momentum`` and
the running-statistic buffers ``rm``/``rv``, which ``sonnx`` writes as
the node's mean and variance), eval as ``BatchNorm2dEval``.  While
exporting, training leaves the running statistics untouched, as the JAX
export's pass is pure.
"""

from __future__ import annotations

import torch

from .. import autograd

__all__ = ["batchnorm2d"]


def _channel(a):
    """(C,) vector -> broadcastable NCHW shape."""
    return a[None, :, None, None]


def _stats(x):
    """Per-channel float32 (mean, biased var) over (N, H, W) and the
    centred activation in x's dtype."""
    m = torch.mean(x, (0, 2, 3), dtype=torch.float32)
    xc = x - _channel(m).to(x.dtype)
    v = torch.mean(torch.square(xc), (0, 2, 3), dtype=torch.float32)
    return m, v, xc


class _BatchNormTrain(torch.autograd.Function):
    """``(y, batch_mean, batch_var)``; only y carries a gradient (the
    statistics feed the running update alone)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        m, v, xc = _stats(x)
        inv = torch.rsqrt(v + eps)
        a = _channel(scale.float() * inv).to(x.dtype)
        y = xc * a + _channel(bias.float()).to(x.dtype)
        ctx.save_for_backward(x, m, inv, scale)
        ctx.mark_non_differentiable(m, v)
        return y, m, v

    @staticmethod
    def backward(ctx, dy, _dm, _dv):
        """``dx = c1·dy + c3·xc + c2`` with per-channel float32
        coefficients; ``dscale = inv·Σ(dy·xc)``, ``dbias = Σdy``."""
        x, m, inv, scale = ctx.saved_tensors
        n = x.shape[0] * x.shape[2] * x.shape[3]
        dy = dy.to(x.dtype)
        xc = x - _channel(m).to(x.dtype)
        sum_dy = torch.sum(dy, (0, 2, 3), dtype=torch.float32)
        sum_dy_xc = torch.sum(dy * xc, (0, 2, 3), dtype=torch.float32)
        s = scale.float()
        c1 = s * inv
        c2 = -c1 * (sum_dy / n)
        c3 = -s * inv ** 3 * (sum_dy_xc / n)
        dx = (dy * _channel(c1).to(x.dtype)
              + xc * _channel(c3).to(x.dtype)
              + _channel(c2).to(x.dtype))
        dscale = (inv * sum_dy_xc).to(scale.dtype)
        dbias = sum_dy.to(scale.dtype)
        return dx, dscale, dbias, None


def batchnorm2d(x, scale, bias, running_mean, running_var, momentum=0.9,
                eps=1e-5, training=True):
    """NCHW spatial BN.  Training: normalize by the batch statistics and
    update ``running_mean``/``running_var`` (float32 buffers) in place.
    Eval: normalize by the running statistics."""
    if training:
        if autograd.exporting:
            y, _, _ = autograd._op(_bn_train, x, scale, bias,
                                   _name="BatchNorm2d", eps=float(eps))
            op = autograd._record.producer[id(y)]
            op.params = {"eps": eps, "momentum": momentum,
                         "rm": running_mean, "rv": running_var}
            return y
        y, bm, bv = _BatchNormTrain.apply(x, scale, bias, float(eps))
        with torch.no_grad():
            running_mean.mul_(momentum).add_((1.0 - momentum) * bm)
            running_var.mul_(momentum).add_((1.0 - momentum) * bv)
        return y
    return autograd._op(_bn_eval, x, scale, bias, running_mean,
                        running_var, _name="BatchNorm2dEval", eps=eps)


def _bn_train(x, scale, bias, eps):
    return _BatchNormTrain.apply(x, scale, bias, eps)


def _bn_eval(x, scale, bias, running_mean, running_var, eps):
    inv = torch.rsqrt(running_var + eps)
    a = _channel(scale * inv).to(x.dtype)
    b = _channel(bias - scale * inv * running_mean)
    return x * a + b.to(x.dtype)
