"""Convolution (counterpart of ``singa_tpu/ops/conv.py``: ``conv2d`` and
``conv_transpose2d``).

One ``F.conv2d`` in NCHW/OIHW, the JAX package's layout, so weights
carry across unchanged.  Asymmetric (lo, hi) pads go through ``F.pad``
first; symmetric pads go to the conv.
Under amp both inputs are cast to the compute dtype, as the JAX op
casts before ``lax.conv_general_dilated``.  No Pallas kernel computes
this op (XLA generated it), so cuDNN runs it here.

``conv_transpose2d`` keeps the JAX op's weight layout (C_in, C_out/group,
kH, kW), which is torch's, and its padding arithmetic: an output of
``(in − 1)·stride − lo − hi + (k − 1)·dilation + 1 + output_padding``
per dim, for symmetric or (lo, hi) pads.  Other spatial ranks (the JAX
ops take any, for ONNX imports) are not ported yet.

Both record themselves for export (``Conv2d``, ``ConvTranspose2d``) with
the JAX ops' geometry parameters: ``stride``, ``pads`` (resolved (lo, hi)
pairs), ``dilation``, ``group`` and ``output_padding``.
"""

from __future__ import annotations

import torch.nn.functional as F

from .. import amp
from ..autograd import _op
from .padding import resolve as _resolve_padding

__all__ = ["conv2d", "conv_transpose2d"]


def conv2d(x, W, b=None, stride=1, padding=0, dilation=1, group=1,
           pad_mode="NOTSET"):
    """2-D conv of x (N, C, H, W) with W (O, C/group, kH, kW).
    ``padding`` takes per-dim symmetric ints or explicit (lo, hi) pairs;
    SAME modes are resolved ONNX-style from the input size and stride
    (``ops/padding.py``)."""
    if x.dim() != 4 or W.dim() != 4:
        raise ValueError(f"conv2d takes a 4-D input and weight, got "
                         f"{x.dim()}-D and {W.dim()}-D")
    stride, dilation = _pair(stride), _pair(dilation)
    if not isinstance(padding, (tuple, list)):
        padding = (padding, padding)
    if len(padding) != 2:
        raise ValueError(f"expected 2 padding entries (ints or (lo, hi) "
                         f"pairs), got {padding}")
    pads = _resolve_padding(pad_mode, padding, tuple(x.shape[2:]),
                            tuple(W.shape[2:]), stride, dilation)
    xs = (x, W) if b is None else (x, W, b)
    return _op(_conv2d, *xs, _name="Conv2d", stride=stride,
               pads=tuple(tuple(p) for p in pads), dilation=dilation,
               group=int(group))


def _conv2d(x, W, *b, stride, pads, dilation, group):
    x, W = amp.cast_in(x, W)
    if all(lo == hi for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        # F.pad lists the last dim first
        x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
        sym = (0, 0)
    y = F.conv2d(x, W, None, stride, sym, dilation, group)
    if b:
        y = y + amp.cast_in(b[0]).reshape(1, -1, 1, 1)
    return y


def conv_transpose2d(x, W, b=None, stride=1, padding=0, dilation=1,
                     group=1, output_padding=0):
    """Transposed convolution of x (N, C_in, H, W) with W (C_in,
    C_out/group, kH, kW).  ``padding`` takes per-dim ints or (lo, hi)
    pairs.  Symmetric pads with ``output_padding`` below the stride or
    the dilation go to one ``F.conv_transpose2d``; otherwise the full
    (unpadded) transposed conv is cropped by ``lo`` at the start and by
    ``hi − output_padding`` at the end (a negative crop pads zeros)."""
    if x.dim() != 4 or W.dim() != 4:
        raise ValueError(f"conv_transpose2d takes a 4-D input and weight, "
                         f"got {x.dim()}-D and {W.dim()}-D")
    stride, dilation = _pair(stride), _pair(dilation)
    out_pad = _pair(output_padding)
    if not isinstance(padding, (tuple, list)):
        padding = (padding, padding)
    if len(padding) != 2:
        raise ValueError(f"expected 2 padding entries (ints or (lo, hi) "
                         f"pairs), got {padding}")
    pads = tuple(tuple(int(v) for v in p) if isinstance(p, (tuple, list))
                 else (int(p), int(p)) for p in padding)
    xs = (x, W) if b is None else (x, W, b)
    return _op(_conv_transpose2d, *xs, _name="ConvTranspose2d",
               stride=stride, pads=pads, dilation=dilation,
               group=int(group), output_padding=out_pad)


def _conv_transpose2d(x, W, *b, stride, pads, dilation, group,
                      output_padding):
    x, W = amp.cast_in(x, W)
    if all(lo == hi for lo, hi in pads) and all(
            op < max(s, d)
            for op, s, d in zip(output_padding, stride, dilation)):
        y = F.conv_transpose2d(x, W, None, stride,
                               tuple(lo for lo, _ in pads), output_padding,
                               group, dilation)
    else:
        y = F.conv_transpose2d(x, W, None, stride, 0, 0, group, dilation)
        # F.pad lists the last dim first
        y = F.pad(y, [v for (lo, hi), op in zip(reversed(pads),
                                                reversed(output_padding))
                      for v in (-lo, op - hi)])
    if b:
        y = y + amp.cast_in(b[0]).reshape(1, -1, 1, 1)
    return y


def _pair(v):
    if isinstance(v, (tuple, list)):
        if len(v) != 2:
            raise ValueError(f"expected 2 values, got {v}")
        return tuple(int(s) for s in v)
    return (int(v), int(v))
