"""Convolution (counterpart of ``singa_tpu/ops/conv.py:22-72``
``conv2d``).

One ``F.conv2d`` in NCHW/OIHW, the JAX package's layout, so weights
carry across unchanged.  Asymmetric (lo, hi) pads go through ``F.pad``
first; symmetric pads go to the conv.
Under amp both inputs are cast to the compute dtype, as the JAX op
casts before ``lax.conv_general_dilated``.  No Pallas kernel computes
this op (XLA generated it), so cuDNN runs it here.

Other spatial ranks (the JAX op takes any, for ONNX imports) and
``conv_transpose2d`` are not ported yet.
"""

from __future__ import annotations

import torch.nn.functional as F

from .. import amp
from .padding import resolve as _resolve_padding

__all__ = ["conv2d"]


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
    x, W = amp.cast_in(x, W)
    if all(lo == hi for lo, hi in pads):
        sym = tuple(lo for lo, _ in pads)
    else:
        # F.pad lists the last dim first
        x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
        sym = (0, 0)
    y = F.conv2d(x, W, None, stride, sym, dilation, int(group))
    if b is not None:
        y = y + amp.cast_in(b).reshape(1, -1, 1, 1)
    return y


def _pair(v):
    if isinstance(v, (tuple, list)):
        if len(v) != 2:
            raise ValueError(f"expected 2 values, got {v}")
        return tuple(int(s) for s in v)
    return (int(v), int(v))
