"""2-D pooling (counterpart of ``singa_tpu/ops/pooling.py:20-49``), NCHW.

Max pooling pads with −inf; average pooling divides by the whole window,
padding included (``count_include_pad=True``), as the JAX op's
``reduce_window`` sum over the window size does.  Symmetric pads that
PyTorch's pooling takes (at most half the window) go to the pooling
call; any other (lo, hi) pads are applied with ``F.pad`` first.
"""

from __future__ import annotations

import torch.nn.functional as F

from .padding import resolve as _resolve_padding

__all__ = ["pooling2d"]


def pooling2d(x, kernel, stride, padding=(0, 0), is_max=True,
              pad_mode="NOTSET"):
    """``padding`` is per-dim symmetric ints or explicit (lo, hi) pairs;
    SAME modes are resolved ONNX-style from input size and stride."""
    kernel, stride = tuple(kernel), tuple(stride)
    pads = _resolve_padding(pad_mode, padding, tuple(x.shape[2:]), kernel,
                            stride)
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, kernel)):
        sym = tuple(lo for lo, _ in pads)
    else:
        fill = float("-inf") if is_max else 0.0
        x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi],
                  value=fill)
        sym = (0,) * len(kernel)
    if is_max:
        return F.max_pool2d(x, kernel, stride, sym)
    return F.avg_pool2d(x, kernel, stride, sym, count_include_pad=True)
