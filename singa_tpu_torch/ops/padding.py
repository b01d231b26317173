"""ONNX ``auto_pad`` resolution shared by conv and pooling (a copy of
``singa_tpu/ops/padding.py``, which the port may not import).

SAME_UPPER/SAME_LOWER pads depend on the input size and the stride, not
only the kernel: ``out = ceil(in / stride)`` and ``total = max(0,
(out-1)*stride + eff_kernel - in)``, split low/high with the odd element
going to the end (SAME_UPPER) or the beginning (SAME_LOWER).
"""

from __future__ import annotations


def same_pads(in_size, kernel, stride, dilation=None, lower=False):
    """Per-spatial-dim (lo, hi) explicit pads for ONNX SAME auto_pad."""
    if dilation is None:
        dilation = (1,) * len(kernel)
    pairs = []
    for i, k, s, d in zip(in_size, kernel, stride, dilation):
        eff = d * (k - 1) + 1
        out = -(-int(i) // int(s))  # ceil division
        total = max(0, (out - 1) * s + eff - int(i))
        lo = total // 2
        hi = total - lo
        pairs.append((hi, lo) if lower else (lo, hi))
    return tuple(pairs)


def as_pairs(padding):
    """Normalize ``padding`` — per-dim ints or explicit (lo, hi) pairs —
    to a tuple of (lo, hi) pairs."""
    return tuple(tuple(p) if isinstance(p, (tuple, list)) else (int(p), int(p))
                 for p in padding)


def resolve(pad_mode, padding, in_size, kernel, stride, dilation=None):
    """Resolve (pad_mode, padding) to explicit (lo, hi) pairs."""
    if pad_mode in ("SAME", "SAME_UPPER", "SAME_LOWER"):
        return same_pads(in_size, kernel, stride, dilation,
                         lower=pad_mode == "SAME_LOWER")
    if pad_mode == "VALID":
        return tuple((0, 0) for _ in kernel)
    return as_pairs(padding)
