"""Mixed precision (counterpart of ``singa_tpu/amp.py``), same policy:

  * parameters stay float32 (master weights; the optimizer updates in
    float32);
  * matrix-product inputs are cast to bf16, so activations leaving a
    matmul are bf16;
  * LayerNorm statistics and the softmax-cross-entropy are computed in
    float32.

Off by default.  ``enable()`` turns it on for every later op: the flag is
read when an op runs.
"""

from __future__ import annotations

import torch

_compute_dtype = None  # None => float32 throughout (policy off)


def enable(on=True):
    """Turn bf16 mixed-precision compute on or off."""
    set_compute_dtype(torch.bfloat16 if on else None)


def set_compute_dtype(dtype):
    global _compute_dtype
    if dtype in (None, "float32", torch.float32):
        _compute_dtype = None
    elif dtype in ("bfloat16", torch.bfloat16):
        _compute_dtype = torch.bfloat16
    elif dtype in ("float16", torch.float16):
        _compute_dtype = torch.float16
    else:
        raise ValueError(f"unsupported compute dtype {dtype!r}")


def param_dtype(activation_dtype):
    """Dtype of a parameter created from an activation of the given dtype:
    under amp, bf16 activations still get float32 master params."""
    if _compute_dtype is not None and activation_dtype == _compute_dtype:
        return torch.float32
    return activation_dtype


def cast_in(*tensors):
    """Cast matmul inputs to the compute dtype (no-op when off).  Integer
    tensors pass through untouched."""
    if _compute_dtype is None:
        return tensors if len(tensors) != 1 else tensors[0]
    out = tuple(
        t.to(_compute_dtype)
        if t is not None and t.is_floating_point() else t
        for t in tensors)
    return out if len(out) != 1 else out[0]
