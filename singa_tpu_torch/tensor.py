"""Tensors (counterpart of ``singa_tpu/tensor.py``).

The port's tensors are plain ``torch.Tensor``s and its parameters plain
``nn.Parameter``s: this module keeps only what the SINGA example scripts
call: the ``Tensor((batch, ...), dev)`` placeholder that
``Model.compile`` takes (a zero-filled ``torch.Tensor``, not a class of
its own), ``from_numpy``/``to_numpy`` and the dtype names.  The JAX
module's other functions are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from . import device as device_module

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
int32 = torch.int32
int64 = torch.int64

__all__ = ["Tensor", "from_numpy", "to_numpy", "float16", "bfloat16",
           "float32", "int32", "int64"]


def _torch_device(device):
    if device is None:
        device = device_module.get_default_device()
    if isinstance(device, device_module.Device):
        return device.torch_device
    return torch.device(device)


def Tensor(shape=(), device=None, dtype=float32) -> torch.Tensor:
    """SINGA's ``Tensor(shape, device)`` placeholder, as the example
    scripts pass it to ``Model.compile``: a zero-filled ``torch.Tensor``
    on ``device`` (default: the default device, the GPU)."""
    return torch.zeros(tuple(shape), dtype=dtype, device=_torch_device(device))


def from_numpy(np_array, device=None) -> torch.Tensor:
    """Copy a numpy array onto ``device`` (default: the default device,
    which is the GPU).  ``device`` is a singa ``Device``, a
    ``torch.device`` or a device string."""
    return torch.from_numpy(np.ascontiguousarray(np_array)).to(
        _torch_device(device))


def to_numpy(t) -> np.ndarray:
    """Copy a tensor to the host; the array never shares the tensor's
    memory.  bf16 comes back as float32 (numpy has no bfloat16)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.float().cpu().numpy()
    return t.cpu().numpy().copy() if t.device.type == "cpu" \
        else t.cpu().numpy()
