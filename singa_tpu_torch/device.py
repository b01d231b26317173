"""Devices (counterpart of ``singa_tpu/device.py``).

A singa ``Device`` wraps a ``torch.device`` and owns an explicit
``torch.Generator`` on it: the generator stands in for the JAX package's
per-device PRNG key, so parameter init and dropout draw from the device
they run on, and ``SetRandSeed`` makes them reproducible.  A captured
training step registers the generator with its CUDA graph, so every
replay advances it as an eager step would.

Entry points run on the GPU.  ``get_default_device()`` is the first CUDA
device and raises when no GPU is present; it never falls back to the
CPU.  The CPU is used only when the caller asks for it
(``create_cpu_device()``), as the tests do.
"""

from __future__ import annotations

import threading

import torch

__all__ = [
    "Device", "CppCPU", "CudaGPU", "create_cpu_device", "create_cuda_gpu",
    "create_cuda_gpu_on", "get_default_device", "set_default_device",
    "device_of",
]

_lock = threading.Lock()


class Device:
    """Placement + graph flag + random generator."""

    def __init__(self, torch_device: torch.device):
        self.torch_device = torch.device(torch_device)
        self.graph_enabled = False
        self.generator = torch.Generator(device=self.torch_device)
        self.generator.seed()

    def __repr__(self):
        return f"<{type(self).__name__} {self.torch_device}>"

    def SetRandSeed(self, seed: int):
        self.generator.manual_seed(int(seed))

    def EnableGraph(self, enable: bool):
        """Graph mode for models compiled on this device: their training
        steps are captured as CUDA graphs and replayed (``graphs.py``,
        ``model.Model.compile``).  ``Model.compile(use_graph=...)`` sets
        it."""
        self.graph_enabled = bool(enable)


class CppCPU(Device):
    """Host CPU device; only ever used when asked for."""

    def __init__(self):
        super().__init__(torch.device("cpu"))


class CudaGPU(Device):
    """One CUDA device.  Raises when PyTorch sees no GPU."""

    def __init__(self, dev_id: int = 0):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; singa_tpu_torch runs on the "
                "GPU and does not fall back to the CPU (ask for the CPU "
                "explicitly with device.create_cpu_device())")
        n = torch.cuda.device_count()
        if not 0 <= dev_id < n:
            raise ValueError(f"CUDA device {dev_id} out of range "
                             f"(device_count={n})")
        super().__init__(torch.device("cuda", dev_id))


_default_device: Device | None = None
_device_cache: dict = {}


def _cached(kind, dev_id, ctor):
    with _lock:
        key = (kind, dev_id)
        if key not in _device_cache:
            _device_cache[key] = ctor()
        return _device_cache[key]


def create_cpu_device() -> CppCPU:
    return _cached("cpu", -1, CppCPU)


def create_cuda_gpu(set_default: bool = False) -> CudaGPU:
    return create_cuda_gpu_on(0, set_default)


def create_cuda_gpu_on(dev_id: int, set_default: bool = False) -> CudaGPU:
    dev = _cached("cuda", dev_id, lambda: CudaGPU(dev_id))
    if set_default:
        set_default_device(dev)
    return dev


def get_default_device() -> Device:
    """The default device: CUDA device 0 unless ``set_default_device``
    chose another.  Raises when no GPU is present."""
    global _default_device
    if _default_device is None:
        dev = create_cuda_gpu_on(0)
        with _lock:
            if _default_device is None:
                _default_device = dev
    return _default_device


def set_default_device(dev: Device):
    global _default_device
    _default_device = dev


def device_of(t: torch.Tensor) -> Device:
    """The singa ``Device`` that owns tensor ``t``'s placement."""
    d = t.device
    if d.type == "cpu":
        return create_cpu_device()
    if d.type == "cuda":
        return create_cuda_gpu_on(d.index or 0)
    raise ValueError(f"unsupported device {d}")
