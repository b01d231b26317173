"""singa_tpu_torch — the PyTorch/CUDA port of ``singa_tpu``.

The same SINGA-shaped API (``device``, ``tensor``, ``amp``, ``layer``,
``model``, ``opt``) over PyTorch, with every kernel that ``singa_tpu``
wrote in Pallas for the TPU written by hand for NVIDIA Hopper under
``csrc/``.  The package imports ``torch`` and numpy only: never ``jax``
and nothing of ``singa_tpu``.  Module names mirror ``singa_tpu`` so each
counterpart is easy to find.

Entry points run on the GPU: ``device.get_default_device()`` is CUDA and
raises when no GPU is present.  The CPU is used only when the caller asks
for it (``device.create_cpu_device()``), as the tests do.
"""

from . import config  # noqa: F401
from .config import VERSION as __version__  # noqa: F401

# Submodules are imported by user code (`from singa_tpu_torch import
# tensor, device, layer, model, opt`), as with `from singa import ...`.
