"""Parameter initializers (counterpart of ``singa_tpu/initializer.py``).

Each fills a tensor in place, drawing from an explicit
``torch.Generator`` on the tensor's device (a ``Device``'s
``generator``).  The values differ from the JAX package's for the same
seed; parity tests carry the weights across instead
(``model.Model.set_states``).
"""

from __future__ import annotations

import math

import torch

__all__ = ["uniform", "gaussian", "xavier", "constant", "zeros", "ones"]


@torch.no_grad()
def uniform(t: torch.Tensor, low=0.0, high=1.0, generator=None):
    return t.uniform_(low, high, generator=generator)


@torch.no_grad()
def gaussian(t: torch.Tensor, mean=0.0, std=0.01, generator=None):
    return t.normal_(mean, std, generator=generator)


def xavier(t: torch.Tensor, generator=None):
    """Glorot uniform for a (fan_in, fan_out) weight."""
    fan_in, fan_out = t.shape
    a = math.sqrt(6.0 / (fan_in + fan_out))
    return uniform(t, -a, a, generator=generator)


@torch.no_grad()
def constant(t: torch.Tensor, value=0.0):
    return t.fill_(value)


def zeros(t: torch.Tensor):
    return constant(t, 0.0)


def ones(t: torch.Tensor):
    return constant(t, 1.0)
