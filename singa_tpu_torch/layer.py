"""Layers (counterpart of ``singa_tpu/layer.py``).

``Layer`` is an ``nn.Module`` that keeps SINGA's contract: parameters are
created from the first input's shape at the first call (``initialize``),
and ``get_params``/``get_states`` name them hierarchically exactly as the
JAX package does (``GPT2LMHead.transformer.blocks0.attn.q_proj.W``), so
states interchange between the two packages without renaming or
transposes.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import amp, autograd, initializer
from .device import device_of

__all__ = ["Layer", "Linear", "LayerNorm", "Embedding",
           "SoftMaxCrossEntropy", "param_name"]

#: attribute on a parameter holding its hierarchical name
#: (``torch.Tensor.name`` is taken)
_NAME_ATTR = "_singa_name"


def param_name(p):
    """The hierarchical name ``Layer.set_name`` gave parameter ``p``, or
    None."""
    return getattr(p, _NAME_ATTR, None)


def new_param(shape, like: torch.Tensor, dtype=None) -> nn.Parameter:
    """An uninitialized parameter on the device of tensor ``like``."""
    return nn.Parameter(torch.empty(
        tuple(shape), device=like.device,
        dtype=dtype if dtype is not None else torch.float32))


class Layer(nn.Module):
    sep = "."

    def __init__(self):
        super().__init__()
        self.name = type(self).__name__
        self._initialized = False

    def initialize(self, *input, **kwargs):
        """Create parameters from the first input's shapes."""

    def __call__(self, *args, **kwargs):
        if not self._initialized:
            with torch.no_grad():
                self.initialize(*args, **kwargs)
            self._initialized = True
            for a, p in self._parameters.items():  # until set_name renames
                if p is not None and param_name(p) is None:
                    setattr(p, _NAME_ATTR, f"{self.name}{self.sep}{a}")
        return super().__call__(*args, **kwargs)

    # -- naming ------------------------------------------------------------
    def _sublayers(self):
        """``(attr, layer)`` pairs, sorted by attribute; the items of a
        ``ModuleList`` named ``blocks`` become ``blocks0``, ``blocks1``..."""
        out = []
        for attr, val in sorted(self._modules.items()):
            if isinstance(val, nn.ModuleList):
                out.extend((f"{attr}{i}", v) for i, v in enumerate(val))
            elif val is not None:
                out.append((attr, val))
        return out

    def set_name(self, name):
        """Name this layer ``name`` and every parameter below it by its
        hierarchical path."""
        self.name = name
        for a, p in self._parameters.items():
            if p is not None:
                setattr(p, _NAME_ATTR, f"{name}{self.sep}{a}")
        for attr, sub in self._sublayers():
            sub.set_name(f"{name}{self.sep}{attr}")

    # -- params / states ---------------------------------------------------
    def _named_params(self, prefix) -> dict:
        params = {f"{prefix}{self.sep}{a}": p
                  for a, p in sorted(self._parameters.items())
                  if p is not None}
        for attr, sub in self._sublayers():
            params.update(sub._named_params(f"{prefix}{self.sep}{attr}"))
        return params

    def get_params(self) -> dict:
        """``{hierarchical name: parameter}``."""
        return self._named_params(self.name)

    def get_states(self) -> dict:
        """Parameters (the GPT-2 slice has no other layer state)."""
        return self.get_params()

    def set_states(self, states: dict):
        """Copy ``states`` (name -> array or tensor) into the parameters.
        Every name must match exactly: an unknown or missing name raises,
        as does a shape mismatch."""
        own = self.get_states()
        unknown = sorted(set(states) - set(own))
        missing = sorted(set(own) - set(states))
        if unknown or missing:
            raise KeyError(
                f"set_states: unknown names {unknown[:5]} "
                f"({len(unknown)} in all), missing names {missing[:5]} "
                f"({len(missing)} in all); params exist only after "
                f"compile() or a first forward")
        with torch.no_grad():
            for name, t in own.items():
                src = states[name]
                if not isinstance(src, torch.Tensor):
                    src = torch.from_numpy(np.array(src))
                if tuple(src.shape) != tuple(t.shape):
                    raise ValueError(
                        f"set_states: {name} has shape {tuple(src.shape)}, "
                        f"the parameter {tuple(t.shape)}")
                t.copy_(src.to(device=t.device, dtype=t.dtype))


class Linear(Layer):
    """``y = x @ W + b`` with W laid out (in, out) as in the JAX package,
    created at the first call and xavier-initialized."""

    def __init__(self, out_features, bias=True):
        super().__init__()
        self.out_features = int(out_features)
        self.bias = bool(bias)

    def initialize(self, x):
        dt = amp.param_dtype(x.dtype)
        self.W = new_param((x.shape[-1], self.out_features), x, dt)
        initializer.xavier(self.W, generator=device_of(x).generator)
        if self.bias:
            self.b = new_param((self.out_features,), x, dt)
            initializer.zeros(self.b)

    def forward(self, x):
        y = autograd.matmul(x, self.W)
        if self.bias:
            y = autograd.add_bias(y, self.b)
        return y


class LayerNorm(Layer):
    """LayerNorm over the last axis; params ``scale`` and ``bias``."""

    def __init__(self, eps=1e-12):
        super().__init__()
        self.eps = float(eps)

    def initialize(self, x):
        d = x.shape[-1]
        dt = amp.param_dtype(x.dtype)
        self.scale = initializer.ones(new_param((d,), x, dt))
        self.bias = initializer.zeros(new_param((d,), x, dt))

    def forward(self, x):
        return autograd.layer_norm(x, self.scale, self.bias, eps=self.eps)


class Embedding(Layer):
    """Token embedding: (B, S) int ids -> (B, S, dim); float32 table."""

    def __init__(self, vocab_size, embed_dim, std=0.02):
        super().__init__()
        self.vocab_size = int(vocab_size)
        self.embed_dim = int(embed_dim)
        self.std = float(std)

    def initialize(self, ids):
        self.W = new_param((self.vocab_size, self.embed_dim), ids)
        initializer.gaussian(self.W, 0.0, self.std,
                             generator=device_of(ids).generator)

    def forward(self, ids):
        return autograd.embedding(ids, self.W)


class SoftMaxCrossEntropy(Layer):
    def forward(self, x, t):
        return autograd.softmax_cross_entropy(x, t)
