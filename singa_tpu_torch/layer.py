"""Layers (counterpart of ``singa_tpu/layer.py``).

``Layer`` is an ``nn.Module`` that keeps SINGA's contract: parameters are
created from the first input's shape at the first call (``initialize``),
and ``get_params``/``get_states`` name them hierarchically exactly as the
JAX package does (``GPT2LMHead.transformer.blocks0.attn.q_proj.W``), so
states interchange between the two packages without renaming or
transposes.  Non-parameter state (BN running statistics) is a buffer
(``register_state``); ``get_states``/``set_states`` cover it under the
JAX names (``ResNet.layer10.bn1.running_mean``).

Conv, BN and pooling layers keep the JAX package's NCHW layout and call
``ops/conv.py``, ``ops/batchnorm.py`` and ``ops/pooling.py``.
``Dropout`` follows the layer's ``Module.training`` (``Model.train`` /
``eval``), where the JAX layer reads the autograd module's flag.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from . import amp, autograd, initializer
from .device import device_of
from .ops import batchnorm as bn_ops
from .ops import conv as conv_ops
from .ops import pooling as pool_ops

__all__ = ["Layer", "Linear", "LayerNorm", "Embedding", "ReLU", "ReLU6",
           "LeakyReLU", "Sigmoid", "Tanh", "Gelu", "SoftMax", "Flatten",
           "Reshape", "Dropout", "Cat", "Add", "SoftMaxCrossEntropy",
           "CrossEntropy", "MSELoss", "BinaryCrossEntropy", "Conv2d",
           "ConvTranspose2d", "BatchNorm2d", "Pooling2d", "MaxPool2d",
           "AvgPool2d", "GlobalAvgPool2d", "param_name"]

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

    def _named_states(self, prefix) -> dict:
        states = {f"{prefix}{self.sep}{a}": t
                  for own in (self._parameters, self._buffers)
                  for a, t in sorted(own.items()) if t is not None}
        for attr, sub in self._sublayers():
            states.update(sub._named_states(f"{prefix}{self.sep}{attr}"))
        return states

    def get_states(self) -> dict:
        """Parameters and buffers (``register_state``) by hierarchical
        name."""
        return self._named_states(self.name)

    def register_state(self, attr, t: torch.Tensor):
        """Keep ``t`` as persistent non-parameter state (a buffer) under
        ``attr``; ``get_states`` names it like a parameter."""
        self.register_buffer(attr, t)

    def set_states(self, states: dict):
        """Copy ``states`` (name -> array or tensor) into the parameters
        and buffers.
        Every name must match exactly: an unknown or missing name raises,
        as does a shape mismatch."""
        own = self._named_states(self.name)
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


class ReLU(Layer):
    def forward(self, x):
        return autograd.relu(x)


class ReLU6(Layer):
    def forward(self, x):
        return autograd.relu6(x)


class LeakyReLU(Layer):
    def __init__(self, a=0.01):
        super().__init__()
        self.a = a

    def forward(self, x):
        return autograd.leakyrelu(x, self.a)


class Sigmoid(Layer):
    def forward(self, x):
        return autograd.sigmoid(x)


class Tanh(Layer):
    def forward(self, x):
        return autograd.tanh(x)


class Gelu(Layer):
    def forward(self, x):
        return autograd.gelu(x)


class SoftMax(Layer):
    def __init__(self, axis=1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return autograd.softmax(x, self.axis)


class Flatten(Layer):
    def __init__(self, axis=1):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return autograd.flatten(x, self.axis)


class Reshape(Layer):
    def __init__(self, shape):
        super().__init__()
        self.shape = shape

    def forward(self, x):
        return autograd.reshape(x, self.shape)


class Dropout(Layer):
    """Inverted dropout while the layer trains, the identity in eval."""

    def __init__(self, ratio=0.5):
        super().__init__()
        self.ratio = ratio

    def forward(self, x):
        return autograd.dropout(x, self.ratio, training=self.training)


class Cat(Layer):
    def __init__(self, axis=0):
        super().__init__()
        self.axis = axis

    def forward(self, xs):
        return autograd.cat(xs, self.axis)


class Add(Layer):
    def forward(self, a, b):
        return autograd.add(a, b)


class SoftMaxCrossEntropy(Layer):
    def forward(self, x, t):
        return autograd.softmax_cross_entropy(x, t)


class CrossEntropy(Layer):
    def forward(self, p, t):
        return autograd.cross_entropy(p, t)


class MSELoss(Layer):
    def forward(self, x, t):
        return autograd.mse_loss(x, t)


class BinaryCrossEntropy(Layer):
    def forward(self, p, t):
        return autograd.binary_cross_entropy(p, t)


def _pair(v):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


class Conv2d(Layer):
    """NCHW convolution; W is (out, in/group, kH, kW), created at the
    first call with the JAX layer's He-style init: gaussian with std
    ``sqrt(2 / (in/group·kH·kW + out))``, drawn from the device's
    generator."""

    def __init__(self, nb_kernels, kernel_size, stride=1, padding=0,
                 dilation=1, group=1, bias=True, pad_mode="NOTSET",
                 activation="NOTSET"):
        super().__init__()
        self.nb_kernels = int(nb_kernels)
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.dilation = _pair(dilation)
        self.group = int(group)
        self.bias = bool(bias)
        self.pad_mode = pad_mode
        self.activation = activation

    def initialize(self, x):
        in_channels = x.shape[1]
        if in_channels % self.group:
            raise ValueError(f"{in_channels} input channels do not split "
                             f"into {self.group} groups")
        w_shape = (self.nb_kernels, in_channels // self.group) \
            + self.kernel_size
        dt = amp.param_dtype(x.dtype)
        self.W = new_param(w_shape, x, dt)
        std = math.sqrt(2.0 / (w_shape[1] * np.prod(self.kernel_size)
                               + self.nb_kernels))
        initializer.gaussian(self.W, 0.0, std,
                             generator=device_of(x).generator)
        if self.bias:
            self.b = initializer.zeros(new_param((self.nb_kernels,), x, dt))

    def forward(self, x):
        y = conv_ops.conv2d(
            x, self.W, self.b if self.bias else None, stride=self.stride,
            padding=self.padding, dilation=self.dilation, group=self.group,
            pad_mode=self.pad_mode)
        if self.activation == "RELU":
            y = autograd.relu(y)
        return y


class ConvTranspose2d(Layer):
    """NCHW transposed convolution; W is (in, out/group, kH, kW), the JAX
    layer's (and torch's) layout, created at the first call: gaussian
    with std ``sqrt(2 / (out/group·kH·kW + in))``, drawn from the
    device's generator."""

    def __init__(self, nb_kernels, kernel_size, stride=1, padding=0,
                 dilation=1, group=1, bias=True, output_padding=0):
        super().__init__()
        self.nb_kernels = int(nb_kernels)
        self.kernel_size = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.dilation = _pair(dilation)
        self.group = int(group)
        self.bias = bool(bias)
        self.output_padding = _pair(output_padding)

    def initialize(self, x):
        in_channels = x.shape[1]
        if in_channels % self.group or self.nb_kernels % self.group:
            raise ValueError(f"{in_channels} input and {self.nb_kernels} "
                             f"output channels do not split into "
                             f"{self.group} groups")
        w_shape = (in_channels, self.nb_kernels // self.group) \
            + self.kernel_size
        dt = amp.param_dtype(x.dtype)
        self.W = new_param(w_shape, x, dt)
        std = math.sqrt(2.0 / (w_shape[1] * np.prod(self.kernel_size)
                               + in_channels))
        initializer.gaussian(self.W, 0.0, std,
                             generator=device_of(x).generator)
        if self.bias:
            self.b = initializer.zeros(new_param((self.nb_kernels,), x, dt))

    def forward(self, x):
        return conv_ops.conv_transpose2d(
            x, self.W, self.b if self.bias else None, stride=self.stride,
            padding=self.padding, dilation=self.dilation, group=self.group,
            output_padding=self.output_padding)


class BatchNorm2d(Layer):
    """Per-channel affine (``scale``, ``bias``) and float32 running
    statistics (``running_mean``, ``running_var``, buffers).  Training
    mode (``Module.training``) normalizes by the batch and updates the
    running statistics; eval normalizes by them."""

    def __init__(self, momentum=0.9, eps=1e-5):
        super().__init__()
        self.momentum = float(momentum)
        self.eps = float(eps)

    def initialize(self, x):
        c = x.shape[1]
        dt = amp.param_dtype(x.dtype)
        self.scale = initializer.ones(new_param((c,), x, dt))
        self.bias = initializer.zeros(new_param((c,), x, dt))
        self.register_state("running_mean", torch.zeros(
            c, device=x.device, dtype=torch.float32))
        self.register_state("running_var", torch.ones(
            c, device=x.device, dtype=torch.float32))

    def forward(self, x):
        return bn_ops.batchnorm2d(
            x, self.scale, self.bias, self.running_mean, self.running_var,
            momentum=self.momentum, eps=self.eps, training=self.training)


class Pooling2d(Layer):
    def __init__(self, kernel_size, stride=None, padding=0, is_max=True,
                 pad_mode="NOTSET"):
        super().__init__()
        self.kernel_size = _pair(kernel_size)
        self.stride = self.kernel_size if stride is None else _pair(stride)
        self.padding = _pair(padding)
        self.is_max = bool(is_max)
        self.pad_mode = pad_mode

    def forward(self, x):
        return pool_ops.pooling2d(
            x, kernel=self.kernel_size, stride=self.stride,
            padding=self.padding, is_max=self.is_max,
            pad_mode=self.pad_mode)


class MaxPool2d(Pooling2d):
    def __init__(self, kernel_size, stride=None, padding=0, **kw):
        super().__init__(kernel_size, stride, padding, is_max=True, **kw)


class AvgPool2d(Pooling2d):
    def __init__(self, kernel_size, stride=None, padding=0, **kw):
        super().__init__(kernel_size, stride, padding, is_max=False, **kw)


class GlobalAvgPool2d(Layer):
    def forward(self, x):
        return autograd.reduce_mean(x, axes=(2, 3), keepdims=False)


# The recurrent layers live beside the rnn ops, and MultiHeadAttention
# beside the attention ops; both are re-exported here on first access, as
# the JAX package's layer module does.
def __getattr__(name):
    if name in ("LSTM", "GRU", "RNN", "CudnnRNN"):
        from .ops import rnn as rnn_ops

        return getattr(rnn_ops, name)
    if name == "MultiHeadAttention":
        from .ops import attention as attn_ops

        return attn_ops.MultiHeadAttention
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
