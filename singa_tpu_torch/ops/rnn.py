"""Recurrent ops (counterpart of ``singa_tpu/ops/rnn.py``): LSTM, GRU and
vanilla tanh / relu RNNs, multi-layer, bidirectional, with inter-layer
dropout, over one packed weight buffer.

The packed single-buffer layout is the JAX package's (``RNNHandle``), so
``save_states`` zips interchange: for each layer, for each direction,
``W_ih (G·H, I)``, ``W_hh (G·H, H)``, ``b_ih (G·H,)``, ``b_hh (G·H,)``,
flattened row-major and concatenated; gate order LSTM i, f, g, o and GRU
r, z, n.

The time loop runs as torch ops, one path on the CPU and on the card: the
input projection of every step is one product over the whole sequence,
then a Python loop applies the recurrent product and the cell step by
step.  Torch autograd differentiates through the loop (the JAX package's
``jax.vjp`` through ``lax.scan``).  A training step captured by
``graphs.Step`` records the loop's kernels once and replays them.  The
JAX package deleted its Pallas LSTM cell (``singa_tpu/ops/rnn.py:34-59``),
so there is no TPU kernel to port here; ``use_pallas`` is accepted and
ignored, as there.

Each (layer, direction) scan is one op recorded for export as the JAX
tape records it: ``RNN[l{l}d{d}]`` over ``(x, hx, cx, W)`` with outputs
``(y, h_T, c_T)`` and ``params`` ``mode``, ``layer``, ``direction``,
``idx``, ``hidden`` and ``slices`` (the packed weight's offsets), which
``sonnx`` unpacks into an ONNX LSTM/GRU/RNN node.  The glue between
them (transposes, concatenation, the stacked final states) is made of
the recorded ``autograd`` ops the JAX function uses.
"""

from __future__ import annotations

import math

import torch

from .. import amp, autograd
from ..autograd import dropout
from ..device import device_of
from ..layer import Layer, new_param

__all__ = ["RNNHandle", "rnn_forward", "LSTM", "GRU", "RNN", "CudnnRNN"]

_GATES = {"lstm": 4, "gru": 3, "vanilla_tanh": 1, "vanilla_relu": 1}


class RNNHandle:
    """The packed weight's size and each (layer, direction) slice's
    offsets, as the JAX package's ``RNNHandle`` computes them."""

    def __init__(self, input_size, hidden_size, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, use_pallas=False):
        if mode not in _GATES:
            raise ValueError(f"unknown rnn mode {mode!r}")
        self.input_size = int(input_size)
        self.hidden_size = int(hidden_size)
        self.num_layers = int(num_layers)
        self.mode = mode
        self.bidirectional = bool(bidirectional)
        self.num_directions = 2 if bidirectional else 1
        self.dropout = float(dropout)
        del use_pallas  # accepted for API compatibility: no kernel
        self.slices = self._layout()
        self.weights_size = self._total

    def _layout(self):
        G, H = _GATES[self.mode], self.hidden_size
        off = 0
        slices = {}
        for l in range(self.num_layers):
            I = self.input_size if l == 0 else H * self.num_directions
            for d in range(self.num_directions):
                for name, shape in (("w_ih", (G * H, I)),
                                    ("w_hh", (G * H, H)),
                                    ("b_ih", (G * H,)), ("b_hh", (G * H,))):
                    n = math.prod(shape)
                    slices[(l, d, name)] = (off, off + n, shape)
                    off += n
        self._total = off
        return slices

    def unpack(self, w_flat, l, d):
        """Views of layer ``l``, direction ``d``'s weights in ``w_flat``."""
        out = {}
        for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
            a, b, shape = self.slices[(l, d, name)]
            out[name] = w_flat[a:b].view(shape)
        return out

    def init_weights(self, like, dtype=torch.float32, generator=None):
        """One flat weight parameter on ``like``'s device, uniform in
        ±1/sqrt(H) as the JAX package initializes it (other draws for the
        same seed)."""
        w = new_param((self.weights_size,), like, dtype)
        k = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            w.uniform_(-k, k, generator=generator)
        return w


def _step(mode, gx, h, c, w_hh, b_hh):
    """One time step of the cell from the step's input projection ``gx``
    (``x·W_ihᵀ + b``, GRU: ``+ b_ih`` only); returns ``(h, c)``."""
    if mode == "lstm":
        i, f, g, o = (gx + h @ w_hh.t()).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c), c
    if mode == "gru":
        ir, iz, in_ = gx.chunk(3, dim=-1)
        hr, hz, hn = (h @ w_hh.t() + b_hh).chunk(3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(in_ + r * hn)
        return (1 - z) * n + z * h, c
    pre = gx + h @ w_hh.t()
    return (torch.tanh(pre) if mode == "vanilla_tanh"
            else torch.relu(pre)), c


def _direction(x, h, c, p, mode, reverse):
    """x: (T, B, I) -> ys (T, B, H), h_T, c_T over one direction."""
    dt = torch.promote_types(x.dtype, p["w_ih"].dtype)
    x = x.to(dt)
    w_ih, w_hh, b_ih, b_hh = (p[n].to(dt) for n in ("w_ih", "w_hh", "b_ih",
                                                    "b_hh"))
    bias = b_ih if mode == "gru" else b_ih + b_hh
    gxs = torch.matmul(x, w_ih.t()) + bias   # every step's input product
    h, c = h.to(dt), c.to(dt)
    ys = [None] * x.shape[0]
    for t in (reversed(range(x.shape[0])) if reverse else range(x.shape[0])):
        h, c = _step(mode, gxs[t], h, c, w_hh, b_hh)
        ys[t] = h
    return torch.stack(ys), h, c


def _scan(x, hx, cx, W, *, mode, layer, direction, idx, hidden, slices):
    """One (layer, direction) scan: (y, h_T, c_T); c_T is zeros for the
    modes without a cell state."""
    p = {name: W[a:b].view(shape) for name, (a, b, shape) in slices.items()}
    y, h, c = _direction(x, hx[idx], cx[idx], p, mode, direction == 1)
    return y, h, (c if mode == "lstm" else torch.zeros_like(h))


def rnn_forward(x, hx, cx, W, handle, batch_first=False, training=False):
    """The multi-layer (bi)directional RNN of ``handle`` on the packed
    weight ``W``.  x: (T, B, I), or (B, T, I) with ``batch_first``;
    hx, cx: (L·D, B, H).  Returns ``(y, hy, cy)``; cy is zeros for the
    modes without a cell state.  Dropout between layers while
    ``training``."""
    mode = handle.mode
    L, D = handle.num_layers, handle.num_directions
    if batch_first:
        x = autograd.transpose(x, (1, 0, 2))
    inp = x
    hs, cs = [], []
    for l in range(L):
        outs = []
        for d in range(D):
            y, h, c = autograd._op(
                _scan, inp, hx, cx, W, _name=f"RNN[l{l}d{d}]", mode=mode,
                layer=l, direction=d, idx=l * D + d,
                hidden=handle.hidden_size,
                slices={name: handle.slices[(l, d, name)]
                        for name in ("w_ih", "w_hh", "b_ih", "b_hh")})
            outs.append(y)
            hs.append(h)
            cs.append(c)
        inp = outs[0] if D == 1 else autograd.cat(outs, axis=2)
        if training and handle.dropout > 0 and l < L - 1:
            inp = dropout(inp, handle.dropout, training=True)
    y = autograd.transpose(inp, (1, 0, 2)) if batch_first else inp

    def stacked(ts):
        if len(ts) == 1:
            return autograd.unsqueeze(ts[0], 0)
        return autograd.cat([autograd.unsqueeze(t, 0) for t in ts], axis=0)

    return y, stacked(hs), stacked(cs)


class _BaseRNN(Layer):
    """The layer over ``rnn_forward`` with its packed weight ``W``
    (the JAX package's ``_BaseRNN``)."""

    mode = "vanilla_tanh"

    def __init__(self, hidden_size, num_layers=1, bidirectional=False,
                 dropout=0.0, batch_first=False, return_sequences=True,
                 use_pallas=False):
        super().__init__()
        self.hidden_size = int(hidden_size)
        self.num_layers = int(num_layers)
        self.bidirectional = bool(bidirectional)
        self.dropout = float(dropout)
        self.batch_first = bool(batch_first)
        self.return_sequences = return_sequences
        del use_pallas  # accepted for API compatibility: no kernel
        self.handle = None

    def initialize(self, x, hx=None, cx=None):
        self.handle = RNNHandle(x.shape[-1], self.hidden_size,
                                self.num_layers, self.mode,
                                self.bidirectional, self.dropout)
        self.W = self.handle.init_weights(
            x, amp.param_dtype(x.dtype), device_of(x).generator)

    def _zero_state(self, x):
        b = x.shape[0] if self.batch_first else x.shape[1]
        return torch.zeros(self.num_layers * self.handle.num_directions, b,
                           self.hidden_size, dtype=x.dtype, device=x.device)

    def forward(self, x, hx=None, cx=None):
        if hx is None:
            hx = self._zero_state(x)
        if cx is None:
            cx = self._zero_state(x)
        y, hy, cy = rnn_forward(x, hx, cx, self.W, self.handle,
                                self.batch_first, self.training)
        if self.mode == "lstm":
            return (y, (hy, cy)) if self.return_sequences else (hy, (hy, cy))
        return (y, hy) if self.return_sequences else (hy, hy)


class LSTM(_BaseRNN):
    mode = "lstm"


class GRU(_BaseRNN):
    mode = "gru"


class RNN(_BaseRNN):
    """Vanilla RNN; ``nonlinearity`` is ``"tanh"`` or ``"relu"``."""

    def __init__(self, hidden_size, nonlinearity="tanh", **kw):
        super().__init__(hidden_size, **kw)
        self.mode = f"vanilla_{nonlinearity}"


class CudnnRNN(LSTM):
    """The reference's name for its cuDNN-backed RNN: here the same LSTM
    as ``LSTM``."""
