"""Transformer layers (counterpart of
``singa_tpu/parallel/tensor_parallel.py``), serial path only.

The JAX package builds these layers Megatron-style and shards them over
a ``model`` mesh axis when a ``ShardingPlan`` is given; with
``plan=None`` they run as their serial equivalents.  This module ports
that serial path: passing a plan raises ``NotImplementedError``.  Layer
and parameter names match the JAX package's, so states carry across.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from .. import amp, autograd, initializer
from ..device import device_of
from ..layer import Layer, LayerNorm, new_param

__all__ = [
    "ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
    "ParallelMLP", "ParallelMHA", "ParallelTransformerBlock",
]


def _serial_only(plan):
    if plan is not None:
        raise NotImplementedError(
            "tensor/sequence-parallel plans are not ported yet; the "
            "PyTorch port runs these layers serially (plan=None)")


class ColumnParallelLinear(Layer):
    """``y = x @ W + b`` with W laid out (in, out); serial."""

    def __init__(self, out_features, plan=None, bias=True):
        super().__init__()
        _serial_only(plan)
        self.out_features = int(out_features)
        self.has_bias = bool(bias)

    def initialize(self, x):
        dt = amp.param_dtype(x.dtype)
        self.W = new_param((x.shape[-1], self.out_features), x, dt)
        initializer.xavier(self.W, generator=device_of(x).generator)
        if self.has_bias:
            self.b = initializer.zeros(new_param((self.out_features,), x, dt))

    def forward(self, x):
        y = autograd.matmul(x, self.W)
        if self.has_bias:
            y = autograd.add_bias(y, self.b)
        return y


class RowParallelLinear(ColumnParallelLinear):
    """``y = x @ W + b``; the row-sharded half of a Megatron pair, serial
    here, so the same math as :class:`ColumnParallelLinear`."""

    def __init__(self, out_features, plan=None, bias=True):
        super().__init__(out_features, plan, bias=bias)


class VocabParallelEmbedding(Layer):
    """Token embedding table (vocab, dim), float32, N(0, std)."""

    def __init__(self, vocab_size, embed_dim, plan=None, std=0.02):
        super().__init__()
        _serial_only(plan)
        self.vocab_size = int(vocab_size)
        self.embed_dim = int(embed_dim)
        self.std = float(std)

    def initialize(self, ids):
        self.W = new_param((self.vocab_size, self.embed_dim), ids)
        initializer.gaussian(self.W, 0.0, self.std,
                             generator=device_of(ids).generator)

    def forward(self, ids):
        return autograd.embedding(ids, self.W)


class ParallelMLP(Layer):
    """Transformer FFN: fc1 -> activation -> fc2."""

    def __init__(self, hidden, intermediate, plan=None, activation="gelu"):
        super().__init__()
        self.fc1 = ColumnParallelLinear(intermediate, plan)
        self.fc2 = RowParallelLinear(hidden, plan)
        self.activation = activation

    def forward(self, x):
        return self.fc2(getattr(autograd, self.activation)(self.fc1(x)))


class ParallelMHA(Layer):
    """Multi-head attention: q/k/v projections, scaled-dot-product
    attention (the flash kernels with ``use_flash``), output projection.
    ``num_kv_heads < num_heads`` is grouped-query attention: each K/V head
    serves a contiguous group of query heads (``autograd.repeat_kv``)."""

    def __init__(self, num_heads, plan=None, dropout=0.0, seq_parallel=None,
                 causal=False, remat=False, use_flash=False,
                 num_kv_heads=None, window=None):
        super().__init__()
        _serial_only(plan)
        if seq_parallel:
            raise NotImplementedError(
                "ring (sequence-parallel) attention is not ported yet")
        self.num_heads = int(num_heads)
        self.num_kv_heads = int(num_kv_heads or num_heads)
        if self.num_heads % self.num_kv_heads != 0:
            raise ValueError(
                f"num_heads {self.num_heads} not divisible by "
                f"num_kv_heads {self.num_kv_heads}")
        if window is not None and (not causal or int(window) < 1):
            raise ValueError("window requires causal attention and "
                             f"window >= 1, got {window} (causal={causal})")
        self.window = None if window is None else int(window)
        self.dropout = float(dropout)
        self.causal = bool(causal)
        self.remat = bool(remat)
        self.use_flash = bool(use_flash)
        self.q_proj = ColumnParallelLinear(0)
        self.k_proj = ColumnParallelLinear(0)
        self.v_proj = ColumnParallelLinear(0)
        self.out_proj = RowParallelLinear(0)

    def initialize(self, x, mask=None):
        e = x.shape[-1]
        if e % self.num_heads != 0:
            raise ValueError(
                f"embed dim {e} not divisible by num_heads {self.num_heads}")
        e_kv = (e // self.num_heads) * self.num_kv_heads
        self.q_proj.out_features = self.out_proj.out_features = e
        self.k_proj.out_features = self.v_proj.out_features = e_kv

    def forward(self, x, mask=None):
        b, s, e = x.shape
        h, h_kv = self.num_heads, self.num_kv_heads
        d = e // h

        def split_heads(t, nh):
            t = autograd.transpose(autograd.reshape(t, (b, s, nh, d)),
                                   (0, 2, 1, 3))
            if nh != h:
                t = autograd.repeat_kv(t, h // nh)
            return t

        q = split_heads(self.q_proj(x), h)
        k = split_heads(self.k_proj(x), h_kv)
        v = split_heads(self.v_proj(x), h_kv)
        ctx = _sdpa(q, k, v, mask, self.causal, remat=self.remat,
                    use_flash=self.use_flash, window=self.window)
        ctx = autograd.reshape(autograd.transpose(ctx, (0, 2, 1, 3)),
                               (b, s, e))
        ctx = autograd.dropout(ctx, self.dropout, training=self.training)
        return self.out_proj(ctx)


class ParallelTransformerBlock(Layer):
    """Pre-LN transformer block: ``x + attn(ln1(x))``, then
    ``x + mlp(ln2(x))``."""

    def __init__(self, num_heads, intermediate, plan=None, dropout=0.0,
                 causal=False, eps=1e-5, remat=False, use_flash=False,
                 num_kv_heads=None, window=None):
        super().__init__()
        self.ln1 = LayerNorm(eps)
        self.attn = ParallelMHA(num_heads, plan, dropout=dropout,
                                causal=causal, remat=remat,
                                use_flash=use_flash,
                                num_kv_heads=num_kv_heads, window=window)
        self.ln2 = LayerNorm(eps)
        self.mlp = None  # needs the hidden size: built at initialize
        self._intermediate = int(intermediate)
        self._plan = plan
        self._dropout = float(dropout)

    def initialize(self, x, mask=None):
        self.mlp = ParallelMLP(x.shape[-1], self._intermediate, self._plan)

    @property
    def aux_loss(self):
        """MoE load-balance loss of the last forward; always None, since
        only dense blocks are ported."""
        return None

    def forward(self, x, mask=None):
        a = autograd.dropout(self.attn(self.ln1(x), mask), self._dropout,
                             training=self.training)
        x = autograd.add(x, a)
        m = autograd.dropout(self.mlp(self.ln2(x)), self._dropout,
                             training=self.training)
        return autograd.add(x, m)


def _attention_plain(q, k, v, *mask, scale, causal, window):
    sc = torch.einsum("bhsd,bhtd->bhst", q, k) * scale
    if mask:
        sc = sc + mask[0]
    if causal:
        s_, t_ = sc.shape[-2:]
        i = torch.arange(s_, device=sc.device)[:, None]
        j = torch.arange(t_, device=sc.device)[None, :]
        cm = i >= j
        if window is not None:
            cm = cm & (i - j < window)
        sc = torch.where(cm, sc, torch.full_like(sc, -1e30))
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bhst,bhtd->bhsd", p, v)


def _sdpa(q, k, v, mask, causal, remat=False, use_flash=False,
          window=None):
    """Scaled-dot-product attention on (B, H, S, D).  ``use_flash``
    routes to the flash kernels (``ops/flash_attention.py``), whose
    memory is O(S·D) and whose backward recomputes p from the saved lse;
    otherwise the plain softmax(QKᵀ)V in the activation dtype, with the
    (B, H, S, S) scores in memory (``remat`` recomputes them in the
    backward instead of keeping them)."""
    if use_flash:
        from ..ops.flash_attention import flash_attention_op

        return flash_attention_op(q, k, v, mask, causal=causal,
                                  window=window)
    xs = (q, k, v) if mask is None else (q, k, v, mask)
    kw = dict(scale=1.0 / math.sqrt(q.shape[-1]), causal=causal,
              window=window)
    if remat:
        return checkpoint(_attention_plain, *xs, use_reentrant=False, **kw)
    return _attention_plain(*xs, **kw)
