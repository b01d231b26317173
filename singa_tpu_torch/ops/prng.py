"""Threefry-2x32 counter-based random numbers keyed as ``jax.random``
keys them: the parts of ``jax.random`` that the serving and sampling
code of the JAX package calls, bit for bit.

A key is a pair of 32-bit words ``(k0, k1)``.  Every function comes
twice:

* a numpy version on ``uint32`` arrays of shape ``(..., 2)``, for the
  host key chain (admission, each decode step's ``split``, a fork's
  ``fold_in``), which stays on the host and is cheap at a few lanes;
* a torch version on tensors (``*_t``), in int64 arithmetic masked to 32
  bits after every add and rotate (torch has no uint32 arithmetic), so
  the draws of a step happen on its device, inside a captured CUDA
  graph, from key words staged as int32 tensors.

The layout is that of JAX 0.9 with ``jax_threefry_partitionable`` on
(its default) and 32-bit integers (``jax_enable_x64`` off):

* ``PRNGKey(seed)`` is ``(0, seed mod 2^32)``;
* ``split(key, n)`` hashes the counter pairs ``(0, i)`` for ``i < n``
  and key ``i`` is the hash's two words;
* ``fold_in(key, d)`` hashes the one pair ``(0, d)``;
* ``random_bits(key, shape)`` hashes ``(hi, lo)`` of each element's
  row-major flat index and xors the two words;
* ``uniform`` keeps the top 23 bits as a float32 mantissa in [1, 2),
  subtracts 1, rescales to ``[minval, maxval)`` with one rounding (XLA
  fuses the multiply and add) and clamps below at ``minval``; ``gumbel`` is ``-log(-log(uniform(tiny, 1)))`` (JAX's
  default "low" mode); ``categorical`` is the argmax of logits plus
  Gumbel noise over the last axis.

Bits and uniforms equal JAX's exactly.  A Gumbel value goes through two
float32 logarithms, which torch and XLA may round one ulp apart.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["threefry2x32", "PRNGKey", "split", "fold_in", "random_bits",
           "uniform", "gumbel", "categorical", "threefry2x32_t",
           "split_t", "random_bits_t", "uniform_t", "gumbel_t",
           "categorical_t", "key_words"]

_M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = np.finfo(np.float32).tiny


# ------------------------------------------------------------------ numpy


#: the rotations of each group of four rounds as (left, right) shifts
_SHIFTS = tuple(tuple((np.uint32(r), np.uint32(32 - r)) for r in rs)
                for rs in _ROT)


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter words ``x0``,
    ``x1`` (broadcast ``uint32`` arrays) under ``key`` (``(..., 2)``
    ``uint32``, broadcast against the counters' leading axes).  Returns
    the two output words.  In-place ``uint32`` arithmetic, which wraps:
    a step's split of a few keys is a few hundred microseconds of
    numpy calls on the host."""
    key = np.asarray(key, np.uint32)
    k0, k1 = key[..., 0:1][..., 0], key[..., 1:2][..., 0]
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(_PARITY))
    x0, x1 = np.asarray(x0, np.uint32), np.asarray(x1, np.uint32)
    shape = np.broadcast_shapes(x0.shape, x1.shape, k0.shape)
    with np.errstate(over="ignore"):
        x0 = np.add(x0, ks[0], out=np.empty(shape, np.uint32))
        x1 = np.add(x1, ks[1], out=np.empty(shape, np.uint32))
        t = np.empty(shape, np.uint32)
        for i in range(5):
            for left, right in _SHIFTS[i % 2]:
                x0 += x1
                np.left_shift(x1, left, out=t)
                x1 >>= right
                x1 |= t
                x1 ^= x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3]
            x1 += np.uint32(i + 1)
    return x0, x1


def PRNGKey(seed):
    """The key of an integer ``seed`` (JAX with 32-bit integers keeps its
    low 32 bits): ``(0, seed mod 2^32)`` as a (2,) ``uint32`` array."""
    return np.asarray([0, int(seed) & _M32], np.uint32)


def split(key, num=2):
    """``num`` new keys from ``key`` (2,): a (num, 2) ``uint32`` array;
    ``key`` (..., 2) splits each key, giving (..., num, 2)."""
    key = np.asarray(key, np.uint32)
    i = np.arange(num, dtype=np.uint32)
    b0, b1 = threefry2x32(key[..., None, :], np.zeros_like(i), i)
    return np.stack([b0, b1], -1)


def fold_in(key, data):
    """``key`` (..., 2) with the 32-bit integer ``data`` folded in."""
    key = np.asarray(key, np.uint32)
    b0, b1 = threefry2x32(key, np.uint32(0), np.uint32(int(data) & _M32))
    return np.stack([b0, b1], -1)


def _counters(shape):
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64).reshape(shape)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(_M32)).astype(np.uint32))


def random_bits(key, shape):
    """``uint32`` bits of ``shape`` from ``key`` (2,); a key array (...,
    2) draws one ``shape`` block per key, (..., *shape)."""
    key = np.asarray(key, np.uint32)
    hi, lo = _counters(tuple(shape))
    k = key.reshape(key.shape[:-1] + (1,) * len(shape) + (2,))
    b0, b1 = threefry2x32(k, hi, lo)
    return b0 ^ b1


def _bits_to_unit(bits):
    """float32 in [0, 1) from the top 23 of 32 bits."""
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return f - np.float32(1.0)


def _scale(f, span, lo):
    """``f * span + lo`` rounded once, as the fused multiply-add XLA
    emits: exact for a unit span, else through float64 (the product of
    two float32 values is exact there)."""
    if span == 1.0:
        return f + lo
    return (f.astype(np.float64) * span + lo).astype(np.float32)


def uniform(key, shape, minval=0.0, maxval=1.0):
    """float32 uniforms in ``[minval, maxval)`` of ``shape``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    f = _bits_to_unit(random_bits(key, shape))
    return np.maximum(lo, _scale(f, float(hi - lo), float(lo)))


def gumbel(key, shape):
    """float32 standard Gumbel noise of ``shape``."""
    u = uniform(key, shape, _TINY, 1.0)
    return -np.log(-np.log(u))


def categorical(key, logits):
    """One index of the last axis of ``logits`` per row: the argmax of
    the float32 logits plus ``gumbel(key, logits.shape)``."""
    logits = np.asarray(logits, np.float32)
    return np.argmax(gumbel(key, logits.shape) + logits, -1)


# ------------------------------------------------------------------ torch


def key_words(keys, device):
    """Host keys (..., 2) ``uint32`` as an int64 tensor on ``device``."""
    return torch.as_tensor(np.asarray(keys, np.uint32).astype(np.int64),
                           device=device)


def _w(x):
    """A key or counter tensor's words as int64 in [0, 2^32): int32
    tensors (staged key words) read as unsigned."""
    return x.long() & _M32


def threefry2x32_t(k0, k1, x0, x1):
    """:func:`threefry2x32` on tensors: key words ``k0``, ``k1`` and
    counter words ``x0``, ``x1``, broadcast int tensors whose values are
    32-bit words (int32 ones read as unsigned).  Returns the two output
    words as int64 tensors in [0, 2^32)."""
    k0, k1 = _w(k0), _w(k1)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (_w(x0) + ks[0]) & _M32
    x1 = (_w(x1) + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def split_t(keys, num=2):
    """:func:`split` of key tensors ``keys`` (..., 2): (..., num, 2)
    int64."""
    i = torch.arange(num, device=keys.device)
    b0, b1 = threefry2x32_t(keys[..., None, 0], keys[..., None, 1],
                            torch.zeros_like(i), i)
    return torch.stack([b0, b1], -1)


def random_bits_t(keys, n):
    """32-bit words of ``n`` draws per key: ``keys`` (..., 2) int tensor,
    the draws of each key counted 0..n-1 (``random_bits(key, (n,))``,
    and any row of a larger shape drawn from its own key).  Returns
    (..., n) int64.  Counters stay below 2^32, so the high counter word
    is 0."""
    i = torch.arange(n, device=keys.device)
    b0, b1 = threefry2x32_t(keys[..., None, 0], keys[..., None, 1],
                            torch.zeros_like(i), i)
    return b0 ^ b1


def _unit_t(bits):
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform_t(keys, n, minval=0.0, maxval=1.0):
    """:func:`uniform` of ``n`` draws per key of ``keys`` (..., 2):
    (..., n) float32.  The bounds enter as Python floats (their float32
    values and span), so nothing is copied from the host and a captured
    step draws it."""
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    f = _unit_t(random_bits_t(keys, n))
    f = f + lo if span == 1.0 else (f.double() * span + lo).float()
    return torch.clamp(f, min=lo)


def gumbel_t(keys, n):
    """:func:`gumbel` of ``n`` draws per key of ``keys`` (..., 2):
    (..., n) float32."""
    return -torch.log(-torch.log(uniform_t(keys, n, float(_TINY), 1.0)))


def categorical_t(keys, logits):
    """One index per row of ``logits`` (..., V), row ``r`` drawn with key
    ``keys[r]`` (..., 2): the argmax of the float32 logits plus
    ``gumbel(keys[r], (V,))``.  (..., ) int64."""
    return (gumbel_t(keys, logits.shape[-1]) + logits.float()).argmax(-1)
