"""Attention (counterpart of ``singa_tpu/ops/attention.py``): the
scaled-dot-product op and the ``MultiHeadAttention`` layer that BERT's
encoder blocks use.

Both are the serial transformer path of ``parallel/tensor_parallel.py``
with non-causal attention: ``scaled_dot_product_attention`` is its
``_sdpa`` (the fused path is the plain softmax(QKᵀ·scale + mask)·V, as
XLA computes it, with the (B, H, S, S) scores in memory; ``use_flash``
runs the flash kernels of ``ops/flash_attention.py``, which take a
(B, 1, 1, S) key-padding mask as their key-mask row; ``remat``
recomputes the scores in the backward), and ``MultiHeadAttention`` is
``ParallelMHA`` without a plan.
"""

from __future__ import annotations

import math

from .. import autograd
from ..parallel.tensor_parallel import ParallelMHA, _attention_plain

__all__ = ["scaled_dot_product_attention", "MultiHeadAttention"]


def scaled_dot_product_attention(q, k, v, mask=None, use_flash=False,
                                 remat=False):
    """q, k, v: (B, H, S, D); ``mask``: an additive mask broadcastable to
    (B, H, S, S) (e.g. -1e9 at padded keys), or None.  Recorded for
    export as the JAX op records it: ``Attention`` (``scale``) on the
    fused path, ``TPAttention`` on the flash path."""
    if use_flash:
        from .flash_attention import flash_attention_op

        return flash_attention_op(q, k, v, mask)
    xs = (q, k, v) if mask is None else (q, k, v, mask)
    apply = autograd.checkpoint_op if remat else autograd._op
    return apply(_attention, *xs, _name="Attention",
                 scale=1.0 / math.sqrt(q.shape[-1]))


def _attention(q, k, v, *mask, scale):
    return _attention_plain(q, k, v, *mask, scale=scale, causal=False,
                            window=None)


class MultiHeadAttention(ParallelMHA):
    """Multi-head attention over (B, S, E) inputs: q/k/v projections
    (``Linear(0)``, sized at the first call), scaled-dot-product
    attention, dropout on the context, the output projection.
    ``num_kv_heads < num_heads`` is grouped-query attention."""

    def __init__(self, num_heads, dropout=0.0, use_flash=False,
                 remat=False, num_kv_heads=None):
        super().__init__(num_heads, None, dropout=dropout, remat=remat,
                         use_flash=use_flash, num_kv_heads=num_kv_heads)

    def _attend(self, q, k, v, mask):
        return scaled_dot_product_attention(q, k, v, mask,
                                            use_flash=self.use_flash,
                                            remat=self.remat)
