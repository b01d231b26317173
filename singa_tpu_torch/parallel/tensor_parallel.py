"""Transformer layers (counterpart of
``singa_tpu/parallel/tensor_parallel.py``), Megatron-style under a
``ShardingPlan`` (``parallel/sharding.py``); a block's MLP may be a
mixture of experts (``parallel/moe.py``).

With ``plan=None`` the layers are their serial equivalents.  Under a plan
each rank holds its slice of every weight over the ``model`` axis and the
layers issue the collectives that GSPMD inserts in the JAX package, as
``torch.autograd.Function`` pairs over the axis's process group:

* ``ColumnParallelLinear``: W (in, out/model); its input passes through
  :func:`copy_to_axis` (identity forward, all-reduce of the gradient),
  its output stays feature-sharded, or is all-gathered with
  ``gather_output``;
* ``RowParallelLinear``: W (in/model, out) on feature-sharded input, the
  partial products summed by :func:`reduce_from_axis` (all-reduce
  forward, identity backward), the bias added after the sum;
* ``VocabParallelEmbedding``: table rows over ``model``; ids outside the
  rank's rows are masked, looked up, and the rows summed over ``model``;
* ``ParallelMHA``: heads over ``model`` (column q/k/v, row out-proj), on
  the ring (``parallel/ring_attention.py``) when the plan has a ``seq``
  axis longer than 1.

Every weight is made at its global shape from the device generator and
then sliced, so the ranks' shards are those of one global initialization.
Layer and parameter names match the JAX package's, so states carry across.
"""

from __future__ import annotations

import math

import torch

from .. import amp, autograd, initializer
from ..device import device_of
from ..layer import Layer, LayerNorm, new_param
from . import communicator as _comm
from .sharding import MODEL, SEQ, P, shard_array

__all__ = [
    "ColumnParallelLinear", "RowParallelLinear", "VocabParallelEmbedding",
    "ParallelMLP", "ParallelMHA", "ParallelTransformerBlock",
    "copy_to_axis", "reduce_from_axis", "gather_from_axis",
    "decode_param_specs", "decode_cache_spec", "shard_decode_params",
]


# ------------------------------------- the decode pytree's serve layout

#: column-parallel decode weights (q/k/v, MLP fc1) and their biases split
#: their OUTPUT dim; the row-parallel ones (attention out-proj, MLP fc2)
#: split their INPUT dim and close with the block's one all-reduce;
#: everything else (LayerNorms, row biases, embeddings, the LM head) is
#: replicated
_DECODE_COL_W = ("wq", "wk", "wv", "w1")
_DECODE_COL_B = ("bq", "bk", "bv", "b1")
_DECODE_ROW_W = ("wo", "w2")
#: MoE expert weights: stacked (E, ...) tensors whose LEADING expert axis
#: shards over the serve ``ep`` axis; the router ``moe_wg`` replicates
_DECODE_EXPERT_W = ("moe_w1", "moe_b1", "moe_w2", "moe_b2")


def decode_param_specs(params, axis=MODEL, ep_axis=None):
    """The spec pytree (``params``' structure, a :class:`P` a tensor
    leaf, None for a None leaf and for a block's non-tensor entries)
    laying an ``extract_params`` decode pytree out Megatron-style over
    ``axis``: heads and MLP columns partitioned, out-proj / fc2 by rows,
    embeddings / norms / head replicated; a MoE block's stacked expert
    weights over ``ep_axis`` (``serve/ep.py``).  A MoE block without an
    ``ep_axis`` raises ``NotImplementedError`` naming the ``serve(ep=)``
    path (the JAX package's ``decode_param_specs``)."""
    blocks = []
    for li, blk in enumerate(params["blocks"]):
        if "moe_wg" in blk and ep_axis is None:
            raise NotImplementedError(
                f"block {li} is an MoE block: expert weights shard over "
                f"the expert axis, not the tensor-parallel axis; serve "
                f"this model with model.serve(ep=EPConfig(ep=, tp=)) "
                f"(singa_tpu_torch/serve/ep.py: expert-parallel decode; "
                f"tp= covers dense/GQA models only)")
        spec = {}
        for k, v in blk.items():
            if not isinstance(v, torch.Tensor):
                spec[k] = None
            elif k in _DECODE_COL_W:
                spec[k] = P(None, axis)
            elif k in _DECODE_COL_B:
                spec[k] = P(axis)
            elif k in _DECODE_ROW_W:
                spec[k] = P(axis, None)
            elif k in _DECODE_EXPERT_W:
                spec[k] = P(ep_axis)
            else:
                spec[k] = P()
        blocks.append(spec)
    out = {k: (None if v is None else P())
           for k, v in params.items() if k != "blocks"}
    out["blocks"] = blocks
    return out


def decode_cache_spec(axis=MODEL):
    """The spec of every KV leaf the serve engine owns: slot arenas (L,
    S, H_kv, W, D), paged pools (L, N + 1, H_kv, B, D), cache rows (L, 1,
    H_kv, W, D) and their int8 scales (no trailing D): the KV-head axis,
    always axis 2, over ``axis``."""
    return P(None, None, axis)


def shard_decode_params(params, mesh, axis=MODEL, ep_axis=None):
    """This rank's slices of a full decode pytree (``extract_params``'
    output) under :func:`decode_param_specs`, cut by
    ``sharding.shard_array`` (a dimension the axes do not divide
    raises); a block's non-tensor entries and None leaves pass as they
    are."""
    specs = decode_param_specs(params, axis=axis, ep_axis=ep_axis)

    def cut(t, spec, name):
        if spec is None:
            return t
        return shard_array(t, mesh, spec, name=name).to(t.device)

    out = {k: cut(v, specs[k], k) for k, v in params.items()
           if k != "blocks"}
    out["blocks"] = [{k: cut(v, sp[k], f"blocks.{i}.{k}")
                      for k, v in blk.items()}
                     for i, (blk, sp) in enumerate(zip(params["blocks"],
                                                       specs["blocks"]))]
    return out


# ------------------------------------------------- the conjugate collectives


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _comm.group_all_reduce(g.contiguous().clone(), ctx.group,
                                      op="tp_all_reduce"), None


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _comm.group_all_reduce(x.contiguous().clone(), group,
                                      op="tp_all_reduce")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, dim):
        ctx.index, ctx.dim, ctx.n = index, dim, x.shape[dim]
        return _comm.group_all_gather(x, group, dim=dim, op="tp_all_gather")

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None, None


def copy_to_axis(x, axis):
    """Identity forward; the gradient all-reduced over ``axis`` (an
    ``Axis``): where a replicated activation enters sharded work."""
    return x if axis.size == 1 else _CopyToAxis.apply(x, axis.group)


def reduce_from_axis(x, axis):
    """The sum over ``axis`` forward; identity backward: where sharded
    partial sums leave."""
    return x if axis.size == 1 else _ReduceFromAxis.apply(x, axis.group)


def gather_from_axis(x, axis, dim=-1):
    """The ranks' slices concatenated along ``dim`` forward; this rank's
    slice of the gradient backward."""
    if axis.size == 1:
        return x
    return _GatherFromAxis.apply(x, axis.group, axis.index, dim % x.dim())


def _sharded(layer, attr, shape, x, spec, init, dtype=None):
    """Parameter ``attr`` of ``layer``, made at its global ``shape``,
    filled by ``init`` and sliced by ``spec`` over the layer's plan (the
    whole of it without a plan); it keeps ``spec`` as its
    ``partition_spec``."""
    p = new_param(shape, x, dtype)
    init(p)
    plan = layer.plan
    if plan is None:
        return p
    local = torch.nn.Parameter(shard_array(p.data, plan.mesh, spec,
                                           name=f"{layer.name}.{attr}"))
    local.partition_spec = spec
    return local


class ColumnParallelLinear(Layer):
    """``y = x @ W + b`` with W's output dim sharded over ``model``;
    ``gather_output`` all-gathers y (else y stays sharded on its last
    dim, for a row-parallel or other column-sharded consumer)."""

    def __init__(self, out_features, plan=None, bias=True,
                 gather_output=False):
        super().__init__()
        self.out_features = int(out_features)
        self.plan = plan
        self.has_bias = bool(bias)
        self.gather_output = bool(gather_output)

    def initialize(self, x):
        dt = amp.param_dtype(x.dtype)
        gen = device_of(x).generator
        self.W = _sharded(self, "W", (x.shape[-1], self.out_features), x,
                          P(None, MODEL),
                          lambda t: initializer.xavier(t, generator=gen), dt)
        if self.has_bias:
            self.b = _sharded(self, "b", (self.out_features,), x, P(MODEL),
                              initializer.zeros, dt)

    def forward(self, x):
        axis = None if self.plan is None else self.plan.mesh.axis(MODEL)
        if axis is not None:
            x = copy_to_axis(x, axis)
        y = autograd.matmul(x, self.W)
        if self.has_bias:
            y = autograd.add_bias(y, self.b)
        if axis is not None and self.gather_output:
            y = gather_from_axis(y, axis)
        return y


class RowParallelLinear(Layer):
    """``y = x @ W + b`` with W's input dim sharded over ``model``: the
    partial products are summed over ``model`` and the (replicated) bias
    is added after the sum."""

    def __init__(self, out_features, plan=None, bias=True):
        super().__init__()
        self.out_features = int(out_features)
        self.plan = plan
        self.has_bias = bool(bias)

    def initialize(self, x):
        dt = amp.param_dtype(x.dtype)
        gen = device_of(x).generator
        tp = 1 if self.plan is None else self.plan.axis_size(MODEL)
        self.W = _sharded(self, "W", (x.shape[-1] * tp, self.out_features),
                          x, P(MODEL, None),
                          lambda t: initializer.xavier(t, generator=gen), dt)
        if self.has_bias:
            self.b = initializer.zeros(new_param((self.out_features,), x,
                                                 dt))

    def forward(self, x):
        y = autograd.matmul(x, self.W)
        if self.plan is not None:
            y = reduce_from_axis(y, self.plan.mesh.axis(MODEL))
        if self.has_bias:
            y = autograd.add_bias(y, self.b)
        return y


class VocabParallelEmbedding(Layer):
    """Token embedding table (vocab, dim), float32, N(0, std), its rows
    sharded over ``model``."""

    def __init__(self, vocab_size, embed_dim, plan=None, std=0.02):
        super().__init__()
        self.vocab_size = int(vocab_size)
        self.embed_dim = int(embed_dim)
        self.plan = plan
        self.std = float(std)

    def initialize(self, ids):
        gen = device_of(ids).generator
        self.W = _sharded(
            self, "W", (self.vocab_size, self.embed_dim), ids, P(MODEL, None),
            lambda t: initializer.gaussian(t, 0.0, self.std, generator=gen))

    def forward(self, ids):
        axis = None if self.plan is None else self.plan.mesh.axis(MODEL)
        if axis is None or axis.size == 1:
            return autograd.embedding(ids, self.W)
        rows = self.W.shape[0]
        local = ids.long() - axis.index * rows
        inside = (local >= 0) & (local < rows)
        e = autograd.embedding(torch.where(inside, local, 0), self.W)
        e = e * inside[..., None].to(e.dtype)
        return reduce_from_axis(e, axis)


class ParallelMLP(Layer):
    """Transformer FFN: column fc1 -> activation -> row fc2."""

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
    serves a contiguous group of query heads (``autograd.repeat_kv``).

    Under a plan the heads are sharded over ``model``, and with a ``seq``
    axis longer than 1 (``seq_parallel``, its default then) attention
    runs on the ring: the zigzag layout for causal attention without a
    mask at an even local length, else the contiguous ring (a key-padding
    mask rotates with its K/V).  Without a seq axis the flash kernels
    run on the rank's heads, where the JAX package drops flash for its
    fused path (it has no GSPMD rule for ``pallas_call``)."""

    def __init__(self, num_heads, plan=None, dropout=0.0, seq_parallel=None,
                 causal=False, remat=False, use_flash=False,
                 num_kv_heads=None, window=None):
        super().__init__()
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
        self.plan = plan
        self.dropout = float(dropout)
        self.causal = bool(causal)
        self.remat = bool(remat)
        self.use_flash = bool(use_flash)
        if seq_parallel is None:
            seq_parallel = plan is not None and plan.axis_size(SEQ) > 1
        if seq_parallel and plan is None:
            raise ValueError("seq_parallel needs a plan whose mesh has a "
                             "seq axis")
        self.seq_parallel = bool(seq_parallel)
        self.q_proj = ColumnParallelLinear(0, plan)
        self.k_proj = ColumnParallelLinear(0, plan)
        self.v_proj = ColumnParallelLinear(0, plan)
        self.out_proj = RowParallelLinear(0, plan)
        if plan is not None:
            for what, n in (("num_heads", self.num_heads),
                            ("num_kv_heads", self.num_kv_heads)):
                if n % plan.axis_size(MODEL) != 0:
                    raise ValueError(
                        f"{what} {n} not divisible by model-axis "
                        f"size {plan.axis_size(MODEL)}")

    def initialize(self, x, mask=None):
        e = x.shape[-1]
        if e % self.num_heads != 0:
            raise ValueError(
                f"embed dim {e} not divisible by num_heads {self.num_heads}")
        e_kv = (e // self.num_heads) * self.num_kv_heads
        self.q_proj.out_features = self.out_proj.out_features = e
        self.k_proj.out_features = self.v_proj.out_features = e_kv

    def _attend(self, q, k, v, mask):
        if self.seq_parallel:
            if self.window is not None:
                raise NotImplementedError(
                    "sliding-window attention is not implemented on the "
                    "ring sequence-parallel path (a band never needs most "
                    "of the ring's hops): use a plan without a seq axis "
                    "for windowed models, or drop window for ring "
                    "attention")
            return _ring_attention_op(q, k, v, mask, self.plan, self.causal,
                                      use_flash=self.use_flash)
        return _sdpa(q, k, v, mask, self.causal, remat=self.remat,
                     use_flash=self.use_flash, window=self.window)

    def forward(self, x, mask=None):
        b, s, e = x.shape
        tp = 1 if self.plan is None else self.plan.axis_size(MODEL)
        h, h_kv = self.num_heads // tp, self.num_kv_heads // tp
        d = e // self.num_heads

        def split_heads(t, nh):
            t = autograd.transpose(autograd.reshape(t, (b, s, nh, d)),
                                   (0, 2, 1, 3))
            if nh != h:
                t = autograd.repeat_kv(t, h // nh)
            return t

        q = split_heads(self.q_proj(x), h)
        k = split_heads(self.k_proj(x), h_kv)
        v = split_heads(self.v_proj(x), h_kv)
        ctx = self._attend(q, k, v, mask)
        ctx = autograd.reshape(autograd.transpose(ctx, (0, 2, 1, 3)),
                               (b, s, h * d))
        ctx = autograd.dropout(ctx, self.dropout, training=self.training)
        return self.out_proj(ctx)


class ParallelTransformerBlock(Layer):
    """Pre-LN transformer block: ``x + attn(ln1(x))``, then
    ``x + mlp(ln2(x))``.  With ``moe_experts`` the MLP is a
    ``parallel.moe.MoEFFN`` of that many experts (``moe_top_k``,
    ``moe_capacity_factor``, ``moe_groups``)."""

    def __init__(self, num_heads, intermediate, plan=None, dropout=0.0,
                 causal=False, eps=1e-5, moe_experts=None, moe_top_k=2,
                 moe_capacity_factor=1.25, moe_groups=None, remat=False,
                 use_flash=False, num_kv_heads=None, window=None):
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
        self._moe = (None if moe_experts is None
                     else (int(moe_experts), int(moe_top_k),
                           float(moe_capacity_factor), moe_groups))
        self._remat = bool(remat)

    def initialize(self, x, mask=None):
        if self._moe is not None:
            from .moe import MoEFFN

            e, k, cf, g = self._moe
            self.mlp = MoEFFN(e, self._intermediate, self._plan, top_k=k,
                              capacity_factor=cf, groups=g,
                              remat=self._remat)
        else:
            self.mlp = ParallelMLP(x.shape[-1], self._intermediate,
                                   self._plan)

    @property
    def aux_loss(self):
        """The MoE load-balance loss of the last forward (None for a
        dense block)."""
        return getattr(self.mlp, "last_aux_loss", None)

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
    # a float32 mask over bf16 scores promotes p to float32, and then the
    # product too, as jnp's type promotion does
    return torch.einsum("bhst,bhtd->bhsd", p, v.to(p.dtype))


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
    apply = autograd.checkpoint_op if remat else autograd._op
    return apply(_attention_plain, *xs, _name="TPAttention",
                 scale=1.0 / math.sqrt(q.shape[-1]), causal=causal,
                 window=window)


def _ring_attention_op(q, k, v, mask, plan, causal, use_flash=False):
    """Attention of this rank's (B, H, S_local, D) blocks against the
    whole sequence, over the plan's ``seq`` ring
    (``parallel/ring_attention.py``): causal without a mask at an even
    local length in the balanced zigzag layout (the blocks repartitioned
    in and back out), else the contiguous ring, a (B, 1, 1, S) key-padding
    mask rotating with its K/V; a mask with a query dim raises."""
    from .ring_attention import (ring_self_attention, zigzag_repartition,
                                 zigzag_ring_self_attention)

    axis = plan.mesh.axis(SEQ)
    if causal and mask is None and axis.size > 1 and q.shape[2] % 2 == 0:
        q, k, v = (zigzag_repartition(t, axis) for t in (q, k, v))
        o = zigzag_ring_self_attention(q, k, v, axis, use_flash=use_flash)
        return zigzag_repartition(o, axis, inverse=True)
    if mask is not None and mask.shape[-2] != 1:
        raise NotImplementedError(
            "ring attention supports key-padding masks (B,1,1,S); "
            "per-query masks need seq_parallel=False")
    return ring_self_attention(q, k, v, axis, causal=causal, kv_mask=mask,
                               use_flash=use_flash)
