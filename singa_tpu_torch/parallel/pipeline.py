"""Pipeline parallelism: the GPipe microbatch schedule over the ``pipe``
mesh axis (counterpart of ``singa_tpu/parallel/pipeline.py``).

* The L identical blocks' parameters are stacked (L, ...) tensors, each
  sharded ``P(pipe, ...)``: a rank holds its L/P layers and runs them in
  turn.
* The batch splits into M microbatches; a stage's output goes one hop
  forward a tick, M + P − 1 ticks in all (bubble (P − 1)/(M + P − 1)).
  The hop is a ``torch.autograd.Function`` whose backward is the reverse
  hop, and every rank issues every hop, paired by
  ``batch_isend_irecv`` (``communicator.exchange``) in the same order, so
  the backward, which runs the hops in reverse order on every rank,
  cannot deadlock.
* The last stage's outputs are broadcast to every pipe rank, so each
  computes the same head and loss; the broadcast's backward keeps the
  last stage's gradient alone, and the input's gradient (stage 0's) is
  summed over the pipe ranks, so a parameter outside the pipeline gets
  the same gradient on every pipe rank.

Each rank's microbatches are its own rows of the batch (``data``
sharding is the model's input slicing), which re-batches a per-row
function and changes no result.  The block runs plain attention, as the
JAX block does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import amp, initializer
from ..device import device_of
from ..layer import Layer, new_param
from . import communicator as _comm
from .sharding import DATA, PIPE, P, shard_array
from .tensor_parallel import copy_to_axis

__all__ = ["gpipe_spmd", "PipelinedTransformer"]


class _Hop(torch.autograd.Function):
    """This rank's ``y`` to the next pipe rank; returns the previous
    rank's (zeros on the first).  Backward: the reverse hop."""

    @staticmethod
    def forward(ctx, y, axis):
        ctx.axis = axis
        return _hop(y, axis, forward=True)

    @staticmethod
    def backward(ctx, g):
        return _hop(g.contiguous(), ctx.axis, forward=False), None


def _hop(y, axis, forward):
    i, n = axis.index, axis.size
    to, frm = (i + 1, i - 1) if forward else (i - 1, i + 1)
    out = torch.zeros_like(y)
    _comm.exchange([(y.contiguous(), axis.ranks[to], 0)]
                   if 0 <= to < n else [],
                   [(out, axis.ranks[frm], 0)] if 0 <= frm < n else [],
                   axis.group, op="pipe_hop")
    return out


class _FromLast(torch.autograd.Function):
    """The last pipe rank's ``x`` on every pipe rank; backward keeps the
    last rank's gradient (every rank's loss is the same one)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.last = axis.index == axis.size - 1
        out = x.contiguous().clone()
        return _comm.group_broadcast(out, axis.ranks[-1], axis.group,
                                     op="pipe_broadcast")

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None


def gpipe_spmd(stage_fn, stage_params, x_mb, axis):
    """Run the GPipe schedule over ``axis`` (a ``sharding.Axis``).

    ``stage_fn(stage_params, x) -> y`` (shape-preserving) runs this
    rank's stage; ``x_mb`` (M, mb, ...) is the microbatched input,
    identical on every pipe rank.  Returns the last stage's (M, mb, ...)
    outputs on every pipe rank."""
    world, rank = axis.size, axis.index
    m_count = x_mb.shape[0]
    if world == 1:
        return torch.stack([stage_fn(stage_params, x_mb[m])
                            for m in range(m_count)])
    x_mb = copy_to_axis(x_mb, axis)
    first = float(rank == 0)
    last = float(rank == world - 1)
    buf = torch.zeros_like(x_mb[0])
    outs = [None] * m_count
    for t in range(m_count + world - 1):
        # stage 0 takes microbatch t (zeros past M); the others take what
        # the previous stage sent.  Every rank uses both terms, so every
        # rank's graph holds every hop
        x0 = x_mb[t] if t < m_count else torch.zeros_like(x_mb[0])
        y = stage_fn(stage_params, x0 * first + buf * (1.0 - first))
        m = t - (world - 1)
        if m >= 0:
            outs[m] = y * last
        if t < m_count + world - 2:
            buf = _Hop.apply(y, axis)
    return _FromLast.apply(torch.stack(outs), axis)


def _block_apply(lp, h, num_heads, causal, eps):
    """One pre-LN transformer block over a layer's parameter dict (one
    layer's slice of the stacked parameters), plain attention; each
    product in the wider of its operands' types, as jnp promotes them."""
    mb, s, d = h.shape
    hd = d // num_heads

    def ln(x, g, b):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * g + b

    def proj(x, w, b):
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt) + b

    x = ln(h, lp["ln1_g"], lp["ln1_b"])
    q, k, v = (proj(x, lp[f"w{n}"], lp[f"b{n}"]).reshape(
        mb, s, num_heads, hd).transpose(1, 2) for n in "qkv")
    sc = torch.einsum("bhsd,bhtd->bhst", q, k) / math.sqrt(hd)
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
        sc = torch.where(keep, sc, torch.full_like(sc, -1e30))
    p = torch.softmax(sc, dim=-1)
    ctx = torch.einsum("bhst,bhtd->bhsd", p, v).transpose(1, 2) \
        .reshape(mb, s, d)
    h = h + proj(ctx, lp["wo"], lp["bo"])
    x = ln(h, lp["ln2_g"], lp["ln2_b"])
    f = F.gelu(proj(x, lp["w1"], lp["b1"]), approximate="tanh")
    return h + proj(f, lp["w2"], lp["b2"])


_PARAM_ORDER = ("ln1_g", "ln1_b", "wq", "bq", "wk", "bk", "wv", "bv",
                "wo", "bo", "ln2_g", "ln2_b", "w1", "b1", "w2", "b2")


class PipelinedTransformer(Layer):
    """L pre-LN transformer blocks run as a GPipe pipeline over the
    ``pipe`` mesh axis (one after another when ``plan`` is None or its
    pipe axis is 1).  Parameters are stacked (L, ...) tensors sharded
    ``P(pipe, ...)``; ``remat`` recomputes each block in the backward."""

    def __init__(self, num_layers, num_heads, intermediate, plan=None,
                 num_microbatches=None, causal=True, eps=1e-5, remat=False):
        super().__init__()
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.intermediate = int(intermediate)
        self.plan = plan
        self.causal = bool(causal)
        self.eps = float(eps)
        self.remat = bool(remat)
        pp = 1 if plan is None else plan.axis_size(PIPE)
        if self.num_layers % pp != 0:
            raise ValueError(
                f"num_layers {self.num_layers} not divisible by pipe-axis "
                f"size {pp}")
        self.num_microbatches = (int(num_microbatches)
                                 if num_microbatches else 2 * pp)

    def initialize(self, x):
        d, f, ll = x.shape[-1], self.intermediate, self.num_layers
        dt = amp.param_dtype(x.dtype)
        gen = device_of(x).generator

        def param(name, shape, std, ones=False):
            spec = P(*([PIPE] + [None] * len(shape)))
            t = new_param((ll,) + shape, x, dt)
            if ones:
                initializer.ones(t)
            elif std > 0:
                initializer.gaussian(t, 0.0, std, generator=gen)
            else:
                initializer.zeros(t)
            if self.plan is not None:
                t = torch.nn.Parameter(shard_array(
                    t.data, self.plan.mesh, spec, name=f"{self.name}.{name}"))
                t.partition_spec = spec
            setattr(self, name, t)

        sd = 0.02
        for name, shape, std, ones in (
                ("ln1_g", (d,), 0, True), ("ln1_b", (d,), 0, False),
                ("wq", (d, d), sd, False), ("bq", (d,), 0, False),
                ("wk", (d, d), sd, False), ("bk", (d,), 0, False),
                ("wv", (d, d), sd, False), ("bv", (d,), 0, False),
                ("wo", (d, d), sd, False), ("bo", (d,), 0, False),
                ("ln2_g", (d,), 0, True), ("ln2_b", (d,), 0, False),
                ("w1", (d, f), sd, False), ("b1", (f,), 0, False),
                ("w2", (f, d), sd, False), ("b2", (d,), 0, False)):
            param(name, shape, std, ones)

    def _stage_fn(self):
        nh, causal, eps, remat = self.num_heads, self.causal, self.eps, \
            self.remat

        def stage(params, x):
            for i in range(params["wq"].shape[0]):
                lp = {n: p[i] for n, p in params.items()}
                if remat:
                    x = torch.utils.checkpoint.checkpoint(
                        _block_apply, lp, x, nh, causal, eps,
                        use_reentrant=False)
                else:
                    x = _block_apply(lp, x, nh, causal, eps)
            return x

        return stage

    def forward(self, x):
        b, s, d = x.shape
        params = {n: getattr(self, n) for n in _PARAM_ORDER}
        stage = self._stage_fn()
        plan = self.plan
        if plan is None or plan.axis_size(PIPE) == 1:
            return stage(params, x)
        m_count = self.num_microbatches
        dp = plan.axis_size(DATA)
        if (b * dp) % m_count != 0:
            raise ValueError(f"batch {b * dp} not divisible by "
                             f"num_microbatches {m_count}")
        if b % m_count != 0:
            raise ValueError(f"microbatch {b * dp // m_count} not divisible "
                             f"by data-axis size {dp}")
        y = gpipe_spmd(stage, params, x.reshape(m_count, b // m_count, s, d),
                       plan.mesh.axis(PIPE))
        return y.reshape(b, s, d)
