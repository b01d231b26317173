"""Mixture-of-Experts FFN (counterpart of ``singa_tpu/parallel/moe.py``),
GShard/Switch formulation, serial path only.

* tokens split into G routing groups (``groups=``, default 1); routing and
  capacity are per group, ``C = ceil(k·n/E·capacity_factor)`` for n
  tokens a group;
* token-choice top-1 (Switch) or top-2 (GShard) gating with static
  capacity, routed in float32 (bf16 cumsum positions go wrong past 256);
* dispatch and combine are one-hot products ``(G,n,E,C)×(G,n,D)→
  (G,E,C,D)`` and back, the experts one batched product over (G, E),
  all ``torch.einsum``: plain products, as XLA generated them, so no
  hand-written kernel is owed;
* the load-balance loss (mean first-choice fraction × mean router
  probability, times E, so a uniform router scores 1) is
  ``last_aux_loss`` after each forward, for the model to add to its
  objective; it carries gradients into the router.

Tokens over capacity are dropped (combine weight zero; the residual path
carries them).  Parameters are named and laid out as in the JAX package
(``Wg`` (D, E), ``W1`` (E, D, F), ``b1`` (E, F), ``W2`` (E, F, D), ``b2``
(E, D)), so states carry across.  Under a ``ShardingPlan``
(``parallel/sharding.py``) each data rank routes its own tokens: its rows
are one of the JAX package's routing groups (the data-axis size by
default), so the layer runs as it does serially on them; expert, model
and seq axes longer than 1 raise ``NotImplementedError``.
Nothing here reads a device value on the host, so a training step
through it can be captured.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import amp, autograd, initializer
from ..device import device_of
from ..layer import Layer, new_param
from .sharding import DATA, EXPERT, MODEL, SEQ

__all__ = ["MoEFFN", "dispatch_load"]


def _one_hot(idx, n, dtype):
    """``jax.nn.one_hot``: rows of zeros for indices outside [0, n) (a
    position past capacity), with no host check of the indices."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def dispatch_load(dispatch, top_k):
    """``(tokens_per_expert (E,) int32, dropped int32)`` from a dispatch
    one-hot (N, E, C) (or (G, N, E, C)): the assignments each expert kept,
    and how many of the ``top_k · N`` assignments capacity turned away."""
    tok = dispatch.shape[-3] * math.prod(dispatch.shape[:-3])
    kept = dispatch.sum(dim=(*range(dispatch.dim() - 2), -1))
    dropped = top_k * tok - kept.sum()
    return (torch.round(kept).to(torch.int32),
            torch.round(dropped).to(torch.int32))


def _aux(probs, mask1):
    e = probs.shape[-1]
    frac = mask1.mean(dim=-2)
    pmean = probs.mean(dim=-2)
    return (frac * pmean).sum(-1) * e


def _top1_dispatch(probs, capacity):
    """Switch top-1 routing.  ``probs`` (…, N, E) router softmax; returns
    (dispatch (…, N, E, C) 0/1, combine (…, N, E, C) gate-weighted, aux
    (…) load-balance loss)."""
    e = probs.shape[-1]
    mask1 = _one_hot(probs.argmax(-1), e, probs.dtype)
    gate1 = (probs * mask1).sum(-1)
    aux = _aux(probs, mask1)
    pos1 = torch.cumsum(mask1, dim=-2) * mask1 - mask1
    keep1 = mask1 * (pos1 < capacity)
    cap1 = _one_hot(pos1.sum(-1).to(torch.int32), capacity, probs.dtype)
    dispatch = keep1[..., None] * cap1[..., None, :]
    return dispatch, gate1[..., None, None] * dispatch, aux


def _top2_dispatch(probs, capacity):
    """GShard top-2 routing; the two gates renormalized over what
    survived capacity.  Second choices take the positions after the
    surviving first choices of their expert."""
    e = probs.shape[-1]
    mask1 = _one_hot(probs.argmax(-1), e, probs.dtype)
    gate1 = (probs * mask1).sum(-1)
    probs2 = probs * (1.0 - mask1)
    mask2 = _one_hot(probs2.argmax(-1), e, probs.dtype)
    gate2 = (probs2 * mask2).sum(-1)
    aux = _aux(probs, mask1)

    pos1 = torch.cumsum(mask1, dim=-2) * mask1 - mask1
    count1 = mask1.sum(dim=-2, keepdim=True)
    pos2 = (torch.cumsum(mask2, dim=-2) - mask2
            + torch.clamp(count1, max=capacity)) * mask2
    keep1 = mask1 * (pos1 < capacity)
    keep2 = mask2 * (pos2 < capacity)

    g1 = gate1 * keep1.sum(-1)
    g2 = gate2 * keep2.sum(-1)
    denom = g1 + g2
    denom = torch.where(denom <= 0.0, torch.ones_like(denom), denom)
    g1, g2 = g1 / denom, g2 / denom

    cap1 = _one_hot(pos1.sum(-1).to(torch.int32), capacity, probs.dtype)
    cap2 = _one_hot(pos2.sum(-1).to(torch.int32), capacity, probs.dtype)
    d1 = keep1[..., None] * cap1[..., None, :]
    d2 = keep2[..., None] * cap2[..., None, :]
    combine = g1[..., None, None] * d1 + g2[..., None, None] * d2
    return d1 + d2, combine, aux


def _einsum(eq, a, b):
    """``jnp.einsum``'s type promotion: both operands in their common
    dtype (a bf16 activation against a float32 master weight under amp
    gives a float32 product, as in the JAX package)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def _gelu(t):
    return F.gelu(t, approximate="tanh")  # jax.nn.gelu's default


def _moe_ffn(x, wg, w1, b1, w2, b2, *, groups, capacity, top_k,
             activation):
    """The layer's function: ``(y, aux)`` for x (B, S, D)."""
    b, s, d = x.shape
    xt = x.reshape(groups, (b * s) // groups, d)
    probs = torch.softmax((xt @ wg.to(xt.dtype)).float(), dim=-1)
    route = _top2_dispatch if top_k == 2 else _top1_dispatch
    dispatch, combine, aux = route(probs, capacity)
    dispatch, combine = dispatch.to(xt.dtype), combine.to(xt.dtype)
    ein = torch.einsum("gnec,gnd->gecd", dispatch, xt)
    h = activation(_einsum("gecd,edf->gecf", ein, w1)
                   + b1[None, :, None, :])
    out = _einsum("gecf,efd->gecd", h, w2) + b2[None, :, None, :]
    y = _einsum("gnec,gecd->gnd", combine, out)
    return y.reshape(b, s, d), aux.mean().float()


class MoEFFN(Layer):
    """A transformer FFN of ``num_experts`` expert MLPs with top-k
    routing (module docstring).  ``remat`` recomputes the layer in the
    backward instead of keeping its dispatch tensors."""

    def __init__(self, num_experts, intermediate, plan=None, top_k=2,
                 capacity_factor=1.25, activation="gelu", remat=False,
                 groups=None):
        super().__init__()
        if plan is not None:
            long_axes = [a for a in (EXPERT, MODEL, SEQ)
                         if plan.axis_size(a) > 1]
            if long_axes:
                raise NotImplementedError(
                    f"MoEFFN under a plan routes each data rank's tokens "
                    f"as one group; a mesh whose {long_axes} axes are "
                    f"longer than 1 is not ported")
        if top_k not in (1, 2):
            raise ValueError("top_k must be 1 (Switch) or 2 (GShard)")
        self.num_experts = int(num_experts)
        self.intermediate = int(intermediate)
        self.plan = plan
        self.top_k = int(top_k)
        self.capacity_factor = float(capacity_factor)
        self.activation = activation
        self.remat = bool(remat)
        self.groups = None if groups is None else int(groups)
        self.last_aux_loss = None

    def initialize(self, x):
        d = x.shape[-1]
        e, f = self.num_experts, self.intermediate
        dt = amp.param_dtype(x.dtype)
        gen = device_of(x).generator

        def param(shape, std):
            p = new_param(shape, x, dt)
            if std == 0.0:
                return initializer.zeros(p)
            return initializer.gaussian(p, 0.0, std, generator=gen)

        self.Wg = param((d, e), 1.0 / math.sqrt(d))
        self.W1 = param((e, d, f), math.sqrt(2.0 / d))
        self.b1 = param((e, f), 0.0)
        self.W2 = param((e, f, d), math.sqrt(2.0 / f))
        self.b2 = param((e, d), 0.0)

    def _num_groups(self, n):
        """The routing groups of this rank's ``n`` tokens: ``groups`` (1
        by default); under a plan the data rank's share of them (the data
        axis's size by default, one a rank)."""
        g = 1 if self.groups is None else self.groups
        if self.plan is not None:
            dp = self.plan.axis_size(DATA)
            if g % dp and self.groups is not None:
                raise ValueError(f"MoE routing groups {g} not divisible by "
                                 f"data-axis size {dp}")
            g = max(1, g // dp)
        if n % g != 0:
            raise ValueError(f"MoE token count {n} not divisible by the "
                             f"{g} routing groups")
        return g

    def _capacity(self, n_per_group):
        return max(1, int(math.ceil(
            self.top_k * n_per_group / self.num_experts
            * self.capacity_factor)))

    def forward(self, x):
        b, s, _ = x.shape
        g = self._num_groups(b * s)
        apply = autograd.checkpoint_op if self.remat else autograd._op
        act = _gelu if self.activation == "gelu" \
            else getattr(F, self.activation)
        y, aux = apply(
            _moe_ffn, x, self.Wg, self.W1, self.b1, self.W2, self.b2,
            _name="MoEFFN", groups=g, capacity=self._capacity(b * s // g),
            top_k=self.top_k, activation=act)
        self.last_aux_loss = aux
        return y
