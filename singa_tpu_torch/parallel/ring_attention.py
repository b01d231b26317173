"""Ring attention: sequence parallelism over a mesh axis (counterpart of
``singa_tpu/parallel/ring_attention.py``).

Each rank of the ``seq`` axis holds one block of the sequence.  Q stays
put; K/V (and a key-padding mask) travel one hop round the ring at a
time, and every hop's partial attention, normalized with its own lse,
merges into the rank's rows in float32 by the lse: with ``m`` the
running maximum, ``o = Σ o_t·e^(lse_t − m) / Σ e^(lse_t − m)``.

Each hop's attention is one square call of the flash functions
(``ops/flash_attention.py``): with ``use_flash`` the Hopper kernels on
CUDA tensors (their plain versions on CPU tensors), else the plain
versions everywhere, which compute the same function.  Causal hops
specialize by the block's place: the diagonal hop is causal, a hop from
an earlier rank dense, one from a later rank launches nothing.  The
zigzag layout (rank r holds the half-stripes r and 2W − 1 − r) balances
the causal work: every hop costs every rank two (h × h) half-pairs, the
diagonal hop three.

The ring is one ``torch.autograd.Function``: its forward keeps only the
local q, k, v, the merged output and the global lse, so a rank holds
O(S_local·D) for attention.  Its backward sends K/V round the ring once
more, with dK/dV accumulators beside them, and calls the dQ and dK/dV
functions on every hop with the global lse and ``delta = rowsum(dO∘O)``,
which makes each hop's share of the gradient exact.  A row with no live
key comes out 0 with a zero gradient, never NaN.  The hops travel
through ``communicator.exchange``: on the wire as they are over NCCL,
through host copies over gloo.  ``remat`` is accepted for the JAX
signature; the backward always recomputes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import communicator as _comm
from .sharding import SEQ, create_mesh
from .tensor_parallel import gather_from_axis

__all__ = [
    "NEG_INF", "ring_self_attention", "zigzag_order", "zigzag_repartition",
    "zigzag_ring_self_attention", "ring_causal_half_pairs_per_rank",
    "zigzag_ring_attention_sharded", "ring_attention_sharded",
]

NEG_INF = -1e30


def _functions(use_flash):
    """``(forward, dQ, dK/dV)``: the kernels' wrappers, or their plain
    versions."""
    from ..ops import flash_attention as fa

    if use_flash:
        return fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv
    return fa.flash_fwd_plain, fa.flash_bwd_dq_plain, fa.flash_bwd_dkv_plain


def _schedule(src, rank, causal, zigzag):
    """The (query part, key part, causal) square calls of the hop that
    holds rank ``src``'s K/V."""
    if zigzag:
        if src < rank:  # every local query is after the visiting low half
            return (("lo", "lo", False), ("hi", "lo", False))
        if src == rank:
            return (("lo", "lo", True), ("hi", "lo", False),
                    ("hi", "hi", True))
        # only the local high half attends, after both visiting halves
        return (("hi", "lo", False), ("hi", "hi", False))
    if not causal or src < rank:
        return (("all", "all", False),)
    if src == rank:
        return (("all", "all", True),)
    return ()


def _parts(t, zigzag):
    """``t`` (N, S, ...) as contiguous parts along dim 1: ``all``, or the
    zigzag halves ``lo`` and ``hi``."""
    if not zigzag:
        return {"all": t.contiguous()}
    h = t.shape[1] // 2
    return {"lo": t[:, :h].contiguous(), "hi": t[:, h:].contiguous()}


def _join(parts):
    return parts["all"] if "all" in parts else torch.cat(
        [parts["lo"], parts["hi"]], dim=1)


def _rotate(tensors: dict, axis) -> dict:
    """Every tensor of this rank to the next rank on ``axis``; returns
    those of the previous one."""
    keys = list(tensors)
    bufs = [torch.empty_like(tensors[k]) for k in keys]
    nxt, prv = axis.peer(1), axis.peer(-1)
    _comm.exchange([(tensors[k], nxt, i) for i, k in enumerate(keys)],
                   [(b, prv, i) for i, b in enumerate(bufs)], axis.group,
                   op="ring_hop")
    return dict(zip(keys, bufs))


def _bundle(k, v, kmask, zigzag):
    out = {}
    for name, t in (("k", k), ("v", v), ("m", kmask)):
        if t is not None:
            out.update({f"{name}:{p}": x
                        for p, x in _parts(t, zigzag).items()})
    return out


def _key_mask(cur, part, heads):
    m = cur.get(f"m:{part}")
    return None if m is None else m.repeat_interleave(heads, 0).contiguous()


class _Ring(torch.autograd.Function):
    """(B, H, S_local, D) q, k, v and an optional (B, S_local) float32
    additive key mask -> the attention of the local queries against the
    whole ring's keys (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, kmask, axis, causal, zigzag, use_flash):
        b, h, s, d = q.shape
        fwd = _functions(use_flash)[0]
        scale = 1.0 / math.sqrt(d)
        qp = _parts(q.reshape(b * h, s, d), zigzag)
        cur = _bundle(k.reshape(b * h, s, d), v.reshape(b * h, s, d), kmask,
                      zigzag)
        f32 = dict(dtype=torch.float32, device=q.device)
        acc = {a: torch.zeros(t.shape, **f32) for a, t in qp.items()}
        mx = {a: torch.full(t.shape[:2], NEG_INF, **f32)
              for a, t in qp.items()}
        den = {a: torch.zeros(t.shape[:2], **f32) for a, t in qp.items()}
        for t in range(axis.size):
            src = (axis.index - t) % axis.size
            for a, c, hop_causal in _schedule(src, axis.index, causal,
                                              zigzag):
                o_t, lse_t = fwd(qp[a], cur[f"k:{c}"], cur[f"v:{c}"],
                                 _key_mask(cur, c, h), None, None, scale,
                                 hop_causal, None)
                m_new = torch.maximum(mx[a], lse_t)
                alpha = torch.exp(mx[a] - m_new)
                w = torch.exp(lse_t - m_new)
                acc[a] = acc[a] * alpha[..., None] \
                    + o_t.float() * w[..., None]
                den[a] = den[a] * alpha + w
                mx[a] = m_new
            if t < axis.size - 1:
                cur = _rotate(cur, axis)
        out, lse = {}, {}
        for a in qp:
            live = mx[a] > 0.5 * NEG_INF
            d_safe = torch.where(den[a] == 0.0, 1.0, den[a])
            out[a] = torch.where(live[..., None], acc[a] / d_safe[..., None],
                                 0.0).to(q.dtype)
            # a row without a live key recomputes p = exp(s - 1e30) = 0
            lse[a] = torch.where(live, mx[a] + torch.log(d_safe), -NEG_INF)
        o = _join(out)
        ctx.save_for_backward(q, k, v, kmask, o, _join(lse))
        ctx.cfg = (axis, causal, zigzag, use_flash)
        return o.reshape(b, h, s, d)

    @staticmethod
    def backward(ctx, do):
        q, k, v, kmask, o, lse = ctx.saved_tensors
        axis, causal, zigzag, use_flash = ctx.cfg
        b, h, s, d = q.shape
        _, bwd_dq, bwd_dkv = _functions(use_flash)
        scale = 1.0 / math.sqrt(d)
        do = do.reshape(b * h, s, d).to(o.dtype)
        delta = (do.float() * o.float()).sum(-1)
        qp = _parts(q.reshape(b * h, s, d), zigzag)
        rows = {n: _parts(t, zigzag) for n, t in (("do", do), ("lse", lse),
                                                  ("delta", delta))}
        cur = _bundle(k.reshape(b * h, s, d), v.reshape(b * h, s, d), kmask,
                      zigzag)
        dq = {a: torch.zeros(t.shape, dtype=torch.float32, device=q.device)
              for a, t in qp.items()}
        grads = {f"d{n}:{p}": torch.zeros(t.shape, dtype=torch.float32,
                                          device=q.device)
                 for n in ("k", "v") for p, t in qp.items()}
        for t in range(axis.size):
            src = (axis.index - t) % axis.size
            for a, c, hop_causal in _schedule(src, axis.index, causal,
                                              zigzag):
                args = (qp[a], cur[f"k:{c}"], cur[f"v:{c}"],
                        _key_mask(cur, c, h), None, None, scale, hop_causal,
                        None, rows["do"][a], rows["lse"][a],
                        rows["delta"][a])
                dq[a] += bwd_dq(*args).float()
                dk, dv = bwd_dkv(*args)
                grads[f"dk:{c}"] += dk.float()
                grads[f"dv:{c}"] += dv.float()
            if axis.size > 1:
                # the accumulators travel with their block and come home
                # after the last hop
                last = t == axis.size - 1
                moved = _rotate(grads if last else {**cur, **grads}, axis)
                grads = {n: moved[n] for n in grads}
                if not last:
                    cur = {n: moved[n] for n in cur}

        def whole(prefix):
            return _join({p: grads[f"{prefix}:{p}"] for p in qp}) \
                .to(q.dtype).reshape(b, h, s, d)

        return (_join(dq).to(q.dtype).reshape(b, h, s, d), whole("dk"),
                whole("dv"), None, None, None, None, None)


def _flat_key_mask(kv_mask, b, s):
    """(B, 1, 1, S_local) additive key mask -> (B, S_local) float32."""
    if kv_mask is None:
        return None
    if kv_mask.dim() != 4 or kv_mask.shape[1] != 1 \
            or kv_mask.shape[2] != 1 or kv_mask.shape[3] != s:
        raise ValueError(f"kv_mask must be (B, 1, 1, S_local) = "
                         f"({b}, 1, 1, {s}), got {tuple(kv_mask.shape)}")
    return kv_mask[:, 0, 0, :].expand(b, s).float().contiguous()


def ring_self_attention(q, k, v, axis, causal=False, kv_mask=None,
                        remat=True, use_flash=False):
    """q, k, v: this rank's (B, H, S_local, D) blocks, contiguous along
    ``axis`` (a ``sharding.Axis``, e.g. ``mesh.axis("seq")``); returns the
    attention of the local queries against the whole sequence, (B, H,
    S_local, D).  ``kv_mask``: an additive (B, 1, 1, S_local) mask over
    this rank's keys, which rotates with its K/V.  ``use_flash``: the
    Hopper kernels on each hop (module docstring)."""
    b, _, s, _ = q.shape
    return _Ring.apply(q, k, v, _flat_key_mask(kv_mask, b, s), axis,
                       bool(causal), False, bool(use_flash))


def zigzag_order(seqlen, world):
    """The gather index that puts a global sequence into the zigzag
    layout: 2W half-stripes, rank r holding stripes r and 2W − 1 − r."""
    if seqlen % (2 * world):
        raise ValueError(f"seqlen {seqlen} not divisible by 2*W={2*world}")
    h = seqlen // (2 * world)
    idx = []
    for r in range(world):
        idx.extend(range(r * h, (r + 1) * h))
        idx.extend(range((2 * world - 1 - r) * h, (2 * world - r) * h))
    return np.asarray(idx, np.int32)


def _zigzag_moves(world):
    """``(src, src_half, dst, dst_half)`` of every half-stripe: contiguous
    rank s holds stripes 2s and 2s + 1, zigzag rank r stripes r and
    2W − 1 − r."""
    moves = []
    for s in range(world):
        for half in (0, 1):
            j = 2 * s + half
            dst = (j, 0) if j < world else (2 * world - 1 - j, 1)
            moves.append((s, half, *dst))
    return moves


def _zigzag_move(x, axis, inverse):
    s2 = x.shape[2]
    if s2 % 2:
        raise ValueError(f"zigzag repartition needs an even local "
                         f"sequence length, got {s2}")
    if axis.size == 1:
        return x
    h = s2 // 2
    halves = [x[:, :, :h].contiguous(), x[:, :, h:].contiguous()]
    out = [torch.empty_like(halves[0]), torch.empty_like(halves[1])]
    moves = _zigzag_moves(axis.size)
    if inverse:
        moves = [(d, dh, s, sh) for s, sh, d, dh in moves]
    me = axis.index
    _comm.exchange(
        [(halves[sh], axis.ranks[d], dh) for s, sh, d, dh in moves
         if s == me],
        [(out[dh], axis.ranks[s], dh) for s, sh, d, dh in moves if d == me],
        axis.group, op="zigzag")
    return torch.cat(out, dim=2)


class _Zigzag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, inverse):
        ctx.axis, ctx.inverse = axis, inverse
        return _zigzag_move(x, axis, inverse)

    @staticmethod
    def backward(ctx, g):
        return _zigzag_move(g.contiguous(), ctx.axis, not ctx.inverse), \
            None, None


def zigzag_repartition(x, axis, inverse=False):
    """Contiguous per-rank blocks (B, H, 2h, ...) into the zigzag layout
    (or back, ``inverse``): each half-stripe moves once, so the wire per
    rank is one ring hop's block.  Differentiable (its backward is the
    other direction)."""
    return _Zigzag.apply(x, axis, bool(inverse))


def zigzag_ring_self_attention(q, k, v, axis, remat=True, use_flash=False):
    """Causal ring attention over zigzag-ordered blocks (B, H, 2h, D):
    every hop costs every rank the same square (h × h) half-pairs
    (``ring_causal_half_pairs_per_rank``)."""
    if q.shape[2] % 2:
        raise ValueError(f"zigzag blocks need an even local length, "
                         f"got {q.shape[2]}")
    return _Ring.apply(q, k, v, None, axis, True, True, bool(use_flash))


def ring_causal_half_pairs_per_rank(world, layout="zigzag"):
    """Per-rank work of one causal ring pass in dense (S_local/2)²
    half-pairs: uniform 2(W − 1) + 4 for ``zigzag``, 4(i + 1) for rank i
    of the ``contiguous`` layout."""
    if layout == "zigzag":
        return [2 * (world - 1) + 4] * world
    if layout == "contiguous":
        return [4 * (i + 1) for i in range(world)]
    raise ValueError(f"unknown layout {layout!r}")


#: (world, device) -> the one-axis mesh the ``*_sharded`` wrappers default
#: to (a mesh makes process groups, so it is made once)
_DEFAULT_MESHES = {}


def _default_mesh(axis_name, device):
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    key = (axis_name, world, str(device))
    if key not in _DEFAULT_MESHES:
        if axis_name != SEQ:
            raise ValueError(f"no default mesh over axis {axis_name!r}: "
                             f"pass mesh=")
        _DEFAULT_MESHES[key] = create_mesh(sp=world, device=device)
    return _DEFAULT_MESHES[key]


def _local(t, axis):
    n = t.shape[2] // axis.size
    return t[:, :, axis.index * n:(axis.index + 1) * n]


def zigzag_ring_attention_sharded(q, k, v, mesh=None, axis_name="seq",
                                  use_flash=False):
    """Causal zigzag ring attention over GLOBAL (B, H, S, D) arrays held
    by every rank: each takes its zigzag block, runs the ring and
    gathers the whole output back into sequence order."""
    mesh = mesh or _default_mesh(axis_name, q.device)
    axis = mesh.axis(axis_name)
    order = torch.from_numpy(zigzag_order(q.shape[2], axis.size)).long() \
        .to(q.device)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(len(order), device=q.device)
    blocks = [_local(t[:, :, order], axis) for t in (q, k, v)]
    o = zigzag_ring_self_attention(*blocks, axis, use_flash=use_flash)
    return gather_from_axis(o, axis, dim=2)[:, :, inv]


def ring_attention_sharded(q, k, v, mesh=None, axis_name="seq",
                           causal=False, use_flash=False):
    """Ring attention over GLOBAL (B, H, S, D) arrays held by every rank:
    each takes its contiguous block and the output is gathered back."""
    mesh = mesh or _default_mesh(axis_name, q.device)
    axis = mesh.axis(axis_name)
    o = ring_self_attention(*(_local(t, axis) for t in (q, k, v)), axis,
                            causal=causal, use_flash=use_flash)
    return gather_from_axis(o, axis, dim=2)
