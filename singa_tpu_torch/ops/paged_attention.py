"""Paged decode attention (counterpart of ``_paged_attn``,
``singa_tpu/models/gpt2_decode.py:841``, the serve engine's hot loop).

``paged_attn`` attends every slot's queries over its KV blocks in one
layer's paged pool, in one launch of the kernel written by hand for
Hopper in ``singa_tpu_torch/csrc/paged_attention.cu``.
``paged_attn_plain`` is the plain PyTorch version: the JAX function's
loop over the table's blocks with the same online softmax, batched over
slots.  The wrapper takes the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.

Shapes (S slots, one layer):

* ``q`` (S, n_kv, g, Q, D): g query heads per kv head (GQA), Q query
  positions (1 for decode);
* ``pool_k``, ``pool_v`` (N + 1, n_kv, B, D): block N is the trash block;
* ``tables`` (S, W // B) int32 block ids, trash-padded; ``p_limit`` (S,)
  int32: pool lanes at positions < ``p_limit`` are attended;
* ``n_blk``: blocks ``[blk_lo, n_blk)`` of the tables are read, at least
  ``ceil(p_limit / B)`` for every slot;
* ``k_cur``, ``v_cur`` (S, n_kv, Q, D): the step's own K/V, not yet in
  the pool, under ``cur_mask`` (Q, Q) bool;
* ``window``: query i (at position ``p_limit + i``) sees only pool lanes
  at positions > ``p_limit + i - window``.

Returns (S, n_kv, g, Q, D) in the pool's dtype; sums are float32.  A
dead slot (all-trash table, ``p_limit`` 0) attends only its current
lanes.  int8 pools (the JAX function's per-block dequantisation) are
not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["NEG_INF", "MAX_ROWS", "HEAD_DIMS", "paged_attn",
           "paged_attn_plain"]

NEG_INF = -1e30
#: most query rows (g * Q) one kernel block holds
MAX_ROWS = 16
#: head dims the kernel takes
HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_attn_plain(q, pool_k, pool_v, tables, p_limit, n_blk, k_cur,
                     v_cur, cur_mask, scale, window=None, blk_lo=None):
    """Plain version of :func:`paged_attn`: ``_paged_attn``'s block loop
    with its online softmax (running max, rescaled sums), a slot
    dimension in place of the JAX package's vmap."""
    s_, n_kv, g, nq, d = q.shape
    trash = pool_k.shape[0] - 1
    block = pool_k.shape[2]
    dev = q.device
    qf = q.float()
    m = torch.full((s_, n_kv, g, nq), NEG_INF, device=dev)
    l = torch.zeros((s_, n_kv, g, nq), device=dev)
    acc = torch.zeros((s_, n_kv, g, nq, d), device=dev)
    p_limit = p_limit.to(device=dev, dtype=torch.long)
    qpos = p_limit[:, None] + torch.arange(nq, device=dev)       # (S, Q)

    def update(m, l, acc, sc, live, vb):
        sc = torch.where(live, sc, torch.full_like(sc, NEG_INF))
        m2 = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m2)
        pr = torch.exp(sc - m2[..., None])
        # explicit zero: a fully masked block leaves m2 at NEG_INF, and
        # exp(NEG_INF - NEG_INF) would be 1
        pr = torch.where(live, pr, torch.zeros_like(pr))
        l2 = l * alpha + pr.sum(-1)
        upd = torch.einsum("skgqb,skbd->skgqd", pr, vb.float())
        return m2, l2, acc * alpha[..., None] + upd

    for j in range(0 if blk_lo is None else int(blk_lo), int(n_blk)):
        blk = tables[:, j].to(device=dev, dtype=torch.long)
        kb, vb = pool_k[blk], pool_v[blk]                     # (S, H, B, D)
        sc = torch.einsum("skgqd,skbd->skgqb", qf, kb.float()) * scale
        lane = j * block + torch.arange(block, device=dev)
        live = (lane[None] < p_limit[:, None]) & (blk != trash)[:, None]
        if window is not None:
            live = live[:, None, :] & (lane[None, None, :]
                                       > qpos[:, :, None] - window)
            live = live[:, None, None]                     # (S, 1, 1, Q, B)
        else:
            live = live[:, None, None, None, :]
        m, l, acc = update(m, l, acc, sc, live, vb)
    sc = torch.einsum("skgqd,skbd->skgqb", qf, k_cur.float()) * scale
    live = cur_mask.to(dev, torch.bool)[None, None, None]
    m, l, acc = update(m, l, acc, sc, live, v_cur)
    return (acc / l[..., None]).to(pool_k.dtype)


# ------------------------------------------------------------------ kernel

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# q, pool_k, pool_v, tables, p_limit, k_cur, v_cur, cur_mask, out; S,
# n_kv, g, Q, D, block, table_width, trash, n_blk, blk_lo, window; scale;
# dtype; stream
_ARGTYPES = [_PTR] * 9 + [_INT] * 11 + [ctypes.c_float, _INT, _PTR]


def _lib():
    lib = _build.load("paged_attention")
    if not getattr(lib, "_typed", False):
        lib.paged_attention.argtypes = _ARGTYPES
        lib.paged_attention.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check_cuda(q, pool_k, pool_v, tables, p_limit, n_blk, k_cur, v_cur,
                cur_mask, blk_lo):
    """Raise on anything the kernel does not take; return its dtype
    code."""
    if pool_k.dtype not in _DTYPES:
        raise TypeError(f"paged_attn takes float32 or bfloat16 pools, got "
                        f"{pool_k.dtype} (int8 pools are not ported yet)")
    s_, n_kv, g, nq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"paged_attn takes head dims {HEAD_DIMS}, got {d}")
    if g * nq > MAX_ROWS:
        raise ValueError(f"paged_attn takes g * Q <= {MAX_ROWS} query rows "
                         f"a kv head, got g={g}, Q={nq}")
    nb1, h, block, d2 = pool_k.shape
    want = {"pool_k": (pool_k, (nb1, n_kv, block, d)),
            "pool_v": (pool_v, (nb1, n_kv, block, d)),
            "k_cur": (k_cur, (s_, n_kv, nq, d)),
            "v_cur": (v_cur, (s_, n_kv, nq, d))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != pool_k.dtype:
            raise ValueError(f"paged_attn: {name} must be {shape} "
                             f"{pool_k.dtype}, got {tuple(t.shape)} {t.dtype}")
    if q.dtype != pool_k.dtype:
        raise ValueError(f"paged_attn: q is {q.dtype}, the pool "
                         f"{pool_k.dtype}")
    if tables.dtype != torch.int32 or tables.dim() != 2 \
            or tables.shape[0] != s_:
        raise ValueError(f"paged_attn: tables must be int32 ({s_}, W // B), "
                         f"got {tables.dtype} {tuple(tables.shape)}")
    if p_limit.dtype != torch.int32 or tuple(p_limit.shape) != (s_,):
        raise ValueError(f"paged_attn: p_limit must be int32 ({s_},), got "
                         f"{p_limit.dtype} {tuple(p_limit.shape)}")
    if cur_mask.dtype != torch.bool or tuple(cur_mask.shape) != (nq, nq):
        raise ValueError(f"paged_attn: cur_mask must be bool ({nq}, {nq}), "
                         f"got {cur_mask.dtype} {tuple(cur_mask.shape)}")
    if not 0 <= (blk_lo or 0) <= n_blk <= tables.shape[1]:
        raise ValueError(f"paged_attn: need 0 <= blk_lo <= n_blk <= "
                         f"{tables.shape[1]}, got {blk_lo}, {n_blk}")
    for t in (q, pool_k, pool_v, tables, p_limit, k_cur, v_cur, cur_mask):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("paged_attn needs contiguous tensors on one "
                             "device")
    for t in (pool_k, pool_v):
        if t.data_ptr() % 16:
            raise ValueError("paged_attn reads pool rows 16 bytes at a "
                             "time: the pools must be 16-byte aligned")
    return _DTYPES[pool_k.dtype]


def paged_attn(q, pool_k, pool_v, tables, p_limit, n_blk, k_cur, v_cur,
               cur_mask, scale, window=None, blk_lo=None):
    """Online-softmax attention of every slot's queries over its paged
    KV (shapes in the module docstring); one kernel launch for all
    slots and kv heads."""
    if q.device.type == "cpu":
        return paged_attn_plain(q, pool_k, pool_v, tables, p_limit, n_blk,
                                k_cur, v_cur, cur_mask, scale, window,
                                blk_lo)
    dt = _check_cuda(q, pool_k, pool_v, tables, p_limit, n_blk, k_cur,
                     v_cur, cur_mask, blk_lo)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    s_, n_kv, g, nq, d = q.shape
    out = torch.empty_like(q)
    if s_ == 0:
        return out
    err = _lib().paged_attention(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        tables.data_ptr(), p_limit.data_ptr(), k_cur.data_ptr(),
        v_cur.data_ptr(), cur_mask.data_ptr(), out.data_ptr(), s_, n_kv, g,
        nq, d, pool_k.shape[2], tables.shape[1], pool_k.shape[0] - 1,
        int(n_blk), int(blk_lo or 0), int(window or 0), float(scale), dt,
        torch.cuda.current_stream(q.device).cuda_stream)
    paged_attn.launches += 1
    if err != 0:
        raise RuntimeError(f"paged_attn: CUDA error {err} at launch")
    return out


paged_attn.launches = 0
