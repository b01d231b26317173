"""Paged decode attention (counterpart of ``_paged_attn``,
``singa_tpu/models/gpt2_decode.py:841``, the serve engine's hot loop).

``paged_attn`` attends every slot's queries over its KV blocks in one
layer's paged pool through the kernels written by hand for Hopper in
``singa_tpu_torch/csrc/paged_attention.cu``: a split kernel over (kv
head, slot, split of the key range) and a combine kernel, one call and
one count in ``paged_attn.launches`` for both.
``paged_attn_plain`` is the plain PyTorch version: the JAX function's
loop over the table's blocks with the same online softmax, batched over
slots.  The wrapper takes the plain version only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.

Shapes (S slots, one layer):

* ``q`` (S, n_kv, g, Q, D): g query heads per kv head (GQA), Q query
  positions (1 for decode);
* ``pool_k``, ``pool_v`` (N + 1, n_kv, B, D): block N is the trash block;
* ``tables`` (S, W // B) int32 block ids, trash-padded; ``p_limit`` (S,)
  int32: pool lanes at positions < ``p_limit`` are attended.  Blocks
  ``[blk_lo, n_blk)`` of the tables are read, where ``n_blk =
  max(ceil(p_limit / B))`` over the slots (the JAX engine's traced
  ``n_blk``, ``singa_tpu/serve/paged.py:450``) is found on the device
  from ``p_limit``, and the table width bounds it.  The host never reads
  ``p_limit``, so a decode step captured in a CUDA graph stays right as
  its slots grow;
* ``k_cur``, ``v_cur`` (S, n_kv, Q, D): the step's own K/V, not yet in
  the pool, under ``cur_mask`` (Q, Q) bool;
* ``window``: query i (at position ``p_limit + i``) sees only pool lanes
  at positions > ``p_limit + i - window``.

Returns (S, n_kv, g, Q, D) in the pool's dtype; sums are float32.  A
dead slot (all-trash table, ``p_limit`` 0) attends only its current
lanes.  On the card: float32 or bf16, any D <= ``MAX_HEAD_DIM`` (1024)
and Q <= ``max_rows(D)`` (16, or 4 at D > 128); a GQA group of more than
``max_rows(D)`` query rows (g * Q) runs as several launches over groups
of heads, which is exact (query rows are independent).  The rest raises.
int8 pools: not ported.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["NEG_INF", "MAX_HEAD_DIM", "max_rows", "split_count",
           "launch_groups", "paged_attn", "paged_attn_plain"]

NEG_INF = -1e30
#: widest head the kernel takes (its rows are 16, 32, ..., 1024 wide; a
#: float32 row of 2048 would need 256 KB of shared memory for one tile)
MAX_HEAD_DIM = 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def max_rows(d):
    """Most query rows (g * Q) one kernel launch holds at head dim ``d``:
    16, or 4 at D > 128, where a lane's float32 sums would crowd the
    registers."""
    return 16 if d <= 128 else 4


def paged_attn_plain(q, pool_k, pool_v, tables, p_limit, k_cur, v_cur,
                     cur_mask, scale, window=None, blk_lo=None):
    """Plain version of :func:`paged_attn`: ``_paged_attn``'s block loop
    with its online softmax (running max, rescaled sums), a slot
    dimension in place of the JAX package's vmap.  It loops over every
    block of the tables: blocks past ``n_blk`` hold no live lane, and a
    block without one leaves the running state exactly as it was, so the
    result is the JAX function's at its ``n_blk``."""
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

    for j in range(0 if blk_lo is None else int(blk_lo), tables.shape[1]):
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
# q, pool_k, pool_v, tables, p_limit, k_cur, v_cur, cur_mask, out, ws; S,
# n_kv, g, Q, D, block, table_width, trash, n_blk (the bound: the table
# width), blk_lo, window, n_split; scale; dtype; stream
_ARGTYPES = [_PTR] * 10 + [_INT] * 12 + [ctypes.c_float, _INT, _PTR]


def _lib():
    lib = _build.load("paged_attention")
    if not getattr(lib, "_typed", False):
        type_library(lib)
        lib._typed = True
    return lib


def type_library(lib):
    """Declare the C entry points' ctypes types on ``lib`` (the built
    library, or the CPU emulator's build of the same source)."""
    lib.paged_attention.argtypes = _ARGTYPES
    lib.paged_attention.restype = ctypes.c_int
    # D, dtype, n_blk, blk_lo, block, S * n_kv, SMs
    lib.paged_split_count.argtypes = [_INT] * 7
    lib.paged_split_count.restype = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_count(d, dtype, n_blk, blk_lo, block, pairs, n_sm, lib=None):
    """Splits of the key range the kernel takes for one call (the C
    ``paged_split_count``): about 4 blocks an SM over ``pairs`` = S * n_kv
    (slot, kv head) pairs, each split at least 128 keys, from what the
    host knows: ``n_blk`` is the bound of the blocks read (the table
    width; no ``p_limit``, so no device sync)."""
    lib = lib or _lib()
    return lib.paged_split_count(d, _DTYPES[dtype], int(n_blk),
                                 int(blk_lo or 0), block, pairs, n_sm)


def _check_cuda(q, pool_k, pool_v, tables, p_limit, k_cur, v_cur, cur_mask,
                blk_lo):
    """Raise on anything the kernel does not take; return its dtype
    code."""
    if pool_k.dtype not in _DTYPES:
        raise TypeError(f"paged_attn takes float32 or bfloat16 pools, got "
                        f"{pool_k.dtype} (int8 pools are not ported yet)")
    s_, n_kv, g, nq, d = q.shape
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"paged_attn takes head dims up to {MAX_HEAD_DIM}, "
                         f"got {d}")
    if nq > max_rows(d):
        raise ValueError(f"paged_attn takes Q <= {max_rows(d)} query "
                         f"positions at D = {d}, got Q={nq}")
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
    if not 0 <= (blk_lo or 0) <= tables.shape[1]:
        raise ValueError(f"paged_attn: need 0 <= blk_lo <= the table width "
                         f"{tables.shape[1]}, got {blk_lo}")
    for t in (q, pool_k, pool_v, tables, p_limit, k_cur, v_cur, cur_mask):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("paged_attn needs contiguous tensors on one "
                             "device")
    return _DTYPES[pool_k.dtype]


def launch_groups(lib, q, pool_k, pool_v, tables, p_limit, k_cur, v_cur,
                  cur_mask, scale, window, blk_lo, n_sm, stream,
                  n_split=None, empty=torch.empty):
    """The split and combine kernels of ``lib`` (the built library, or
    the CPU emulator's build of the same source) over groups of at most
    ``max_rows(D)`` query rows, a group of heads of the GQA group each,
    concatenated: query rows are independent, so this is exact.  Each
    group's split count is the plan for ``n_sm`` SMs from the table width,
    or ``n_split``; ``empty`` allocates the output and the workspace.
    Returns ``(out, groups launched)``; raises on a CUDA error."""
    s_, n_kv, g, nq, d = q.shape
    heads = max(1, max_rows(d) // nq)
    block, n_blk = pool_k.shape[2], tables.shape[1]
    outs = []
    for h0 in range(0, g, heads):
        qg = q if g <= heads else q[:, :, h0:h0 + heads].contiguous()
        gg = qg.shape[2]
        ns = n_split or split_count(d, q.dtype, n_blk, blk_lo, block,
                                    s_ * n_kv, n_sm, lib)
        out = empty(qg.shape, dtype=qg.dtype, device=qg.device)
        ws = empty((s_ * n_kv * ns * gg * nq * (d + 2),),
                   dtype=torch.float32, device=qg.device)
        err = lib.paged_attention(
            qg.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            tables.data_ptr(), p_limit.data_ptr(), k_cur.data_ptr(),
            v_cur.data_ptr(), cur_mask.data_ptr(), out.data_ptr(),
            ws.data_ptr(), s_, n_kv, gg, nq, d, block, n_blk,
            pool_k.shape[0] - 1, n_blk, int(blk_lo or 0), int(window or 0),
            ns, float(scale), _DTYPES[pool_k.dtype], stream)
        if err != 0:
            raise RuntimeError(f"paged_attn: CUDA error {err} at launch")
        outs.append(out)
    return (outs[0] if len(outs) == 1 else torch.cat(outs, 2)), len(outs)


def paged_attn(q, pool_k, pool_v, tables, p_limit, k_cur, v_cur, cur_mask,
               scale, window=None, blk_lo=None):
    """Online-softmax attention of every slot's queries over its paged
    KV (shapes in the module docstring); for CUDA tensors, the split and
    combine kernels over all slots and kv heads, counted as one launch
    for each group of at most ``max_rows(D)`` query rows."""
    if q.device.type == "cpu":
        return paged_attn_plain(q, pool_k, pool_v, tables, p_limit, k_cur,
                                v_cur, cur_mask, scale, window, blk_lo)
    _check_cuda(q, pool_k, pool_v, tables, p_limit, k_cur, v_cur, cur_mask,
                blk_lo)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.shape[0] == 0:
        return torch.empty_like(q)
    out, groups = launch_groups(
        _lib(), q, pool_k, pool_v, tables, p_limit, k_cur, v_cur, cur_mask,
        scale, window, blk_lo, _sm_count(q.device.index or 0),
        torch.cuda.current_stream(q.device).cuda_stream)
    paged_attn.launches += groups
    return out


paged_attn.launches = 0
