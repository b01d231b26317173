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

int8 pools (the engine's ``cache_dtype="int8"``): ``pool_k``,
``pool_v``, ``k_cur`` and ``v_cur`` are (int8 values, float32 scales)
pairs, the scales of the values' shape without D; ``q`` stays float32
or bf16.  As in the JAX function, a score takes its K row's scale as it
is formed (``(q . k8) * kscale * scale``), the softmax sums ``l`` take
the probabilities unscaled, and a probability takes its V row's scale
only for the value product.

Returns (S, n_kv, g, Q, D) in q's dtype; sums are float32.  A
dead slot (all-trash table, ``p_limit`` 0) attends only its current
lanes.  On the card: float32 or bf16 pools, int8 pools with float32 or
bf16 q, any D <= ``MAX_HEAD_DIM`` (1024),
any GQA group and Q up to ``max_positions(D)`` (3632, or 14528 at
D > 128).  One launch holds ``max_rows(D)`` query rows (g * Q: 16, or 4
at D > 128); more run as several launches, over groups of heads and,
past ``max_rows(D)`` positions, runs of query positions, each taking all
Q current lanes and its rows of ``cur_mask``.  That is exact: query rows
are independent.  The rest raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["NEG_INF", "MAX_HEAD_DIM", "max_rows", "max_positions",
           "split_count", "launch_groups", "paged_attn", "paged_attn_plain"]

NEG_INF = -1e30
#: widest head the kernel takes (its rows are 16, 32, ..., 1024 wide; a
#: float32 row of 2048 would need 256 KB of shared memory for one tile)
MAX_HEAD_DIM = 1024
#: the C entry's dtype codes: (q, pool) float32, bf16; int8 pools with
#: float32 q, with bf16 q
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT8_CODES = {torch.float32: 2, torch.bfloat16: 3}


def max_rows(d):
    """Most query rows (g * Q) one kernel launch holds at head dim ``d``:
    16, or 4 at D > 128, where a lane's float32 sums would crowd the
    registers."""
    return 16 if d <= 128 else 4


#: the most dynamic shared memory an H100 block may opt into (227 KB)
MAX_SMEM_BYTES = 232448


def max_positions(d):
    """Most query positions Q a call takes at head dim ``d``: the combine
    kernel holds every current lane's score (float32) for its launch's
    ``max_rows(d)`` rows in shared memory."""
    return MAX_SMEM_BYTES // (4 * max_rows(d))


def _values(t):
    """The values of a pool or current K/V: itself, or the int8 values of
    a (values, scales) pair."""
    return t[0] if isinstance(t, tuple) else t


def _dtype_code(q, pool_k):
    """The C entry's dtype code for q and a pool (``_DTYPES``)."""
    if isinstance(pool_k, tuple):
        return _INT8_CODES[q.dtype]
    return _DTYPES[pool_k.dtype]


def paged_attn_plain(q, pool_k, pool_v, tables, p_limit, k_cur, v_cur,
                     cur_mask, scale, window=None, blk_lo=None):
    """Plain version of :func:`paged_attn`: ``_paged_attn``'s block loop
    with its online softmax (running max, rescaled sums), a slot
    dimension in place of the JAX package's vmap.  It loops over every
    block of the tables: blocks past ``n_blk`` hold no live lane, and a
    block without one leaves the running state exactly as it was, so the
    result is the JAX function's at its ``n_blk``.  int8 pools place
    their scales as the JAX function does (module docstring)."""
    quant = isinstance(pool_k, tuple)
    s_, n_kv, g, nq, d = q.shape
    trash = _values(pool_k).shape[0] - 1
    block = _values(pool_k).shape[2]
    dev = q.device
    qf = q.float()
    m = torch.full((s_, n_kv, g, nq), NEG_INF, device=dev)
    l = torch.zeros((s_, n_kv, g, nq), device=dev)
    acc = torch.zeros((s_, n_kv, g, nq, d), device=dev)
    p_limit = p_limit.to(device=dev, dtype=torch.long)
    qpos = p_limit[:, None] + torch.arange(nq, device=dev)       # (S, Q)

    def scores(kb):
        """q . K of one block or the current lanes, scaled: (S, H, g, Q,
        B); int8 takes each K row's scale first."""
        sc = torch.einsum("skgqd,skbd->skgqb", qf, _values(kb).float())
        if quant:
            sc = sc * kb[1][:, :, None, None, :]
        return sc * scale

    def update(m, l, acc, sc, live, vb):
        sc = torch.where(live, sc, torch.full_like(sc, NEG_INF))
        m2 = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m2)
        pr = torch.exp(sc - m2[..., None])
        # explicit zero: a fully masked block leaves m2 at NEG_INF, and
        # exp(NEG_INF - NEG_INF) would be 1
        pr = torch.where(live, pr, torch.zeros_like(pr))
        l2 = l * alpha + pr.sum(-1)
        if quant:
            pr = pr * vb[1][:, :, None, None, :]
        upd = torch.einsum("skgqb,skbd->skgqd", pr, _values(vb).float())
        return m2, l2, acc * alpha[..., None] + upd

    def rows(pool, blk):
        if quant:
            return pool[0][blk], pool[1][blk]
        return pool[blk]                                      # (S, H, B, D)

    for j in range(0 if blk_lo is None else int(blk_lo), tables.shape[1]):
        blk = tables[:, j].to(device=dev, dtype=torch.long)
        kb, vb = rows(pool_k, blk), rows(pool_v, blk)
        sc = scores(kb)
        lane = j * block + torch.arange(block, device=dev)
        live = (lane[None] < p_limit[:, None]) & (blk != trash)[:, None]
        if window is not None:
            live = live[:, None, :] & (lane[None, None, :]
                                       > qpos[:, :, None] - window)
            live = live[:, None, None]                     # (S, 1, 1, Q, B)
        else:
            live = live[:, None, None, None, :]
        m, l, acc = update(m, l, acc, sc, live, vb)
    live = cur_mask.to(dev, torch.bool)[None, None, None]
    m, l, acc = update(m, l, acc, scores(k_cur), live, v_cur)
    return (acc / l[..., None]).to(q.dtype)


# ------------------------------------------------------------------ kernel

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# q, pool_k, pool_v, their scales (int8), tables, p_limit, k_cur, v_cur,
# their scales (int8), cur_mask, out, ws; S, n_kv, g, the launch's query
# positions, all current lanes (Q), its first position, D, block,
# table_width, trash, n_blk (the bound: the table width), blk_lo, window,
# n_split; scale; dtype code; stream
_ARGTYPES = [_PTR] * 14 + [_INT] * 14 + [ctypes.c_float, _INT, _PTR]


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
    width; no ``p_limit``, so no device sync).  ``dtype``: the pool's
    element type (``torch.int8`` for int8 pools)."""
    lib = lib or _lib()
    code = _INT8_CODES[torch.float32] if dtype == torch.int8 \
        else _DTYPES[dtype]
    return lib.paged_split_count(d, code, int(n_blk), int(blk_lo or 0),
                                 block, pairs, n_sm)


def _check_cuda(q, pool_k, pool_v, tables, p_limit, k_cur, v_cur, cur_mask,
                blk_lo):
    """Raise on anything the kernel does not take; return its dtype
    code."""
    quant = isinstance(pool_k, tuple)
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_attn takes float32 or bfloat16 q, got "
                        f"{q.dtype}")
    s_, n_kv, g, nq, d = q.shape
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"paged_attn takes head dims up to {MAX_HEAD_DIM}, "
                         f"got {d}")
    if nq > max_positions(d):
        raise ValueError(f"paged_attn takes up to {max_positions(d)} query "
                         f"positions at head dim {d}, got {nq}")
    pool = _values(pool_k)
    nb1, h, block, d2 = pool.shape
    shapes = {"pool_k": (pool_k, (nb1, n_kv, block, d)),
              "pool_v": (pool_v, (nb1, n_kv, block, d)),
              "k_cur": (k_cur, (s_, n_kv, nq, d)),
              "v_cur": (v_cur, (s_, n_kv, nq, d))}
    want = {}
    for name, (t, shape) in shapes.items():
        if quant != isinstance(t, tuple):
            raise ValueError(f"paged_attn: {name} must be a (values, "
                             f"scales) pair exactly where pool_k is one")
        if quant:
            want[name] = (t[0], shape, torch.int8)
            want[name + " scales"] = (t[1], shape[:-1], torch.float32)
        else:
            want[name] = (t, shape, q.dtype)
    for name, (t, shape, dt) in want.items():
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"paged_attn: {name} must be {shape} {dt}, got "
                             f"{tuple(t.shape)} {t.dtype}")
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
    for t in [q, tables, p_limit, cur_mask] + [t for t, _, _ in
                                               want.values()]:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("paged_attn needs contiguous tensors on one "
                             "device")
    return _dtype_code(q, pool_k)


def launch_groups(lib, q, pool_k, pool_v, tables, p_limit, k_cur, v_cur,
                  cur_mask, scale, window, blk_lo, n_sm, stream,
                  n_split=None, empty=torch.empty):
    """The split and combine kernels of ``lib`` (the built library, or
    the CPU emulator's build of the same source) over launches of at most
    ``max_rows(D)`` query rows: groups of heads of the GQA group, and past
    ``max_rows(D)`` query positions one head a launch over runs of
    positions, each launch taking all Q current lanes and its rows of
    ``cur_mask``; the outputs are concatenated.  Query rows are
    independent, so this is exact.  Each launch's split count is the plan
    for ``n_sm`` SMs from the table width, or ``n_split``; ``empty``
    allocates the output and the workspace.  Returns ``(out, launches)``;
    raises on a CUDA error."""
    s_, n_kv, g, nq, d = q.shape
    rows = max_rows(d)
    heads = max(1, rows // nq)
    run = min(nq, rows)
    pool = _values(pool_k)
    block, n_blk = pool.shape[2], tables.shape[1]
    ns = n_split or split_count(d, pool.dtype, n_blk, blk_lo, block,
                                s_ * n_kv, n_sm, lib)
    code = _dtype_code(q, pool_k)

    def ptrs(t):
        """Values and scales pointers (no scales: 0)."""
        return (t[0].data_ptr(), t[1].data_ptr()) if isinstance(t, tuple) \
            else (t.data_ptr(), 0)

    (pk, pks), (pv, pvs) = ptrs(pool_k), ptrs(pool_v)
    (kc, kcs), (vc, vcs) = ptrs(k_cur), ptrs(v_cur)
    launches = 0
    by_heads = []
    for h0 in range(0, g, heads):
        by_pos = []
        for q0 in range(0, nq, run):
            qg = q[:, :, h0:h0 + heads, q0:q0 + run]
            if qg.shape != q.shape:
                qg = qg.contiguous()
            gg, qn = qg.shape[2], qg.shape[3]
            out = empty(qg.shape, dtype=qg.dtype, device=qg.device)
            ws = empty((s_ * n_kv * ns * gg * qn * (d + 2),),
                       dtype=torch.float32, device=qg.device)
            err = lib.paged_attention(
                qg.data_ptr(), pk, pv, pks, pvs, tables.data_ptr(),
                p_limit.data_ptr(), kc, vc, kcs, vcs, cur_mask.data_ptr(),
                out.data_ptr(), ws.data_ptr(), s_, n_kv, gg, qn, nq, q0, d,
                block, n_blk, pool.shape[0] - 1, n_blk, int(blk_lo or 0),
                int(window or 0), ns, float(scale), code, stream)
            if err != 0:
                raise RuntimeError(f"paged_attn: CUDA error {err} at launch")
            by_pos.append(out)
            launches += 1
        by_heads.append(by_pos[0] if len(by_pos) == 1
                        else torch.cat(by_pos, 3))
    return (by_heads[0] if len(by_heads) == 1
            else torch.cat(by_heads, 2)), launches


def paged_attn(q, pool_k, pool_v, tables, p_limit, k_cur, v_cur, cur_mask,
               scale, window=None, blk_lo=None):
    """Online-softmax attention of every slot's queries over its paged
    KV (shapes in the module docstring); for CUDA tensors, the split and
    combine kernels over all slots and kv heads, counted as one launch
    for each launch of at most ``max_rows(D)`` query rows in
    ``paged_attn.launches``, and those on int8 pools in
    ``paged_attn.int8_launches`` too."""
    if q.device.type == "cpu":
        return paged_attn_plain(q, pool_k, pool_v, tables, p_limit, k_cur,
                                v_cur, cur_mask, scale, window, blk_lo)
    _check_cuda(q, pool_k, pool_v, tables, p_limit, k_cur, v_cur, cur_mask,
                blk_lo)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.shape[0] == 0:
        return torch.empty_like(q)
    out, launches = launch_groups(
        _lib(), q, pool_k, pool_v, tables, p_limit, k_cur, v_cur, cur_mask,
        scale, window, blk_lo, _sm_count(q.device.index or 0),
        torch.cuda.current_stream(q.device).cuda_stream)
    paged_attn.launches += launches
    if isinstance(pool_k, tuple):
        paged_attn.int8_launches += launches
    return out


paged_attn.launches = 0
paged_attn.int8_launches = 0
