"""Block-paged KV arena of the serve engine (counterpart of
``singa_tpu/serve/paged.py``).

* **block pool**: one preallocated pool of ``num_blocks`` KV blocks per
  K/V, ``(L, num_blocks + 1, H_kv, block_size, D)`` on the model's
  device; block ``num_blocks`` is the trash block that dead slots write.
  With ``quant`` (the engine's ``cache_dtype="int8"``) each pool is an
  (int8 values, float32 scales ``(L, num_blocks + 1, H_kv,
  block_size)``) pair, and every copy below moves both leaves;
* **block tables**: a live request's KV is a per-slot list of blocks,
  grown block by block as decode advances, so capacity is blocks free,
  not slots free;
* **pool step**, two implementations behind ``PagedConfig.kernel``:
  ``"block"`` (default, :func:`_paged_decode_kernel`) attends directly
  over the pool with the block tables as the index, one ``paged_attn``
  kernel launch a layer for all slots, reading its inputs from
  persistent device buffers (:class:`DecodeInputs`), so the engine
  captures it as a CUDA graph; ``"gather"`` (:func:`_paged_decode_step`)
  copies each slot's blocks into a dense row and runs the dense
  ``decode_step``, the parity oracle, eagerly.  Both return the step's
  logits and write its K/V row into the pool in place (the pool is
  allocated once and never reallocated: captured steps write it);
* **speculative step** (the engine's ``draft_model=``, ``spec_k=``):
  :func:`spec_step` runs the draft's ``spec_k`` decode steps on its own
  slot-shaped arena, the target's verify chunk against the pool
  (``chunk_step_paged``: one ``paged_attn`` launch a layer at Q =
  ``spec_k``, the chunk's K/V written into the one or two blocks it
  spans, ``spec_k <= block_size``) and ``spec_verify``, from the same
  :class:`DecodeInputs`, so the engine captures it as one CUDA graph;
* **sliding-window models**: the engine drops a slot's blocks once they
  leave its window (the table keeps the trash block there, so block
  indices stay positional; ``serve.paged.window_drops``) and the step
  passes the window to ``paged_attn``, so a long chat holds and reads
  O(window) blocks;
* **preemption / swap**: a request's blocks can leave the pool for host
  memory mid-decode (``swap_out``: one gather and one copy to the host,
  a :class:`~singa_tpu_torch.serve.kvimage.KVImage`) and come back later
  (``swap_in``: one scatter).  The copy is byte-exact and the request's
  sampling key rides along, so a resumed request's remaining tokens are
  the uninterrupted run's.

With a prefix cache (``serve/prefix.py``) the radix tree owns blocks of
this pool too: a warm slot's table points at them (``share`` adds the
slot's reference), and ``alloc`` evicts unreferenced cached blocks
through ``evict_cb`` before it fails.

``PagedConfig`` also carries the engine's chunked-prefill token budget
(``prefill_token_budget``) and admission interleave (``admit_per_step``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import prng
from ..models.gpt2_decode import (_filter_logits, _leaves, _logits,
                                  chunk_step_paged, decode_step,
                                  decode_step_paged, kv_zeros, prefill_chunk,
                                  spec_verify)
from ..observe.registry import registry as _default_registry
from ..resilience import faults as _faults
from .kvimage import KVImage, pack_image

__all__ = ["PagedConfig", "PagedKVArena", "DecodeInputs",
           "spec_step"]


@dataclass(frozen=True)
class PagedConfig:
    """Knobs of the paged KV arena (``model.serve(paged=...)``).

    ``block_size``: tokens a KV block holds; the engine requires
    ``max_len % block_size == 0``.  ``num_blocks``: pool capacity; device
    memory is ``2 * L * (num_blocks + 1) * H_kv * block_size * D``
    elements (int8 pools: one byte each, and a float32 scale every D).
    ``kernel``: ``"block"`` (the paged kernel) or ``"gather"`` (the
    dense-row oracle); streams are token-identical
    between the two in float32, logits allclose (the kernel sums in
    another order).  ``admit_per_step``: the admission interleave, at
    most this many admissions a scheduling pass (None: as many as fit).
    ``prefill_token_budget``: the Sarathi-style chunked-prefill budget,
    at most this many prompt tokens prefilled a step, a multiple of
    ``block_size``: every admission then prefills in block-width
    ``prefill_chunk`` passes, a long prompt across several steps, while
    the live slots decode every step (None: whole prompts at
    admission)."""

    block_size: int = 32
    num_blocks: int = 128
    kernel: str = "block"
    admit_per_step: int | None = None
    prefill_token_budget: int | None = None

    def __post_init__(self):
        if self.block_size < 1:
            raise ValueError(
                f"block_size must be >= 1, got {self.block_size}")
        if self.num_blocks < 1:
            raise ValueError(
                f"num_blocks must be >= 1, got {self.num_blocks}")
        if self.kernel not in ("block", "gather"):
            raise ValueError(
                f"kernel must be 'block' (the paged decode kernel) or "
                f"'gather' (the dense-row oracle), got {self.kernel!r}")
        if self.admit_per_step is not None and self.admit_per_step < 1:
            raise ValueError(
                f"admit_per_step must be >= 1 (or None for unlimited), got "
                f"{self.admit_per_step}")
        budget = self.prefill_token_budget
        if budget is not None and (budget < self.block_size
                                   or budget % self.block_size):
            raise ValueError(
                f"prefill_token_budget ({budget}) must be a positive "
                f"multiple of block_size ({self.block_size}): chunked "
                f"prefill advances in block-width windows")


# -------------------------------------------------------------- pool steps


class DecodeInputs:
    """The decode step's inputs as persistent device tensors, for up to
    ``slots`` lanes: tokens, positions, live flags, temperatures (float32
    bits), ``n_keys`` threefry sampling keys a lane (two 32-bit words
    each: a plain step's one key, a speculative step's ``spec_k`` draft
    keys and its accept and correction keys) and block tables (``slots``
    x ``row_blocks``), all int32 in one device buffer.  The engine writes
    a step's values into a host staging buffer of the same layout and
    :meth:`load` moves it to the device in one copy.  A decode width
    ``w`` reads the first ``w`` lanes of each (:meth:`view`), at
    addresses that never change, so a captured step reads each step's
    inputs.

    Structured decoding adds a ``(slots, vocab)`` bool buffer of
    vocabulary masks, made at its first use (:meth:`stage_masks`) and
    copied only for a step that a structured request takes part in."""

    FIELDS = ("toks", "pos", "live", "temps")

    def __init__(self, slots, row_blocks, device, n_keys=1):
        self.slots, self.row_blocks, self.n_keys = slots, row_blocks, n_keys
        n = (len(self.FIELDS) + 2 * n_keys + row_blocks) * slots
        self.host = torch.zeros(n, dtype=torch.int32,
                                pin_memory=device.type == "cuda")
        self.buf = torch.zeros(n, dtype=torch.int32, device=device)
        self._h = self.host.numpy()
        self.masks = self._masks_host = None

    def stage_masks(self, rows):
        """Write a step's (w, vocab) bool masks (numpy) into the mask
        staging buffer and copy it to the device buffer, which is made at
        the first call and never again (captured masked steps read
        it)."""
        w, vocab = rows.shape
        if self.masks is None:
            dev = self.buf.device
            self._masks_host = torch.ones((self.slots, vocab),
                                          dtype=torch.bool,
                                          pin_memory=dev.type == "cuda")
            self.masks = torch.ones((self.slots, vocab), dtype=torch.bool,
                                    device=dev)
        self._masks_host.numpy()[:w] = rows
        self.masks.copy_(self._masks_host, non_blocking=True)

    def stage(self, toks, pos, live, keys, temps, tables):
        """Write one step's host values (width-``w`` numpy arrays, its
        (w, n_keys, 2) ``uint32`` keys and a (w, row_blocks) table) into
        the staging buffer."""
        S, w = self.slots, len(toks)
        cols = (toks, pos, live, np.asarray(temps, np.float32).view(np.int32))
        for i, c in enumerate(cols):
            self._h[i * S:i * S + w] = np.asarray(c).astype(np.int32)
        k0 = len(self.FIELDS) * S
        nk = 2 * self.n_keys
        self._h[k0:k0 + w * nk] = np.asarray(keys, np.uint32).reshape(
            -1).view(np.int32)
        t0 = k0 + nk * S
        self._h[t0:t0 + w * self.row_blocks] = tables.reshape(-1)

    def load(self):
        """The staging buffer -> the device buffer, one copy."""
        self.buf.copy_(self.host, non_blocking=True)

    def view(self, w):
        """``dict`` of views of the first ``w`` lanes in the device
        buffer: ``toks``, ``pos``, ``live`` (int32), ``temps`` (float32),
        ``keys`` (w, n_keys, 2) int32 (the words of ``uint32`` keys),
        ``tables`` (w, row_blocks) int32.  A captured step reads through
        them."""
        S, d = self.slots, self.buf
        f = {n: d[i * S:i * S + w] for i, n in enumerate(self.FIELDS)}
        f["temps"] = f["temps"].view(torch.float32)
        k0 = len(self.FIELDS) * S
        nk = 2 * self.n_keys
        f["keys"] = d[k0:k0 + w * nk].view(w, self.n_keys, 2)
        t0 = k0 + nk * S
        f["tables"] = d[t0:t0 + w * self.row_blocks].view(w, self.row_blocks)
        if self.masks is not None:
            f["masks"] = self.masks[:w]
        return f


def _embed(params, toks, pos):
    """(S, 1, E) inputs from device ``toks`` and ``pos``."""
    return (params["wte"][toks.long()] + params["wpe"][pos.long()])[:, None]


def _paged_decode_kernel(params, pool_k, pool_v, inp, block, n_head, eps,
                         window=None):
    """Advance every lane one token against the pool without gathering
    rows.  ``inp``: the lanes' device inputs (:meth:`DecodeInputs.view`;
    dead lanes: all-trash tables, and they embed token 0 at position
    0).  ``paged_attn`` finds the blocks to read from the positions on
    the device, and nothing here reads a device value on the host, so the
    engine captures this step, with its sampling, as a CUDA graph.  The
    vmap over slots of the JAX function is the kernel's slot dimension:
    one launch a layer for all lanes.  ``window``: a sliding-window
    model's band; the kernel reads from table entry 0
    and skips each slot's lanes below its window on the device, where the
    JAX function starts its loop at the lowest live slot's first
    in-window block: a captured step would freeze a host bound, which
    may not exceed a slot admitted later.  Returns (S, V) logits; the
    pools take the step's K/V rows in place."""
    live = inp["live"] != 0
    toks = torch.where(live, inp["toks"], 0)
    p_c = torch.where(live, inp["pos"], 0)
    return decode_step_paged(params, _embed(params, toks, p_c), pool_k,
                             pool_v, inp["tables"], p_c, n_head, eps,
                             block=block, window=window)


def _draft_propose(d_params, dkc, dvc, toks, pos, temps, dkeys, spec_k,
                   d_statics, top_k, top_p):
    """The draft's half of a speculative step for every lane: ``spec_k``
    decode steps of the draft on its slot-shaped arenas (L_d, S, H_d,
    max_len, D_d) from the last token at ``pos``, the last one only as
    an input, so a fully accepted chunk leaves the draft's cache one row
    ahead (the JAX ``_draft_propose``).  A greedy lane proposes the
    draft's argmax, a sampled one draws ``categorical(dkeys[:, i],
    filtered logits)`` at proposal step i (``dkeys`` (S, spec_k, 2): the
    JAX ``split(k_draft, spec_k)``).  Returns
    (props (S, spec_k - 1) int64, their filtered distributions (S,
    spec_k - 1, V))."""
    n_head, eps = d_statics
    hot = temps > 0
    t = torch.where(hot, temps, torch.ones_like(temps))[:, None]
    tok, props, qs = toks, [], []
    for i in range(spec_k):
        p_i = pos + i
        x = (d_params["wte"][tok] + d_params["wpe"][p_i])[:, None]
        lg, _, _ = decode_step(d_params, x, dkc, dvc, p_i, n_head, eps)
        if i == spec_k - 1:
            break
        filt = _filter_logits(lg, t, top_p, top_k)
        drawn = prng.categorical_t(dkeys[:, i], filt)
        tok = torch.where(hot, drawn, lg.float().argmax(-1))
        props.append(tok)
        qs.append(torch.softmax(filt, -1))
    return torch.stack(props, 1), torch.stack(qs, 1)


def spec_step(t_params, d_params, kc, vc, dkc, dvc, inp, spec_k, statics,
              d_statics, top_k, top_p, block=None, window=None, n_rb=None):
    """One speculative step for every lane of ``inp``
    (:meth:`DecodeInputs.view`): the draft's proposals
    (:func:`_draft_propose`), the target's verify of each lane's chunk
    (the last token and the proposals, at pos..pos+spec_k-1) against the
    paged pools ``kc``/``vc`` through ``chunk_step_paged`` (``block``
    given), or against the slot arena's rows through ``prefill_chunk``
    at per-row positions (``block`` None), or, the gather oracle
    (``n_rb`` given: each lane's first ``n_rb`` blocks copied into a
    dense row, the chunk's rows written back; eager only), then
    ``spec_verify``.  Dead
    lanes run on clamped inputs (token 0, position 0; paged: all-trash
    tables) and their outputs are ignored.  Nothing reads the device on
    the host, so the engine captures the whole step as one CUDA graph.
    Returns (S, spec_k + 1) int64: the chunk's tokens and, last, the
    accepted proposals' count; the host emits that count + 1 tokens."""
    n_head, eps = statics
    live = inp["live"] != 0
    toks = torch.where(live, inp["toks"], 0).long()
    pos = torch.where(live, inp["pos"], 0)
    temps = torch.where(live, inp["temps"], torch.zeros_like(inp["temps"]))
    keys = inp["keys"]              # (S, spec_k + 2, 2): draft, acc, fix
    props, q = _draft_propose(d_params, dkc, dvc, toks, pos.long(), temps,
                              keys[:, :spec_k], spec_k, d_statics, top_k,
                              top_p)
    chunk = torch.cat([toks[:, None], props], 1)                # (S, K)
    qpos = pos.long()[:, None] + torch.arange(spec_k, device=pos.device)
    x = t_params["wte"][chunk] + t_params["wpe"][qpos]
    if block is None:
        h, _, _ = prefill_chunk(t_params, x, kc, vc, pos, n_head, eps)
        logits = _logits(h, t_params)
    elif n_rb is not None:
        tbl = inp["tables"][:, :n_rb].long()
        rows = [tuple(_rows(leaf, tbl) for leaf in _leaves(c))
                for c in (kc, vc)]
        kr, vr = (r if isinstance(kc, tuple) else r[0] for r in rows)
        h, kr, vr = prefill_chunk(t_params, x, kr, vr, pos, n_head, eps)
        logits = _logits(h, t_params)
        lanes = torch.arange(len(pos), device=pos.device)[:, None]
        blk = tbl.gather(1, qpos // block)
        # both sides index (S, K, L, H[, D]): the advanced indices lead
        for pool, c in ((kc, kr), (vc, vr)):
            for leaf, r in zip(_leaves(pool), _leaves(c)):
                leaf[:, blk, :, qpos % block] = r[:, lanes, :, qpos]
    else:
        logits = chunk_step_paged(t_params, x, kc, vc, inp["tables"], pos,
                                  n_head, eps, block=block, window=window)
    out, a_draft = spec_verify(logits, q, props, temps, keys[:, spec_k],
                               keys[:, spec_k + 1], top_k, top_p)
    return torch.cat([out, a_draft[:, None]], 1)


def _rows(pool, idx):
    """Blocks ``idx`` ((S, nb) or (nb,)) of a pool leaf (L, N + 1, H, B[,
    D]) as dense rows (L, S, H, nb * B[, D]) (or (L, H, nb * B[, D]))."""
    r = pool[:, idx]                              # (L, [S,] nb, H, B[, D])
    k = idx.dim()                                 # the nb axis is k
    r = r.transpose(k, k + 1)                     # (L, [S,] H, nb, B[, D])
    s = r.shape
    return r.reshape(*s[:k + 1], s[k + 1] * s[k + 2], *s[k + 3:])


def _paged_decode_step(params, pool_k, pool_v, inp, n_rb, block, n_head,
                       eps):
    """The gather oracle: copy each lane's first ``n_rb`` blocks (those up
    to the one holding the longest lane's ``pos``, a host count) into a
    dense (L, S, H_kv, W', D) row (int8 pools: both leaves), run the
    dense ``decode_step`` on it, and write the K/V row it wrote at
    ``pos`` back into the pool (dead lanes: the trash block).  Same
    contract as :func:`_paged_decode_kernel`; it runs eagerly."""
    live = inp["live"] != 0
    toks = torch.where(live, inp["toks"], 0)
    pos_t = torch.where(live, inp["pos"], 0).long()
    tbl = inp["tables"][:, :n_rb].long()

    def row(pool):
        if isinstance(pool, tuple):
            return tuple(_rows(p, tbl) for p in pool)
        return _rows(pool, tbl)

    kc, vc = row(pool_k), row(pool_v)
    logits, kc, vc = decode_step(params, _embed(params, toks, pos_t), kc,
                                 vc, pos_t, n_head, eps)
    lanes = torch.arange(len(pos_t), device=pos_t.device)
    blk = tbl.gather(1, (pos_t // block)[:, None])[:, 0]
    # both sides index (S, L, H[, D]): the advanced indices lead
    for pool, c in ((pool_k, kc), (pool_v, vc)):
        for leaf, r in zip(_leaves(pool), _leaves(c)):
            leaf[:, blk, :, pos_t % block] = r[:, lanes, :, pos_t]
    return logits


# -------------------------------------------------------------- the arena


def _map_leaves(fn, c):
    """``fn`` of each tensor of a cache (a tensor or an int8 pair)."""
    return tuple(fn(t) for t in c) if isinstance(c, tuple) else fn(c)


class PagedKVArena:
    """Owner of the block pool: free list, per-block reference counts,
    block accounting, the copies the engine drives, and metrics."""

    def __init__(self, config, n_layer, n_kv_head, head_dim, dtype,
                 row_width, device, engine_label="0", reg=None,
                 quant=False):
        self.config = config
        B, N = config.block_size, config.num_blocks
        if row_width % B != 0:
            raise ValueError(f"row width ({row_width}) must be a multiple "
                             f"of block_size ({B})")
        self.block_size = B
        self.num_blocks = N
        self.trash = N
        self.row_blocks = row_width // B
        self.quant = bool(quant)
        shape = (n_layer, N + 1, n_kv_head, B, head_dim)
        self.pool_k = kv_zeros(shape, dtype, self.quant, device)
        self.pool_v = kv_zeros(shape, dtype, self.quant, device)
        self._free = list(range(N))
        # the prefix cache's LRU eviction: returns a freed block or None
        self.evict_cb = None
        # blocks referenced more than once (count >= 2); an allocated
        # block without an entry has one reference
        self._refs = {}
        reg = reg if reg is not None else _default_registry()
        lbl = dict(engine=engine_label)
        self._g_free = reg.gauge("serve.paged.blocks_free",
                                 help="pool blocks on the free list", **lbl)
        self._g_used = reg.gauge(
            "serve.paged.blocks_used",
            help="pool blocks held by live slots or the prefix cache (a "
                 "swapped-out request holds none: its blocks were freed "
                 "at preemption)",
            **lbl)
        self._c_preempt = reg.counter(
            "serve.paged.preemptions",
            help="live requests preempted (blocks evicted to host)", **lbl)
        self._c_swap_out = reg.counter(
            "serve.paged.swap_out",
            help="request KV rows copied device -> host", **lbl)
        self._c_swap_in = reg.counter(
            "serve.paged.swap_in",
            help="request KV rows restored host -> device", **lbl)
        self._c_window_drop = reg.counter(
            "serve.paged.window_drops",
            help="blocks sliding-window slots dropped back to the free "
                 "list as their position advanced", **lbl)
        self._registered = [self._g_free, self._g_used, self._c_preempt,
                            self._c_swap_out, self._c_swap_in,
                            self._c_window_drop]
        self._registry = reg
        self._update_gauges()

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    @property
    def blocks_used(self) -> int:
        return self.num_blocks - len(self._free)

    def _update_gauges(self):
        self._g_free.set(self.blocks_free)
        self._g_used.set(self.blocks_used)

    def alloc(self, n):
        """``n`` blocks, or None: all or nothing.  Under pressure the
        prefix cache's LRU leaves are evicted first (``evict_cb``);
        evicted blocks stay freed even when ``n`` does not fit."""
        while len(self._free) < n and self.evict_cb is not None:
            blk = self.evict_cb()
            if blk is None:
                break
            self._free.append(blk)
        if len(self._free) < n:
            self._update_gauges()
            return None
        out = [self._free.pop() for _ in range(n)]
        self._update_gauges()
        return out

    def share(self, blocks):
        """Add one reference to each of ``blocks`` (a warm slot's cached
        prefix, a fork branch's copy of its parent's table: nothing
        moves on the device)."""
        for b in blocks:
            self._refs[b] = self._refs.get(b, 1) + 1

    def ref_count(self, block) -> int:
        return self._refs.get(block, 1)

    def is_shared(self, block) -> bool:
        return block in self._refs

    @property
    def shared_blocks(self) -> int:
        """Blocks with more than one reference (fork branches sharing
        them, or the prefix cache and the slots it serves)."""
        return len(self._refs)

    def copy_block(self, src, dst):
        """Copy block ``src``'s bytes into ``dst`` in every layer's pools,
        int8 values and scales both: the copy-on-first-write of a fork
        branch about to write into a block a sibling still references.
        A fault at the site ``serve.fork_copy`` raises before anything
        is written."""
        if _faults._armed:
            _faults.check("serve.fork_copy")
        for pool in (self.pool_k, self.pool_v):
            for leaf in _leaves(pool):
                leaf[:, dst] = leaf[:, src]

    def free(self, blocks):
        """Drop one reference to each of ``blocks``; a block whose last
        reference goes returns to the free list."""
        for b in blocks:
            c = self._refs.get(b)
            if c is None:
                self._free.append(b)
            elif c <= 2:
                del self._refs[b]
            else:
                self._refs[b] = c - 1
        self._update_gauges()

    def gather_row(self, blocks, n_used=None):
        """(L, 1, H, len(blocks) * B, D) rows of ``blocks``' contents (int8
        pools: (values, scales (L, 1, H, len(blocks) * B)) pairs); lanes
        of blocks past the first ``n_used`` zeroed."""
        idx = torch.as_tensor(blocks, device=_leaves(self.pool_k)[0].device)
        idx = idx.long()
        n = len(blocks) if n_used is None else n_used

        def row(leaf):
            r = _rows(leaf, idx).clone()
            r[:, :, n * self.block_size:] = 0
            return r[:, None]

        def rows(pool):
            out = tuple(row(leaf) for leaf in _leaves(pool))
            return out if self.quant else out[0]

        return rows(self.pool_k), rows(self.pool_v)

    def scatter_row(self, kc_row, vc_row, lanes):
        """Write (L, 1, H, W, D) cache rows (int8 pools: (values, scales)
        pairs) into pool blocks: ``lanes`` maps a lane (block index in the
        row) to a pool block.  W need not be a multiple of the block
        size: the last block's tail is left as it was."""
        B = self.block_size
        w = _leaves(kc_row)[0].shape[3]
        pairs = [(leaf, r) for pool, row in ((self.pool_k, kc_row),
                                             (self.pool_v, vc_row))
                 for leaf, r in zip(_leaves(pool), _leaves(row))]
        for j, blk in lanes.items():
            lo, hi = j * B, min(w, (j + 1) * B)
            if lo < hi:
                for leaf, r in pairs:
                    leaf[:, blk, :, :hi - lo] = r[:, 0, :, lo:hi]

    # -- swap images -------------------------------------------------------

    def swap_out(self, blocks, n_data, gather=None) -> KVImage:
        """Copy the first ``n_data`` of ``blocks`` to host memory (one
        gather and one copy to the host): the preemption path.
        ``gather`` (a sharded engine's) puts the ranks' slices of each
        row leaf together first, so the image is the single-device
        engine's."""
        kc, vc = self.gather_row(list(blocks[:n_data]))
        if gather is not None:
            kc, vc = _map_leaves(gather, kc), _map_leaves(gather, vc)
        self._c_swap_out.inc()

        def host(c):
            return tuple(t.cpu() for t in c) if self.quant else c.cpu()

        return pack_image(host(kc), host(vc), block_size=self.block_size,
                          n_data=n_data, quant=self.quant)

    def swap_in(self, image, blocks, cut=None, meta=None):
        """Restore a swapped-out image's lanes into freshly allocated
        ``blocks`` (one scatter).  The image is validated against this
        pool's geometry first
        (:class:`~singa_tpu_torch.serve.kvimage.KVImageError` on any
        mismatch, before the pool is touched), so the resumed request's
        KV is exactly what ``swap_out`` saved.  A sharded engine passes
        ``meta`` (a pool leaf -> its global geometry, which a whole image
        is validated against) and ``cut`` (a whole row leaf -> this
        rank's slice)."""
        pool = self.pool_k if meta is None else _map_leaves(meta,
                                                            self.pool_k)
        image.validate(self.block_size, self.quant, pool_k=pool)
        dev = _leaves(self.pool_k)[0].device

        def dev_row(c):
            if cut is not None:
                c = _map_leaves(cut, c)
            return tuple(t.to(dev) for t in c) if self.quant else c.to(dev)

        self._c_swap_in.inc()
        self.scatter_row(dev_row(image.kc), dev_row(image.vc),
                         dict(enumerate(blocks[:image.n_data])))

    # -- ship images (serve/fleet.py's KV ships) ---------------------------

    def _ship_image(self, kc_row, vc_row, n_data) -> KVImage:
        """Rows cut to their first ``n_data`` blocks' lanes on the device
        and packed once on the host (a ship's bytes track its prefix)."""
        if _faults._armed:
            _faults.check("serve.kv_ship")
        w = max(n_data, 1) * self.block_size

        def host(c):
            return _map_leaves(lambda t: t[:, :, :, :w].contiguous().cpu(),
                               c)

        return pack_image(host(kc_row), host(vc_row),
                          block_size=self.block_size, n_data=n_data,
                          quant=self.quant)

    def export_image(self, blocks, n_data) -> KVImage:
        """``blocks``' first ``n_data`` blocks as a narrow host image
        (``n_data * block_size`` lanes: a ship's bytes track the shipped
        prefix): the source half of a KV ship.  Packed here, not by
        :meth:`swap_out`, whose counter means preemption.  The
        ``serve.kv_ship`` fault site."""
        return self._ship_image(*self.gather_row(list(blocks), n_used=n_data),
                                n_data)

    def export_row_image(self, kc_row, vc_row, n_data) -> KVImage:
        """A narrow ship image straight from a device cache row (a
        prefill specialist whose donation the pool could not take: the
        row is the only copy).  Same fault site and format as
        :meth:`export_image`."""
        return self._ship_image(kc_row, vc_row, n_data)

    def import_image(self, image, lanes):
        """Scatter a ship image's lanes into pool blocks (``lanes``: lane
        -> block; lanes below a local hit are absent and do not move).
        Validated first, so a malformed image is a typed
        :class:`~singa_tpu_torch.serve.kvimage.KVImageError`; then the
        ``serve.kv_ship`` fault site of the destination half."""
        image.validate(self.block_size, self.quant, pool_k=self.pool_k)
        if _faults._armed:
            _faults.check("serve.kv_ship")
        dev = _leaves(self.pool_k)[0].device

        def dev_row(c):
            return tuple(t.to(dev) for t in c) if self.quant else c.to(dev)

        self.scatter_row(dev_row(image.kc), dev_row(image.vc), dict(lanes))

    def on_preempt(self):
        self._c_preempt.inc()

    def on_window_drop(self, n):
        """Count ``n`` out-of-window blocks a slot returned (already
        freed through :meth:`free`)."""
        self._c_window_drop.inc(n)

    def unregister(self):
        """Drop the metrics and the device pool (engine ``close()``)."""
        self._registry.remove(*self._registered)
        self.pool_k = self.pool_v = None

    def snapshot(self) -> dict:
        return {"block_size": self.block_size,
                "num_blocks": self.num_blocks,
                "quant": self.quant,
                "blocks_free": self.blocks_free,
                "blocks_used": self.blocks_used,
                "preemptions": self._c_preempt.value,
                "swap_out": self._c_swap_out.value,
                "swap_in": self._c_swap_in.value,
                "window_drops": self._c_window_drop.value,
                "shared_blocks": self.shared_blocks}
