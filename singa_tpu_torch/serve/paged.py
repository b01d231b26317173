"""Block-paged KV arena of the serve engine (counterpart of
``singa_tpu/serve/paged.py``).

* **block pool**: one preallocated pool of ``num_blocks`` KV blocks per
  K/V, ``(L, num_blocks + 1, H_kv, block_size, D)`` on the model's
  device; block ``num_blocks`` is the trash block that dead slots write;
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
* **preemption / swap**: a request's blocks can leave the pool for host
  memory mid-decode (``swap_out``: one gather and one copy to the host,
  a :class:`~singa_tpu_torch.serve.kvimage.KVImage`) and come back later
  (``swap_in``: one scatter).  The copy is byte-exact and sampling noise
  is keyed by (seed, position), so a resumed request's remaining tokens
  are the uninterrupted run's.

Not ported yet (``ROADMAP.md``): int8 pools, the prefix cache sharing
this pool, windowed block drops, the chunked-prefill budget
(``prefill_token_budget``) and the admission interleave
(``admit_per_step``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.gpt2_decode import decode_step, decode_step_paged
from ..observe.registry import registry as _default_registry
from .kvimage import KVImage, pack_image

__all__ = ["PagedConfig", "PagedKVArena", "DecodeInputs", "seeds"]


@dataclass(frozen=True)
class PagedConfig:
    """Knobs of the paged KV arena (``model.serve(paged=...)``).

    ``block_size``: tokens a KV block holds; the engine requires
    ``max_len % block_size == 0``.  ``num_blocks``: pool capacity; device
    memory is ``2 * L * (num_blocks + 1) * H_kv * block_size * D``
    elements.  ``kernel``: ``"block"`` (the paged kernel) or
    ``"gather"`` (the dense-row oracle); streams are token-identical
    between the two in float32, logits allclose (the kernel sums in
    another order).  ``admit_per_step`` and ``prefill_token_budget``
    are the JAX engine's admission interleave and chunked-prefill
    budget, not ported yet: setting either raises."""

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
        if self.admit_per_step is not None:
            raise NotImplementedError(
                "PagedConfig.admit_per_step (the admission interleave) is "
                "not ported yet (ROADMAP.md)")
        if self.prefill_token_budget is not None:
            raise NotImplementedError(
                "PagedConfig.prefill_token_budget (chunked prefill) is not "
                "ported yet (ROADMAP.md)")


# -------------------------------------------------------------- pool steps


class DecodeInputs:
    """The decode step's inputs as persistent device tensors, for up to
    ``slots`` lanes: tokens, positions, live flags, sampling seeds (low
    and high 32 bits), temperatures (float32 bits) and block tables
    (``slots`` x ``row_blocks``), all int32 in one device buffer.  The
    engine writes a step's values into a host staging buffer of the same
    layout and :meth:`load` moves it to the device in one copy.  A decode
    width ``w`` reads the first ``w`` lanes of each (:meth:`view`), at
    addresses that never change, so a captured step reads each step's
    inputs."""

    FIELDS = ("toks", "pos", "live", "seed_lo", "seed_hi", "temps")

    def __init__(self, slots, row_blocks, device):
        self.slots, self.row_blocks = slots, row_blocks
        n = len(self.FIELDS) * slots + slots * row_blocks
        self.host = torch.zeros(n, dtype=torch.int32,
                                pin_memory=device.type == "cuda")
        self.buf = torch.zeros(n, dtype=torch.int32, device=device)
        self._h = self.host.numpy()

    def stage(self, toks, pos, live, seeds, temps, tables):
        """Write one step's host values (width-``w`` numpy arrays and a
        (w, row_blocks) table) into the staging buffer."""
        S, w = self.slots, len(toks)
        seeds = np.asarray(seeds, np.int64)
        cols = (toks, pos, live, seeds & 0xFFFFFFFF, seeds >> 32,
                np.asarray(temps, np.float32).view(np.int32))
        for i, c in enumerate(cols):
            # the low 32 bits of each value (a seed half wraps to int32)
            self._h[i * S:i * S + w] = np.asarray(c).astype(np.int32)
        t0 = len(self.FIELDS) * S
        self._h[t0:t0 + w * self.row_blocks] = tables.reshape(-1)

    def load(self):
        """The staging buffer -> the device buffer, one copy."""
        self.buf.copy_(self.host, non_blocking=True)

    def view(self, w):
        """``dict`` of views of the first ``w`` lanes in the device
        buffer: ``toks``, ``pos``, ``live``, ``seed_lo``, ``seed_hi``
        (int32), ``temps`` (float32), ``tables`` (w, row_blocks) int32.
        A captured step reads through them (:func:`seeds` combines the
        seed halves inside the step)."""
        S, d = self.slots, self.buf
        f = {n: d[i * S:i * S + w] for i, n in enumerate(self.FIELDS)}
        f["temps"] = f["temps"].view(torch.float32)
        t0 = len(self.FIELDS) * S
        f["tables"] = d[t0:t0 + w * self.row_blocks].view(w, self.row_blocks)
        return f


def seeds(inp):
    """(w,) int64 sampling seeds from the seed halves of ``inp``."""
    return (inp["seed_hi"].long() << 32) | (inp["seed_lo"].long()
                                            & 0xFFFFFFFF)


def _embed(params, toks, pos):
    """(S, 1, E) inputs from device ``toks`` and ``pos``."""
    return (params["wte"][toks.long()] + params["wpe"][pos.long()])[:, None]


def _paged_decode_kernel(params, pool_k, pool_v, inp, block, n_head, eps):
    """Advance every lane one token against the pool without gathering
    rows.  ``inp``: the lanes' device inputs (:meth:`DecodeInputs.view`;
    dead lanes: all-trash tables, and they embed token 0 at position
    0).  ``paged_attn`` finds the blocks to read from the positions on
    the device, and nothing here reads a device value on the host, so the
    engine captures this step, with its sampling, as a CUDA graph.  The
    vmap over slots of the JAX function is the kernel's slot dimension:
    one launch a layer for all lanes.  Returns (S, V) logits; the pools
    take the step's K/V rows in place."""
    live = inp["live"] != 0
    toks = torch.where(live, inp["toks"], 0)
    p_c = torch.where(live, inp["pos"], 0)
    return decode_step_paged(params, _embed(params, toks, p_c), pool_k,
                             pool_v, inp["tables"], p_c, n_head, eps,
                             block=block)


def _paged_decode_step(params, pool_k, pool_v, inp, n_rb, block, n_head,
                       eps):
    """The gather oracle: copy each lane's first ``n_rb`` blocks (those up
    to the one holding the longest lane's ``pos``, a host count) into a
    dense (L, S, H_kv, W', D) row, run the dense ``decode_step`` on it,
    and write the K/V row it wrote at ``pos`` back into the pool (dead
    lanes: the trash block).  Same contract as
    :func:`_paged_decode_kernel`; it runs eagerly."""
    live = inp["live"] != 0
    toks = torch.where(live, inp["toks"], 0)
    pos_t = torch.where(live, inp["pos"], 0).long()
    tbl = inp["tables"][:, :n_rb].long()

    def row(pool):
        r = pool[:, tbl]                          # (L, S, nb, H, B, D)
        r = r.permute(0, 1, 3, 2, 4, 5)
        s = r.shape
        return r.reshape(s[0], s[1], s[2], s[3] * s[4], s[5])

    kc, vc = row(pool_k), row(pool_v)
    logits, kc, vc = decode_step(params, _embed(params, toks, pos_t), kc,
                                 vc, pos_t, n_head, eps)
    lanes = torch.arange(len(pos_t), device=pos_t.device)
    blk = tbl.gather(1, (pos_t // block)[:, None])[:, 0]
    # both sides index (S, L, H, D): the advanced indices lead
    pool_k[:, blk, :, pos_t % block] = kc[:, lanes, :, pos_t]
    pool_v[:, blk, :, pos_t % block] = vc[:, lanes, :, pos_t]
    return logits


# -------------------------------------------------------------- the arena


class PagedKVArena:
    """Owner of the block pool: free list, per-block reference counts,
    block accounting, the copies the engine drives, and metrics."""

    def __init__(self, config, n_layer, n_kv_head, head_dim, dtype,
                 row_width, device, engine_label="0", reg=None):
        self.config = config
        B, N = config.block_size, config.num_blocks
        if row_width % B != 0:
            raise ValueError(f"row width ({row_width}) must be a multiple "
                             f"of block_size ({B})")
        self.block_size = B
        self.num_blocks = N
        self.trash = N
        self.row_blocks = row_width // B
        shape = (n_layer, N + 1, n_kv_head, B, head_dim)
        self.pool_k = torch.zeros(shape, dtype=dtype, device=device)
        self.pool_v = torch.zeros(shape, dtype=dtype, device=device)
        self._free = list(range(N))
        # blocks referenced more than once (count >= 2); an allocated
        # block without an entry has one reference
        self._refs = {}
        reg = reg if reg is not None else _default_registry()
        lbl = dict(engine=engine_label)
        self._g_free = reg.gauge("serve.paged.blocks_free",
                                 help="pool blocks on the free list", **lbl)
        self._g_used = reg.gauge(
            "serve.paged.blocks_used",
            help="pool blocks held by live slots (a swapped-out request "
                 "holds none: its blocks were freed at preemption)",
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
        self._registered = [self._g_free, self._g_used, self._c_preempt,
                            self._c_swap_out, self._c_swap_in]
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
        """``n`` blocks, or None: all or nothing."""
        if len(self._free) < n:
            return None
        out = [self._free.pop() for _ in range(n)]
        self._update_gauges()
        return out

    def share(self, blocks):
        """Add one reference to each of ``blocks``."""
        for b in blocks:
            self._refs[b] = self._refs.get(b, 1) + 1

    def ref_count(self, block) -> int:
        return self._refs.get(block, 1)

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
        """(L, 1, H, len(blocks) * B, D) rows of ``blocks``' contents; lanes
        of blocks past the first ``n_used`` zeroed."""
        idx = torch.as_tensor(blocks, device=self.pool_k.device).long()
        n = len(blocks) if n_used is None else n_used

        def row(pool):
            r = pool[:, idx].permute(0, 2, 1, 3, 4).clone()
            r[:, :, n:] = 0
            s = r.shape
            return r.reshape(s[0], 1, s[1], s[2] * s[3], s[4])

        return row(self.pool_k), row(self.pool_v)

    def scatter_row(self, kc_row, vc_row, lanes):
        """Write (L, 1, H, W, D) cache rows into pool blocks: ``lanes``
        maps a lane (block index in the row) to a pool block.  W need not
        be a multiple of the block size: the last block's tail is left
        as it was."""
        B = self.block_size
        w = kc_row.shape[3]
        for j, blk in lanes.items():
            lo, hi = j * B, min(w, (j + 1) * B)
            if lo < hi:
                self.pool_k[:, blk, :, :hi - lo] = kc_row[:, 0, :, lo:hi]
                self.pool_v[:, blk, :, :hi - lo] = vc_row[:, 0, :, lo:hi]

    # -- swap images -------------------------------------------------------

    def swap_out(self, blocks, n_data) -> KVImage:
        """Copy the first ``n_data`` of ``blocks`` to host memory (one
        gather and one copy to the host): the preemption path."""
        kc, vc = self.gather_row(list(blocks[:n_data]))
        self._c_swap_out.inc()
        return pack_image(kc.cpu(), vc.cpu(), block_size=self.block_size,
                          n_data=n_data)

    def swap_in(self, image, blocks):
        """Restore a swapped-out image's lanes into freshly allocated
        ``blocks`` (one scatter).  The image is validated against this
        pool's geometry first
        (:class:`~singa_tpu_torch.serve.kvimage.KVImageError` on any
        mismatch, before the pool is touched), so the resumed request's
        KV is exactly what ``swap_out`` saved."""
        image.validate(self.block_size, pool_k=self.pool_k)
        dev = self.pool_k.device
        self._c_swap_in.inc()
        self.scatter_row(image.kc.to(dev), image.vc.to(dev),
                         dict(enumerate(blocks[:image.n_data])))

    def on_preempt(self):
        self._c_preempt.inc()

    def unregister(self):
        """Drop the metrics and the device pool (engine ``close()``)."""
        self._registry.remove(*self._registered)
        self.pool_k = self.pool_v = None

    def snapshot(self) -> dict:
        return {"block_size": self.block_size,
                "num_blocks": self.num_blocks,
                "blocks_free": self.blocks_free,
                "blocks_used": self.blocks_used,
                "preemptions": self._c_preempt.value,
                "swap_out": self._c_swap_out.value,
                "swap_in": self._c_swap_in.value,
                "shared_blocks": len(self._refs)}
