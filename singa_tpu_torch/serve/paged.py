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
  kernel launch a layer for all slots; ``"gather"``
  (:func:`_paged_decode_step`) copies each slot's blocks into a dense
  row and runs the dense ``decode_step``, the parity oracle.  Both
  return the step's logits and write its K/V row into the pool in
  place.

Not ported yet (``ROADMAP.md``): int8 pools, preemption and swap to host,
the prefix cache sharing this pool, windowed block drops, the chunked-
prefill budget (``prefill_token_budget``) and the admission interleave
(``admit_per_step``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.gpt2_decode import decode_step, decode_step_paged
from ..observe.registry import registry as _default_registry

__all__ = ["PagedConfig", "PagedKVArena"]


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


def _embed(params, toks, pos, live):
    """(S, 1, E) inputs; dead lanes embed token 0 at position 0."""
    dev = params["wte"].device
    t = torch.as_tensor(np.where(live, toks, 0), device=dev).long()
    p = torch.as_tensor(np.where(live, pos, 0), device=dev).long()
    return (params["wte"][t] + params["wpe"][p])[:, None]


def _paged_decode_kernel(params, pool_k, pool_v, tables, toks, pos, live,
                         block, n_head, eps):
    """Advance every lane one token against the pool without gathering
    rows: ``tables`` (S, W // B), ``toks``, ``pos``, ``live`` (S,) host
    arrays (dead lanes: all-trash tables).  ``n_blk`` is the longest live
    lane's block count, so the kernel reads no block past any slot's
    ``pos``.  The vmap over slots of the JAX function is the kernel's
    slot dimension: one launch a layer for all lanes.  Returns (S, V)
    logits; the pools take the step's K/V rows in place."""
    dev = pool_k.device
    p_c = np.where(live, pos, 0).astype(np.int32)
    n_blk = int(((p_c + block - 1) // block).max(initial=0))
    return decode_step_paged(
        params, _embed(params, toks, pos, live), pool_k, pool_v,
        torch.as_tensor(tables, device=dev), torch.as_tensor(p_c, device=dev),
        n_blk, n_head, eps, block=block)


def _paged_decode_step(params, pool_k, pool_v, tables, toks, pos, live,
                       block, n_head, eps):
    """The gather oracle: copy each lane's blocks (up to the one holding
    ``pos``) into a dense (L, S, H_kv, W', D) row, run the dense
    ``decode_step`` on it, and write the K/V row it wrote at ``pos`` back
    into the pool (dead lanes: the trash block).  Same contract as
    :func:`_paged_decode_kernel`."""
    dev = pool_k.device
    p_c = np.where(live, pos, 0).astype(np.int64)
    n_rb = int((p_c // block).max(initial=0)) + 1
    tbl = torch.as_tensor(tables[:, :n_rb], device=dev).long()

    def row(pool):
        r = pool[:, tbl]                          # (L, S, nb, H, B, D)
        r = r.permute(0, 1, 3, 2, 4, 5)
        s = r.shape
        return r.reshape(s[0], s[1], s[2], s[3] * s[4], s[5])

    kc, vc = row(pool_k), row(pool_v)
    pos_t = torch.as_tensor(p_c, device=dev)
    logits, kc, vc = decode_step(params, _embed(params, toks, pos, live),
                                 kc, vc, pos_t, n_head, eps)
    lanes = torch.arange(len(p_c), device=dev)
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
        self._g_used = reg.gauge("serve.paged.blocks_used",
                                 help="pool blocks held by live slots",
                                 **lbl)
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

    def unregister(self):
        """Drop the metrics and the device pool (engine ``close()``)."""
        self._registry.remove(self._g_free, self._g_used)
        self.pool_k = self.pool_v = None

    def snapshot(self) -> dict:
        return {"block_size": self.block_size,
                "num_blocks": self.num_blocks,
                "blocks_free": self.blocks_free,
                "blocks_used": self.blocks_used,
                "shared_blocks": len(self._refs)}
