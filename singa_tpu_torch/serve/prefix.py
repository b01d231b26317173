"""Radix prefix cache: block-granular KV reuse for the serve engine
(counterpart of ``singa_tpu/serve/prefix.py``).

Shared system prompts, few-shot templates and multi-turn sessions that
re-send the whole conversation make most admissions repeat a prefix the
engine has already prefilled.  The cache keeps that prefix's K/V:

* **block pool**: on the paged arena (``paged=``) the tree indexes the
  arena's own blocks (arena mode: no second pool, zero-copy donation by
  :meth:`PrefixCache.adopt_blocks`, and a warm slot's block table points
  at the tree's blocks); on the slot arena the cache owns a pool of
  ``num_blocks`` blocks, ``(L, num_blocks, H_kv, block_size, D)`` a
  K/V, which admissions copy rows out of (:meth:`copy_into_row`) and
  retirements copy rows into (:meth:`plan_donation` places the blocks,
  :meth:`write_blocks` copies them; the engine's device layer runs the
  copies, on every rank of a sharded engine).  int8 pools are (values,
  scales) pairs and every copy moves both leaves;
* **radix tree**: a host-side trie at block granularity, each node one
  ``block_size``-token block keyed by its token tuple.  Nodes are
  reference-counted (in-flight requests and pinned sessions hold them)
  and eviction is LRU over unreferenced leaves only, so a referenced
  block is never freed and an interior node never orphans its children;
* **one canonical form**: the tree holds only K/V that
  ``gpt2_decode.prefill_chunk`` made, block by block from a zero row.
  With a cache on, the engine prefills every admission, cold ones too,
  in block-width ``prefill_chunk`` passes, so a warm admission runs the
  same function at the same shapes on the same inputs as a cold one
  from its divergence block on, and its stream is the cold stream on
  one device by construction (the JAX module instead relies on chunked
  prefill being bitwise equal to full prefill, which holds neither on
  XLA:CPU nor across cuBLAS GEMM shapes).  Decode-step K/V is not
  canonical, so a pinned session's generated region is recomputed
  through ``prefill_chunk`` at retire;
* **pressure**: a full pool with nothing evictable degrades to cold
  prefill (misses, skipped donations), never to an error.

Metrics go to the port's registry under the owning engine's label:
``serve.prefix.{hits,misses,evictions,cached_blocks,hit_tokens,
lookup_tokens,donate_skipped}``.  The ``serve.prefix_copy`` fault site
covers the cache-owned pool's copies.

Still owed (``ROADMAP.md``): ``FleetPrefixIndex``, the fleet's
residency index over the replicas' trees, waits for the fleet (Queue A
item 8); the ``observe.requests`` ledger hooks of :meth:`on_admit`
wait for the request ledger (item 5i).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

from ..models.gpt2_decode import _leaves, kv_zeros
from ..observe import requests as _reqs
from ..observe.registry import registry as _default_registry
from ..resilience import faults as _faults
from .paged import _rows

__all__ = ["PrefixCacheConfig", "PrefixCache", "SessionHandle",
           "FleetPrefixIndex"]


@dataclass(frozen=True)
class PrefixCacheConfig:
    """Knobs of the engine's prefix cache
    (``model.serve(prefix_cache=...)``).

    ``block_size``: tokens a cached block holds, the reuse granularity;
    the engine requires ``max_len % block_size == 0``, and on the paged
    arena it must equal the arena's block size (one pool, one
    granularity).  ``num_blocks``: the pool's capacity on the slot arena
    (device memory: ``2 * L * num_blocks * H_kv * block_size * D``
    elements); on the paged arena capacity is the arena's and this is
    ignored."""

    block_size: int = 64
    num_blocks: int = 256

    def __post_init__(self):
        if self.block_size < 1:
            raise ValueError(
                f"block_size must be >= 1, got {self.block_size}")
        if self.num_blocks < 1:
            raise ValueError(
                f"num_blocks must be >= 1, got {self.num_blocks}")


def gather_blocks(pool, blocks, width):
    """A fresh (L, 1, H, width, D) row per leaf of ``pool`` (L, N, H, B,
    D) (an int8 pair: both leaves): ``blocks`` at lanes [0,
    len(blocks) * B), zeros past."""
    leaves = _leaves(pool)
    B = leaves[0].shape[3]
    idx = torch.as_tensor(list(blocks), dtype=torch.long,
                          device=leaves[0].device)
    shape = (leaves[0].shape[0], 1, leaves[0].shape[2], width)
    out = []
    for leaf in leaves:
        row = torch.zeros(shape + tuple(leaf.shape[4:]), dtype=leaf.dtype,
                          device=leaf.device)
        if len(blocks):
            row[:, 0, :, :len(blocks) * B] = _rows(leaf, idx)
        out.append(row)
    return tuple(out) if isinstance(pool, tuple) else out[0]


class _Node:
    """One cached block: ``key`` is the tuple of its ``block_size``
    tokens, ``block`` its pool block.  ``refs`` counts the in-flight
    requests and pinned sessions holding it; ``last_used`` is a logical
    LRU tick (no wall time)."""

    __slots__ = ("key", "parent", "children", "block", "refs",
                 "last_used")

    def __init__(self, key, parent, block, tick):
        self.key = key
        self.parent = parent
        self.children = {}
        self.block = block
        self.refs = 0
        self.last_used = tick


class SessionHandle:
    """A finished request's sequence, pinned for multi-turn continuation.
    ``tokens`` is the whole prompt + generation; :meth:`request` builds
    the next turn's ``GenerationRequest`` with the conversation re-sent
    as its prompt, which against a warm cache is a block-prefix hit, so
    the next turn prefills only its new tokens.  Against a rebuilt
    engine's empty cache it still builds valid (cold) requests: the
    handle owns host tokens, not device state.  :meth:`release` unpins
    the cached path."""

    def __init__(self, tokens, cache=None, nodes=()):
        self.tokens = np.asarray(tokens, np.int32).reshape(-1)
        self._cache = cache
        self._nodes = list(nodes)

    @property
    def pinned_blocks(self) -> int:
        return len(self._nodes)

    def request(self, extra_tokens, **kw):
        """The next turn: a ``GenerationRequest`` whose prompt is this
        session's sequence + ``extra_tokens``; keyword arguments pass
        through (``max_new_tokens``, ``pin_session`` for the turn after
        this one, ...).  The request carries ``session_of=self``."""
        from .request import GenerationRequest

        extra = np.asarray(extra_tokens, np.int32).reshape(-1)
        kw.setdefault("session_of", self)
        return GenerationRequest(np.concatenate([self.tokens, extra]), **kw)

    def release(self):
        """Unpin the session's cached path (idempotent); the blocks stay
        cached until LRU pressure evicts them."""
        if self._cache is not None and self._nodes:
            self._cache.release(self._nodes)
        self._nodes = []


class _IndexNode:
    """One fleet-index block: children keyed by token tuple, the set
    of replica indices whose trees were seen holding this block, and
    a logical recency tick (the capacity bound's eviction order)."""

    __slots__ = ("children", "replicas", "tick")

    def __init__(self, tick=0):
        self.children = {}
        self.replicas = set()
        self.tick = tick


class FleetPrefixIndex:
    """FLEET-level residency index over the replicas' radix trees (the
    disaggregation round): one host-side trie at block granularity
    mapping token-block paths to the set of replica indices whose
    prefix caches hold them — the structure that makes the prefix
    cache a fleet resource instead of N private copies.

    The index is a HINT, not ground truth: per-replica LRU eviction
    never notifies the fleet, so every consumer verifies a candidate
    against the source replica's LIVE tree (``PrefixCache.lookup``)
    before acting on it — a stale entry degrades to a cold prefill or
    a fresh ship, never to an error.  Registration happens at the
    fleet's observation points (a prefill specialist's donation, a
    ship landing on a decode replica); ``drop_replica`` clears a
    failed-over or revived replica wholesale (its rebuilt tree starts
    empty), ``unregister`` prunes a hint a failed verify just proved
    stale, and ``max_blocks`` bounds the trie (least-recently-touched
    root subtree evicted first — the host-memory discipline every
    bounded store in the codebase keeps)."""

    def __init__(self, block_size, max_blocks=4096):
        if block_size < 1:
            raise ValueError(
                f"block_size must be >= 1, got {block_size}")
        if max_blocks < 1:
            raise ValueError(
                f"max_blocks must be >= 1, got {max_blocks}")
        self.block_size = int(block_size)
        self.max_blocks = int(max_blocks)
        self._count = 0
        self._ticks = itertools.count(1)
        self._root = _IndexNode()

    def _keys(self, tokens, n_blocks):
        B = self.block_size
        toks = np.asarray(tokens, np.int32).reshape(-1)
        n = min(int(n_blocks), len(toks) // B)
        return [tuple(int(t) for t in toks[j * B:(j + 1) * B])
                for j in range(n)]

    def register(self, tokens, n_blocks, replica):
        """Record that ``replica`` holds the first ``n_blocks`` blocks
        of ``tokens`` (refreshes recency; may evict the stalest root
        subtree to stay within ``max_blocks``)."""
        tick = next(self._ticks)
        node = self._root
        for key in self._keys(tokens, n_blocks):
            child = node.children.get(key)
            if child is None:
                child = _IndexNode(tick)
                node.children[key] = child
                self._count += 1
            child.replicas.add(int(replica))
            child.tick = tick
            node = child
        self._prune()

    def _subtree_size(self, node):
        return 1 + sum(self._subtree_size(c)
                       for c in node.children.values())

    def _prune(self):
        """Hold the trie at ``max_blocks`` nodes: evict whole root
        subtrees, least-recently-touched first (the just-registered
        path carries the max tick, so it is never its own victim).
        Unbounded growth is the alternative — hints are only ever
        removed by failover otherwise, and a long-running fleet
        serving unique prompts would leak host memory forever."""
        while self._count > self.max_blocks and self._root.children:
            key = min(self._root.children,
                      key=lambda k: self._root.children[k].tick)
            victim = self._root.children.pop(key)
            self._count -= self._subtree_size(victim)

    def unregister(self, tokens, n_blocks, replica):
        """Drop ``replica`` from the first ``n_blocks`` blocks'
        residency sets (a verify against its live tree just failed —
        the hint is stale) and prune nodes nobody holds."""
        replica = int(replica)
        path = []
        node = self._root
        for key in self._keys(tokens, n_blocks):
            child = node.children.get(key)
            if child is None:
                break
            child.replicas.discard(replica)
            path.append((node, key, child))
            node = child
        for parent, key, child in reversed(path):
            if not child.replicas and not child.children:
                del parent.children[key]
                self._count -= 1

    def holders(self, tokens, n_blocks) -> list:
        """Replica indices whose registered residency covers ALL of
        the first ``n_blocks`` blocks, ascending (deterministic) —
        the targeted-ship source / local-warm routing candidates.
        Empty when nothing covers the whole span."""
        keys = self._keys(tokens, n_blocks)
        if len(keys) < n_blocks or not keys:
            return []
        node, held = self._root, None
        for key in keys:
            node = node.children.get(key)
            if node is None:
                return []
            held = (set(node.replicas) if held is None
                    else held & node.replicas)
            if not held:
                return []
        return sorted(held)

    def drop_replica(self, replica):
        """Forget every residency record for ``replica`` (failover or
        revive: the rebuilt tree is empty) and prune nodes no replica
        holds."""
        replica = int(replica)

        def sub(node):
            node.replicas.discard(replica)
            dead = [k for k, c in node.children.items()
                    if not sub(c)]
            for k in dead:
                del node.children[k]
            return bool(node.replicas or node.children)

        sub(self._root)
        self._count = self._subtree_size(self._root) - 1

    def snapshot(self) -> dict:
        return {"block_size": self.block_size,
                "max_blocks": self.max_blocks,
                "indexed_blocks": self._count}


class PrefixCache:
    """Block-granular radix tree over a KV block pool (module
    docstring).  Owned by one engine, which drives the device copies;
    this class keeps the tree, the reference counts, the LRU state and
    the metrics."""

    def __init__(self, config, n_layer, n_kv_head, head_dim, dtype, device,
                 engine_label="0", reg=None, quant=False, arena=None):
        self.config = config
        B, N = config.block_size, config.num_blocks
        self.block_size = B
        self._arena = arena
        if arena is not None:
            self.num_blocks = arena.num_blocks
            self._pool_k = self._pool_v = None
            self._free = []
        else:
            self.num_blocks = N
            shape = (n_layer, N, n_kv_head, B, head_dim)
            self._pool_k = kv_zeros(shape, dtype, quant, device)
            self._pool_v = kv_zeros(shape, dtype, quant, device)
            self._free = list(range(N))
        self._root = _Node((), None, -1, 0)
        self._nodes_by_block = {}       # pool block -> node
        self._tick = itertools.count(1)
        reg = reg if reg is not None else _default_registry()
        lbl = dict(engine=engine_label)
        self._c_hits = reg.counter(
            "serve.prefix.hits",
            help="admissions that reused >=1 cached block", **lbl)
        self._c_misses = reg.counter(
            "serve.prefix.misses",
            help="admissions with no usable cached prefix", **lbl)
        self._c_evictions = reg.counter(
            "serve.prefix.evictions",
            help="LRU evictions of unreferenced leaf blocks", **lbl)
        self._c_hit_tokens = reg.counter(
            "serve.prefix.hit_tokens",
            help="prompt tokens served from cached blocks", **lbl)
        self._c_lookup_tokens = reg.counter(
            "serve.prefix.lookup_tokens",
            help="prompt tokens seen by admission lookups", **lbl)
        self._c_donate_skipped = reg.counter(
            "serve.prefix.donate_skipped",
            help="blocks not cached because the pool was full of "
                 "referenced blocks", **lbl)
        self._g_cached = reg.gauge(
            "serve.prefix.cached_blocks",
            help="blocks currently held by the radix tree", **lbl)
        self._registry = reg
        self._registered = [
            self._c_hits, self._c_misses, self._c_evictions,
            self._c_hit_tokens, self._c_lookup_tokens,
            self._c_donate_skipped, self._g_cached]

    # -- tree --------------------------------------------------------------
    @property
    def cached_blocks(self) -> int:
        return len(self._nodes_by_block)

    def cached_block_ids(self):
        """Pool blocks the tree owns: the cache's side of the engine's
        block accounting (every used arena block is cached here or held
        by a live slot)."""
        return list(self._nodes_by_block)

    def _block_keys(self, tokens):
        B = self.block_size
        toks = np.asarray(tokens, np.int32).reshape(-1)
        return [tuple(int(t) for t in toks[j * B:(j + 1) * B])
                for j in range(len(toks) // B)]

    def lookup(self, tokens):
        """The longest cached block-prefix of ``tokens``: the matched
        nodes, root first.  No counters, no reference counts; keys are
        built block by block, so an early miss costs one block's work."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        B = self.block_size
        path, node = [], self._root
        for j in range(len(toks) // B):
            node = node.children.get(
                tuple(int(t) for t in toks[j * B:(j + 1) * B]))
            if node is None:
                break
            path.append(node)
        return path

    def touch(self, nodes):
        """Refresh the LRU recency of a cached path."""
        tick = next(self._tick)
        for n in nodes:
            n.last_used = tick

    def acquire(self, nodes):
        """Pin a matched path while a request is in flight (or for a
        session): a referenced node is never evicted."""
        tick = next(self._tick)
        for n in nodes:
            n.refs += 1
            n.last_used = tick

    def release(self, nodes):
        for n in nodes:
            n.refs -= 1
            if n.refs < 0:
                # an underflow would let a pinned block read as
                # unreferenced and be evicted under its session
                n.refs = 0
                raise RuntimeError(f"prefix-cache refcount underflow "
                                   f"(double release of block {n.block})")

    def on_donate_skipped(self, n):
        """Count ``n`` blocks a ship's export could not cache under pool
        pressure."""
        self._c_donate_skipped.inc(int(n))

    def on_admit(self, hit_blocks, prompt_len, request_id=None):
        """Metrics of one admission: ``hit_blocks`` cached blocks used
        against a ``prompt_len``-token prompt.  With the request ledger
        on, the request's timeline gets the cold/warm verdict and the
        hit tokens (the cache owns hit accounting, the engine timing)."""
        self._c_lookup_tokens.inc(int(prompt_len))
        if hit_blocks > 0:
            self._c_hits.inc()
            self._c_hit_tokens.inc(int(hit_blocks) * self.block_size)
        else:
            self._c_misses.inc()
        if _reqs._active and request_id is not None:
            _reqs._ledger.on_prefix(
                request_id, hit_tokens=int(hit_blocks) * self.block_size)

    # -- allocation / eviction ---------------------------------------------
    def _evict_one(self):
        """Drop the least recently used unreferenced leaf and return its
        pool block, or None.  Interior and referenced nodes are never
        taken: an interior node's children would lose their match path,
        and a referenced one is in use."""
        victim = None
        for node in self._nodes_by_block.values():
            if node.refs > 0 or node.children:
                continue
            if victim is None or node.last_used < victim.last_used:
                victim = node
        if victim is None:
            return None
        if self._arena is not None and \
                self._arena.ref_count(victim.block) != 1:
            raise RuntimeError(
                f"prefix cache: unreferenced block {victim.block} is still "
                f"shared by a slot ({self._arena.ref_count(victim.block)} "
                f"references)")
        del victim.parent.children[victim.key]
        del self._nodes_by_block[victim.block]
        self._c_evictions.inc()
        self._g_cached.set(self.cached_blocks)
        return victim.block

    def evictable_blocks(self) -> int:
        """How many blocks eviction could ever reclaim: a node only after
        its whole subtree, so a referenced node shields its ancestors.
        The paged engine's allocation feasibility check counts these as
        available."""

        def sub(node):
            total, whole = 0, True
            for c in node.children.values():
                ev, w = sub(c)
                total += ev
                whole = whole and w
            if whole and node.refs == 0:
                return total + 1, True
            return total, False

        return sum(sub(c)[0] for c in self._root.children.values())

    def _alloc(self):
        if self._free:
            return self._free.pop()
        return self._evict_one()

    # -- device copies, engine-driven --------------------------------------
    def copy_into_row(self, blocks, width):
        """A (L, 1, H, width, D) cache row (int8: pairs) holding the
        cached ``blocks`` (pool block ids) at positions [0, len(blocks) *
        B), zeros past: out of the paged arena in arena mode, else out of
        the cache's pool."""
        if self._arena is not None:
            pool_k, pool_v = self._arena.pool_k, self._arena.pool_v
        else:
            if _faults._armed:
                _faults.check("serve.prefix_copy")
            pool_k, pool_v = self._pool_k, self._pool_v
        return (gather_blocks(pool_k, blocks, width),
                gather_blocks(pool_v, blocks, width))

    def adopt_blocks(self, tokens, blocks, n_goal):
        """Zero-copy donation (arena mode): insert nodes that take over a
        retiring slot's blocks, ``blocks[j]`` holding the canonical K/V of
        token block ``j`` of ``tokens``.  A block that already has a node
        keeps the tree's block (the caller frees the slot's duplicate, or
        drops its reference to a shared one).  Never allocates, so it
        cannot fail under pressure.  Returns the path covering ``n_goal``
        blocks."""
        keys = self._block_keys(tokens)[:n_goal]
        tick = next(self._tick)
        path, node = [], self._root
        for j, key in enumerate(keys):
            child = node.children.get(key)
            if child is None:
                child = _Node(key, node, blocks[j], tick)
                node.children[key] = child
                self._nodes_by_block[blocks[j]] = child
            child.last_used = tick
            path.append(child)
            node = child
        self._g_cached.set(self.cached_blocks)
        return path

    def plan_donation(self, tokens, n_blocks):
        """The tree half of a slot-arena donation: insert the missing
        nodes of the first ``n_blocks`` full blocks of ``tokens``, each
        on a pool block of its own.  Under pressure the donation stops at
        the first block it cannot place (a stored path is a contiguous
        prefix), counted in ``donate_skipped``, never raised.  Returns
        ``(path, placed)``: the path now cached, and the (lane, block)
        pairs whose bytes :meth:`write_blocks` must copy out of the
        (canonical) cache row.  Arena mode donates by
        :meth:`adopt_blocks` instead."""
        if self._arena is not None:
            raise RuntimeError("plan_donation on an arena-backed prefix "
                               "cache: paged engines donate by adoption "
                               "(adopt_blocks)")
        if _faults._armed:
            _faults.check("serve.prefix_copy")
        keys = self._block_keys(tokens)[:n_blocks]
        tick = next(self._tick)
        path, new_nodes = [], []
        node = self._root
        try:
            for j, key in enumerate(keys):
                child = node.children.get(key)
                if child is None:
                    block = self._alloc()
                    if block is None:
                        self._c_donate_skipped.inc(len(keys) - j)
                        break
                    child = _Node(key, node, block, tick)
                    node.children[key] = child
                    self._nodes_by_block[block] = child
                    new_nodes.append((j, child))
                # held while the path grows: a later allocation of this
                # donation must not evict its own ancestors
                child.refs += 1
                child.last_used = tick
                path.append(child)
                node = child
            self._g_cached.set(self.cached_blocks)
        finally:
            for n in path:
                n.refs -= 1
        return path, [(j, child.block) for j, child in new_nodes]

    def write_blocks(self, kc_row, vc_row, placed):
        """Copy lanes ``j`` of a (canonical) cache row (L, 1, H, W, D)
        into pool blocks, for each (j, block) of ``placed``."""
        B = self.block_size
        for pool, row in ((self._pool_k, kc_row), (self._pool_v, vc_row)):
            for leaf, r in zip(_leaves(pool), _leaves(row)):
                for j, block in placed:
                    leaf[:, block] = r[:, 0, :, j * B:(j + 1) * B]

    # -- lifecycle / reporting ---------------------------------------------
    def unregister(self):
        """Drop the metrics and the cache's pool (the engine's
        ``close()``; in arena mode the pool is the arena's)."""
        self._registry.remove(*self._registered)
        self._pool_k = self._pool_v = None

    def snapshot(self) -> dict:
        lookup = self._c_lookup_tokens.value
        return {
            "block_size": self.block_size,
            "capacity_blocks": self.num_blocks,
            "cached_blocks": self.cached_blocks,
            "hits": self._c_hits.value,
            "misses": self._c_misses.value,
            "evictions": self._c_evictions.value,
            "hit_tokens": self._c_hit_tokens.value,
            "lookup_tokens": lookup,
            "donate_skipped": self._c_donate_skipped.value,
            "hit_rate_tokens": (self._c_hit_tokens.value / lookup
                                if lookup else 0.0),
        }
