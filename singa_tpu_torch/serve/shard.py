"""Sharded serving's process model: one controller, worker ranks that
mirror it (``serve/tp.py``, ``serve/ep.py`` and ``serve/pp.py`` plug
their executors in here).

The JAX package serves a sharded engine from one process: its executors
run each dispatch as a ``shard_map`` twin over a device mesh, and the
host side sees a single logical engine (``singa_tpu/serve/tp.py``).  The
port runs one process per rank over a ``torch.distributed`` group, as
its training does, and keeps that promise this way:

* **rank 0 is the controller.**  It runs the whole engine: scheduler,
  block tables, radix tree, swap bookkeeping, request ledger and stats.
  Every device operation of the engine is a method of its device layer
  (``engine._Device``) that takes host values only (block ids, slot
  indices, token arrays, staged decode inputs);
* **the other ranks run** :func:`worker_loop`.  Building a sharded
  engine on rank 0 sends them its arguments and ships them the decode
  weights (:func:`announce`); each builds a *mirror* engine over its own
  shard, and then, for every device-layer call of the controller, the
  controller first sends the call's name and host arguments over a small
  gloo control group (:class:`Mirror`), and every rank runs the same
  method on its own shard.  The collectives inside the method (the
  row-parallel all-reduces, the expert all-reduce, the stage hops, the
  swap gathers) travel over the device group, the whole process group;
* **captured steps**: a decode width's first step runs eagerly on every
  rank and each then captures its own graph with its collectives inside
  (NCCL), so every later step is one replay a rank, in lockstep.  Gloo
  moves CUDA tensors through the host and cannot be captured: a sharded
  engine on the card over gloo with ``capture=True`` raises
  (``capture=False`` runs it eagerly).

**A fleet of sharded replicas** (``ServeFleet(tp=|ep=|pp=, replicas=R)``,
``fleet_configs``): rank 0 holds the first shard of every replica, as
the JAX package's single controller holds every device; replica ``i``'s
other ``S - 1`` shards are ranks ``1 + i(S - 1) ...``, so the process
group has ``1 + R(S - 1)`` ranks.  Each replica is a :class:`RankGroup`:
its own gloo control group, its own device group (and a group for each
mesh line inside it), and a card for each of its shards
(:func:`fleet_layout`).  Rank 0 sends the layout to every worker
(:func:`join_fleet`: every rank makes every group, in one order), each
worker then serves its replica's control group until the fleet leaves.
Such a fleet runs over gloo, on the CPU or on one card: on more cards
rank 0 would drive a card of every replica from one process, and over
NCCL that layout has hung (``ROADMAP.md`` Queue A item 1), so
:func:`fleet_configs` refuses it with :class:`FleetLayoutError`.

A refusal of a configuration raises on rank 0 before anything is sent.
A fault injected at the executor's site (``serve.tp_collective``,
``serve.ep_dispatch``, ``serve.pp_boundary``) raises on the controller
before a call is sent, so the workers are never left inside a
collective; the engine fails typed, and ``EngineSupervisor`` closes it
(the workers drop their mirror) and builds a new one (the workers build
a new mirror).  ``stop_workers()`` on rank 0 ends the worker loops.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..models.gpt2_decode import extract_params
from ..parallel.communicator import group_all_gather, group_broadcast
from ..resilience import faults as _faults

__all__ = ["worker_loop", "stop_workers", "Mirror", "ShardedExec",
           "check_sharded", "make_executor", "RankGroup", "fleet_configs",
           "fleet_layout", "join_fleet", "leave_fleet", "rank_group",
           "FleetLayoutError"]

_ctrl = None
#: the rank groups of the sharded fleet replicas this process serves in,
#: by their ranks (:func:`join_fleet`)
_fleet_groups = {}


def _control():
    """The gloo group the controller's messages travel in (made once a
    process, by every rank in the same place: the first sharded engine on
    rank 0, :func:`worker_loop` elsewhere)."""
    global _ctrl
    if _ctrl is None:
        _ctrl = dist.new_group(backend="gloo")
    return _ctrl


def _send(msg, ctrl=None):
    dist.broadcast_object_list([msg], src=0, group=ctrl or _control())


def _recv(ctrl=None):
    box = [None]
    dist.broadcast_object_list(box, src=0, group=ctrl or _control())
    return box[0]


class RankGroup:
    """The ranks one sharded engine runs on, global rank 0 (the
    controller) first: ``ctrl``, the gloo group its controller's messages
    travel in; ``dev``, the group of its collectives over all its ranks
    (None: the whole process group); ``lines``, the groups of the mesh
    lines over part of its ranks, by their rank sets; ``device``, where
    this process holds its shard (None: the model's device on rank 0, the
    rank's local card elsewhere)."""

    def __init__(self, ranks, ctrl=None, dev=None, lines=None, device=None):
        self.ranks = tuple(int(r) for r in ranks)
        self.ctrl = ctrl
        self.dev = dev
        self.lines = dict(lines or {})
        self.device = device

    def group_for(self, line):
        """The prepared group of ``line`` (ranks of one mesh axis line)."""
        key = frozenset(int(r) for r in line)
        if key == frozenset(self.ranks):
            return self.dev
        return self.lines[key]


def rank_group(ranks):
    """The :class:`RankGroup` of ``ranks`` (a config's ``devices``): a
    fleet replica's, or None for the whole process group."""
    if ranks is None:
        return None
    return _fleet_groups.get(tuple(int(r) for r in ranks))


def _mesh_lines(ranks, sizes):
    """Every line of ranks along each axis of a mesh of ``sizes`` over
    ``ranks`` (row-major), longer than one rank and shorter than all."""
    grid = np.asarray(ranks).reshape(sizes)
    out = []
    for ax in range(len(sizes)):
        if sizes[ax] in (1, len(ranks)):
            continue
        moved = np.moveaxis(grid, ax, -1).reshape(-1, sizes[ax])
        out += [tuple(int(r) for r in line) for line in moved]
    return out


class FleetLayoutError(NotImplementedError):
    """A sharded fleet in a layout that has not run to its end: over NCCL,
    or with the model on one of several cards (rank 0 would drive a card
    of every replica)."""


def fleet_configs(kind, config, replicas, cuda):
    """Rank 0 of a fleet of ``replicas`` sharded engines (``kind``:
    ``"tp"``, ``"ep"`` or ``"pp"``; ``config`` its coerced config with
    ``size`` shards): checks that the process group holds them, sends the
    layout to every worker, makes every replica's groups
    (:func:`join_fleet`) and returns each replica's config, its
    ``devices`` set to the replica's ranks.  ``cuda``: the model is on
    the card, which must then be the only one visible."""
    import dataclasses

    size, sizes = _mesh_size(kind, config)
    world = dist.get_world_size() if dist.is_initialized() else 1
    need = 1 + replicas * (size - 1)
    if need > world:
        if kind == "ep":
            what = (f"(ep x tp) x replicas ({config.ep} x {config.tp} x "
                    f"{replicas} = {size * replicas})")
        else:
            what = (f"{'tp' if kind == 'tp' else 'stages'} x replicas "
                    f"({size} x {replicas} = {size * replicas})")
        raise ValueError(
            f"{what} exceeds the {world}-rank process group: rank 0 holds "
            f"every replica's first shard, so the fleet needs 1 + "
            f"{replicas} x {size - 1} = {need} ranks; shrink the fleet or "
            f"the shard count, or start {need} processes")
    cards = torch.cuda.device_count() if cuda else 0
    if dist.get_backend() == "nccl" or cards > 1:
        raise FleetLayoutError(
            f"a sharded fleet runs over gloo on the CPU or on one card "
            f"(here: backend {dist.get_backend()!r}, {cards} cards): rank "
            f"0 holds every replica's first shard, and with a card a "
            f"replica it would drive {min(replicas, max(cards, 1))} cards "
            f"from one process, which has hung over NCCL (ROADMAP.md "
            f"Queue A item 1); start the ranks with backend='gloo' and one "
            f"visible card (CUDA_VISIBLE_DEVICES), capture=False")
    layout = fleet_layout(sizes, replicas, cards)
    _send(("fleet", layout))
    join_fleet(layout)
    return [dataclasses.replace(config, devices=ranks)
            for ranks, _, _ in layout]


def fleet_layout(sizes, replicas, cards):
    """``(ranks, mesh sizes, card of each shard)`` of each replica of a
    sharded fleet: rank 0 and ``S - 1`` ranks of its own, shard ``j`` of
    replica ``i`` on card ``(i S + j) mod cards`` (None for each with no
    card: the CPU).  :func:`fleet_configs` serves it with at most one
    card."""
    size = int(np.prod(sizes))
    out = []
    for i in range(replicas):
        ranks = (0,) + tuple(1 + i * (size - 1) + j
                             for j in range(size - 1))
        devs = [(i * size + j) % cards if cards else None
                for j in range(size)]
        out.append((ranks, tuple(sizes), devs))
    return out


def join_fleet(layout):
    """Every rank, in one order: make each replica's control, device and
    mesh-line groups, and keep the groups of the replicas this rank is in
    (``layout``: ``(ranks, mesh sizes, card of each shard or None)`` a
    replica).  Returns this rank's replica group, or None on rank 0 and
    on a rank in none."""
    me = dist.get_rank()
    mine = None
    for ranks, sizes, devs in layout:
        card = devs[ranks.index(me)] if me in ranks else None
        ctrl = dist.new_group(list(ranks), backend="gloo")
        dev = dist.new_group(list(ranks))
        lines = {frozenset(line): dist.new_group(list(line))
                 for line in _mesh_lines(ranks, sizes)}
        if me not in ranks:
            continue
        rg = RankGroup(ranks, ctrl, dev, lines,
                       None if card is None else torch.device("cuda", card))
        _fleet_groups[rg.ranks] = rg
        if me != 0:
            mine = rg
    return mine


def leave_fleet(configs):
    """Rank 0: end the fleet replicas' worker loops (each worker goes back
    to serving the whole group's controller) and forget their groups."""
    for config in configs:
        rg = _fleet_groups.pop(tuple(config.devices))
        _send(("leave",), rg.ctrl)


def _mesh_size(kind, config):
    """(shard count, mesh sizes) of a sharded config."""
    if kind == "tp":
        return config.tp, (config.tp,)
    if kind == "ep":
        return config.ep * config.tp, (config.ep, config.tp)
    return config.stages, (config.stages,)


# -- the weights the controller ships -------------------------------------


class _Shipped:
    """A mirror engine's model: the configuration and the decode weights
    the controller shipped (``extract_params`` layout, already cast)."""

    plan = None

    def __init__(self, cfg, params):
        self.cfg = cfg
        self.params = params

    def eval(self):
        return self


def is_mirror(model):
    return isinstance(model, _Shipped)


def decode_params(model, dtype):
    """The model's decode weights: shipped ones for a mirror."""
    if isinstance(model, _Shipped):
        return model.params
    return extract_params(model, dtype=dtype)


def _skeleton(params):
    """The shipped pytree's leaves in order: ``(path, shape, dtype)`` of a
    tensor, ``(path, None, value)`` of anything else."""
    out = []
    for k, v in params.items():
        if k == "blocks":
            for i, blk in enumerate(v):
                for bk, bv in blk.items():
                    out.append(((k, i, bk),) + _leaf(bv))
        else:
            out.append(((k,),) + _leaf(v))
    return out


def _leaf(v):
    if isinstance(v, torch.Tensor):
        return (tuple(v.shape), v.dtype)
    return (None, v)


def _ship(params, group=None):
    for t in _tensors(params):
        group_broadcast(t.contiguous(), 0, group, op="serve_ship")


def _tensors(params):
    for k, v in params.items():
        if k == "blocks":
            for blk in v:
                for bv in blk.values():
                    if isinstance(bv, torch.Tensor):
                        yield bv
        elif isinstance(v, torch.Tensor):
            yield v


def _receive(skeleton, device, group=None):
    params = {"blocks": []}
    for path, shape, dt in skeleton:
        if shape is None:
            val = dt
        else:
            val = group_broadcast(torch.empty(shape, dtype=dt,
                                              device=device), 0, group,
                                  op="serve_ship")
        if path[0] == "blocks":
            while len(params["blocks"]) <= path[1]:
                params["blocks"].append({})
            params["blocks"][path[1]][path[2]] = val
        else:
            params[path[0]] = val
    return params


def _group_of(sharded):
    """The rank group of a checked ``(kind, config)``, or None."""
    return rank_group(getattr(sharded[1], "devices", None))


def announce(sharded, model, draft_model, dtype, kwargs):
    """Rank 0 building a sharded engine: send the workers its arguments
    and ship them the decode weights (target and draft), which they build
    their mirrors from (over the replica's groups in a fleet)."""
    rg = _group_of(sharded)
    ctrl, group = (None, None) if rg is None else (rg.ctrl, rg.dev)
    params = extract_params(model, dtype=dtype)
    d_params = (None if draft_model is None
                else extract_params(draft_model, dtype=dtype))
    dev = params["wte"].device
    _send(("build", dict(
        cfg=model.cfg, kwargs=kwargs, skeleton=_skeleton(params),
        draft=(None if draft_model is None else
               (draft_model.cfg, _skeleton(d_params))),
        cuda=dev.type == "cuda")), ctrl)
    _ship(params, group)
    if d_params is not None:
        _ship(d_params, group)


def _worker_device(cuda, rg):
    if not cuda:
        return torch.device("cpu")
    if rg is not None and rg.device is not None:
        return rg.device
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())


def _build_mirror(spec, rg=None):
    from .engine import InferenceEngine

    dev = _worker_device(spec["cuda"], rg)
    group = None if rg is None else rg.dev
    params = _receive(spec["skeleton"], dev, group)
    draft = None
    if spec["draft"] is not None:
        dcfg, dskel = spec["draft"]
        draft = _Shipped(dcfg, _receive(dskel, dev, group))
    return InferenceEngine(_Shipped(spec["cfg"], params), draft_model=draft,
                           **spec["kwargs"])


def worker_loop(on_close=None):
    """A worker rank's serve loop: build the mirror of each sharded
    engine rank 0 builds, run the device-layer calls rank 0 sends on it,
    drop it when rank 0 closes the engine (``on_close(mirror)`` first,
    when given); in a fleet of sharded replicas, serve its replica's
    engines until the fleet leaves; return at :func:`stop_workers`.
    Every rank but 0 calls this after joining the process group
    (``parallel.communicator.initialize_distributed``)."""
    if dist.get_rank() == 0:
        raise RuntimeError("worker_loop() runs on ranks other than 0; rank "
                           "0 builds the engine (model.serve(tp=...))")
    with torch.no_grad():
        _serve(None, on_close)


def _serve(rg, on_close):
    """Run rank 0's messages on this rank's mirrors: the whole group's
    (``rg`` None) until ``stop``, a fleet replica's until ``leave``."""
    ctrl = None if rg is None else rg.ctrl
    eng = None
    while True:
        msg = _recv(ctrl)
        op = msg[0]
        if op == "call":
            getattr(eng._dev, msg[1])(*msg[2])
        elif op == "build":
            eng = _build_mirror(msg[1], rg)
        elif op == "close":
            if eng is not None:
                if on_close is not None:
                    on_close(eng)
                eng.close(force=True)
            eng = None
        elif op == "fleet" and rg is None:
            mine = join_fleet(msg[1])
            if mine is not None:
                _serve(mine, on_close)
                _fleet_groups.pop(mine.ranks, None)
        elif op in ("stop", "leave"):
            return
        else:
            raise RuntimeError(f"unknown controller message {op!r}")


def stop_workers():
    """Rank 0: end every worker's :func:`worker_loop`."""
    _send(("stop",))


class Mirror:
    """The controller's device layer: each call checks the executor's
    fault site and counts a sharded dispatch, sends its name and host
    arguments to the workers, then runs on rank 0's own shard."""

    def __init__(self, dev, executor):
        self._dev = dev
        self._x = executor

    def __getattr__(self, name):
        fn = getattr(self._dev, name)
        x = self._x
        ctrl = x.ctrl

        def call(*args):
            x.before_dispatch()
            _send(("call", name, args), ctrl)
            out = fn(*args)
            x.after_dispatch(name, args)
            return out

        call.__name__ = name
        return call


# -- the refusal matrix ----------------------------------------------------


def _active(tp, ep, pp):
    """The coerced configs of the knobs passed, ``None`` for an unset
    one."""
    from .ep import as_ep_config
    from .pp import as_pp_config
    from .tp import as_tp_config

    off = (None, False)
    return (None if tp in off else as_tp_config(tp),
            None if ep in off else as_ep_config(ep),
            None if pp in off else as_pp_config(pp))


def check_sharded(cfg, model, tp=None, ep=None, pp=None, paged=None,
                  prefix_cache=None, draft_model=None, window=None,
                  quant=False, capture=True):
    """The JAX engine's refusal matrix of ``tp``/``ep``/``pp`` with its
    messages (``singa_tpu/serve/engine.py``), run before any metric
    registers; returns ``(kind, config)`` of the one active sharded
    executor, or None.  Also: the process group must hold exactly the
    executor's ranks (a fleet replica's: its rank group), and a gloo group
    on the card cannot capture."""
    from .ep import check_ep
    from .pp import check_pp
    from .tp import check_tp

    tp_c, ep_c, pp_c = _active(tp, ep, pp)
    plan = getattr(model, "plan", None)
    tp_on = tp_c is not None and tp_c.tp > 1
    if tp_on and tp_c.ring_prefill:
        if paged is None:
            raise ValueError(
                "ring_prefill requires paged= (the ring twin scatters "
                "narrow block-multiple rows; the slot arena's full-width "
                "write path is not wired)")
        if prefix_cache is not None and prefix_cache is not False:
            raise ValueError(
                "ring_prefill with a prefix_cache: ring attention reorders "
                "the float reduction, so its K/V is not byte-canonical "
                "with chunked prefill — donated blocks would poison the "
                "cache's warm==cold byte-identity contract")
        if window is not None:
            raise NotImplementedError(
                "ring_prefill on a sliding-window model is not implemented "
                "(the ring's causal skip has no banded variant here); "
                "windowed long prompts admit through the chunked-prefill "
                "budget instead")
        if quant:
            raise ValueError(
                "ring_prefill with cache_dtype='int8': the engine's int8 "
                "parity pin is byte equality with the offline oracle, "
                "which ring reduction reordering cannot keep through "
                "quantization bins; serve int8 without ring")
    ep_on = ep_c is not None and ep_c.ep * ep_c.tp > 1
    pp_on = pp_c is not None and pp_c.stages > 1
    if ep_on:
        if tp_on:
            raise ValueError(
                "ep= together with tp=: EPConfig carries the dense layers' "
                "tensor-parallel width itself — pass ep=EPConfig(ep=, tp=) "
                "and drop the bare tp= knob")
        if pp_on:
            raise ValueError(
                "ep= together with pp=: one sharded executor per engine — "
                "serve expert-parallel (ep=) or pipeline-parallel (pp=), "
                "not both")
        check_ep(ep_c, cfg, model_plan=plan, prefix_cache=prefix_cache)
        out, size = ("ep", ep_c), ep_c.ep * ep_c.tp
    elif pp_on:
        if tp_on:
            raise ValueError(
                "pp= together with tp=: one sharded executor per engine — "
                "interleaving tensor parallelism inside a stage is the "
                "documented next extension, not a supported composition")
        check_pp(pp_c, cfg, model_plan=plan, paged=paged,
                 draft_model=draft_model, window=window)
        out, size = ("pp", pp_c), pp_c.stages
    elif tp_on:
        check_tp(tp_c, cfg, model_plan=plan)
        out, size = ("tp", tp_c), tp_c.tp
    else:
        return None
    _check_group(out[0], size, model, capture,
                 rank_group(out[1].devices) is not None)
    return out


def _check_group(kind, size, model, capture, replica=False):
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != size and not replica:
        raise ValueError(
            f"a {kind} engine over {size} ranks needs a process group of "
            f"exactly {size} (have {world}): start {size} processes, call "
            f"parallel.communicator.initialize_distributed in each, build "
            f"the engine on rank 0 and run serve.shard.worker_loop() on the "
            f"others")
    if dist.get_rank() != 0 and not is_mirror(model):
        raise ValueError(
            f"a {kind} engine is built on rank 0 only; rank "
            f"{dist.get_rank()} runs serve.shard.worker_loop(), which "
            f"builds its mirror")
    if is_mirror(model):
        dev = model.params["wte"].device
    else:
        dev = model.transformer.wte.W.device
    if capture and dev.type == "cuda" and dist.get_backend() != "nccl":
        raise RuntimeError(
            f"a {kind} engine over {dist.get_backend()!r} cannot be "
            f"captured on the card (gloo moves CUDA tensors through the "
            f"host): build it with capture=False, or initialize_distributed "
            f"with backend='nccl'")


def make_executor(sharded, eng):
    """The executor of a checked ``(kind, config)`` for ``eng``."""
    kind, config = sharded
    if kind == "tp":
        from .tp import TPExecutor as cls
    elif kind == "ep":
        from .ep import EPExecutor as cls
    else:
        from .pp import PPExecutor as cls
    return cls(eng, config)


# -- the executors' common part --------------------------------------------


class ShardedExec:
    """What the tp, ep and pp executors share: the fault site and the
    dispatch counter the controller's :class:`Mirror` runs around each
    call, the per-shard KV bytes, the swap gathers over the KV axis, and
    the mirror's release at ``close()``.  A subclass sets ``kind``,
    ``site``, ``kv_dim`` (the KV leaves' sharded axis: 2, the heads, or
    0, the layers) and ``kv_group``/``kv_world`` (None/1: KV replicated),
    and mixes in ``engine._LocalExec``."""

    kind = site = None
    #: the rank group of a fleet replica (None: the whole process group)
    #: and the control group its messages go over
    group = ctrl = None
    kv_dim = 2
    kv_group = None
    kv_world = 1
    kv_rank = 0
    ring_min_tokens = None

    def _bind(self, config):
        """Take the rank group of ``config`` (a fleet replica's)."""
        self.group = rank_group(config.devices)
        self.ctrl = None if self.group is None else self.group.ctrl

    def before_dispatch(self):
        if _faults._armed:
            _faults.check(self.site)
        self._c_dispatch.inc()

    def after_dispatch(self, name, args):
        pass

    def account_kv(self):
        """Set the per-shard KV bytes gauge from the engine's arenas."""
        e = self._e
        trees = [e._kc, e._vc, e._dkc, e._dvc]
        if e.paged_arena is not None:
            trees += [e.paged_arena.pool_k, e.paged_arena.pool_v]
        cache = e.prefix_cache
        if cache is not None and getattr(cache, "_arena", None) is None:
            trees += [cache._pool_k, cache._pool_v]
        n = 0
        for t in trees:
            if t is None:
                continue
            for leaf in (t if isinstance(t, tuple) else (t,)):
                n += leaf.numel() * leaf.element_size()
        self.kv_bytes = n
        self._g_kv.set(n)

    # swap images: the whole row on every rank, a rank's slice back
    def gather_kv(self, row):
        if self.kv_world == 1:
            return row
        return group_all_gather(row, self.kv_group, self.kv_dim,
                                op="kv_gather")

    def slice_kv(self, row):
        if self.kv_world == 1:
            return row
        n = row.shape[self.kv_dim] // self.kv_world
        return row.narrow(self.kv_dim, self.kv_rank * n, n).contiguous()

    def kv_meta(self, pool):
        shape = list(pool.shape)
        shape[self.kv_dim] *= self.kv_world
        return torch.empty(shape, dtype=pool.dtype, device="meta")

    def capture_mode(self):
        return "thread_local"

    def close(self, dev):
        """The engine's close: the workers drop their mirror (rank 0's
        only), the metrics go."""
        if isinstance(dev, Mirror):
            _send(("close",), self.ctrl)
        self._registry.remove(*self._registered)

    def _register(self, reg, engine_label, gauges, counters):
        """Register ``{name: help}`` gauges and counters under
        ``serve.<kind>.`` with the engine label; returns them by name."""
        lbl = dict(engine=engine_label)
        out = {}
        for name, h in gauges.items():
            out[name] = reg.gauge(f"serve.{self.kind}.{name}", help=h, **lbl)
        for name, h in counters.items():
            out[name] = reg.counter(f"serve.{self.kind}.{name}", help=h,
                                    **lbl)
        self._registered = list(out.values())
        self._registry = reg
        return out

