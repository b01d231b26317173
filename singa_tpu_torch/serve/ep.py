"""Expert-parallel serving (counterpart of ``singa_tpu/serve/ep.py``):
one MoE engine's experts partitioned over ``ep`` ranks, its dense
layers Megatron-style over an orthogonal ``tp`` axis.

* **layout**: a 2-D ``(ep, tp)`` mesh (``parallel.sharding.
  create_ep_mesh``, rank ``e * tp + t``).  A MoE block's stacked expert
  weights shard on their leading axis over ``ep`` (each rank holds E/ep
  experts, replicated over ``tp``), the router replicates; the dense
  attention and MLP weights take serve/tp.py's column/row layout over
  ``tp`` (``decode_param_specs(ep_axis=)``);
* **the MoE FFN** (``gpt2_decode._moe_ffn_ep``): every rank routes every
  token (the activations are replicated), runs its resident experts
  through its columns of the capacity-bounded dispatch and combine
  one-hots, and one all-reduce over ``ep`` a MoE layer sums each token's
  top-k outputs.  ``capacity_factor=None`` (the default) is capacity =
  tokens: nothing drops and streams equal the single-device engine's
  away from float ties; a finite factor drops over-capacity assignments
  to the residual path, deterministically, counted in
  ``serve.ep.dropped_tokens``;
* **KV**: sharded over ``tp`` (axis 2, as tp.py) and replicated over
  ``ep``; swap images gather the heads over ``tp``.

The routed load accumulates on the device inside every step (the
captured ones too, a dead decode lane not counted) and folds into
``serve.ep.expert_tokens{expert=}`` / ``serve.ep.dropped_tokens`` after
each decode step and at ``snapshot()``; ``snapshot()`` (the ``ep``
section of ``EngineStats.snapshot()``) adds ``load_imbalance``, the
max/mean routed load.  Every dispatch checks the ``serve.ep_dispatch``
fault site.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.gpt2_decode import EPContext
from ..parallel.sharding import EP as EP_AXIS
from ..parallel.sharding import TP as TP_AXIS
from ..parallel.sharding import create_ep_mesh
from ..parallel.tensor_parallel import shard_decode_params
from .engine import _LocalExec
from .shard import ShardedExec
from .tp import _check_ranks

__all__ = ["EPConfig", "EPExecutor", "as_ep_config", "check_ep",
           "fleet_ep_configs"]


@dataclass(frozen=True)
class EPConfig:
    """Knobs of the expert-parallel backend (``model.serve(ep=...)``; a
    bare int is ``EPConfig(ep=k)``).

    ``ep``: expert shards (must divide ``moe_experts``).  ``tp``: the
    dense layers' tensor-parallel width (1: replicated).  The engine runs
    on ``ep * tp`` ranks.  ``devices``: those ranks, ``0..ep*tp-1``.
    ``capacity_factor``: GShard capacity per dispatch, ``C = ceil(top_k *
    tokens / E * capacity_factor)``; None (default) is capacity = tokens,
    drop-free (module docstring)."""

    ep: int = 2
    tp: int = 1
    devices: tuple | None = None
    capacity_factor: float | None = None

    def __post_init__(self):
        if self.ep < 1:
            raise ValueError(f"ep must be >= 1, got {self.ep}")
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {self.tp}")
        if self.devices is not None \
                and len(self.devices) < self.ep * self.tp:
            raise ValueError(
                f"EPConfig(ep={self.ep}, tp={self.tp}) with only "
                f"{len(self.devices)} explicit devices")
        if self.capacity_factor is not None and self.capacity_factor <= 0:
            raise ValueError(
                f"capacity_factor must be > 0 (or None for drop-free full "
                f"capacity), got {self.capacity_factor}")


def as_ep_config(ep):
    """The ``ep=`` knob (an int, a kwargs dict or an EPConfig) as an
    EPConfig."""
    if isinstance(ep, EPConfig):
        return ep
    if isinstance(ep, int) and not isinstance(ep, bool):
        return EPConfig(ep=ep)
    if isinstance(ep, dict):
        return EPConfig(**ep)
    raise ValueError(
        f"ep must be an int expert-shard count, an EPConfig, or a kwargs "
        f"dict, got {type(ep)}")


def fleet_ep_configs(ep, replicas, cuda=False):
    """Disjoint per-replica :class:`EPConfig`\\ s (the JAX package's
    ``fleet_ep_configs``): replica ``i`` is an ``ep*tp``-rank group of its
    own (``serve/shard.py``) — expert (and dense-tensor) parallelism
    inside each replica, data parallelism across them.  Raises when the
    process group cannot hold the groups."""
    from .shard import fleet_configs

    ep = as_ep_config(ep)
    if ep.ep * ep.tp == 1:
        return [ep] * replicas
    return fleet_configs("ep", ep, replicas, cuda)


def check_ep(config, cfg, model_plan=None, prefix_cache=None):
    """The expert-parallel refusals, typed, before anything registers
    (the JAX package's ``check_ep``)."""
    if model_plan is not None:
        raise ValueError(
            "ep= on a plan-sharded model: the training ShardingPlan "
            "already owns the weight layout; build the serve model without "
            "a plan and let the EP backend place the decode weights")
    if getattr(cfg, "moe_every", None) is None:
        raise ValueError(
            f"ep={config.ep} on a dense model (no MoE blocks): there is no "
            f"expert axis to shard — serve dense/GQA models with tp= "
            f"(serve/tp.py)")
    n_exp = int(cfg.moe_experts)
    if n_exp % config.ep != 0:
        raise ValueError(
            f"ep={config.ep} does not divide moe_experts ({n_exp}): every "
            f"shard must own a whole number of experts")
    for what, n in (("n_head", cfg.n_head),
                    ("n_kv_head (H_kv)", cfg.n_kv_head),
                    ("n_inner", cfg.n_inner)):
        if n % config.tp != 0:
            raise ValueError(
                f"EPConfig(tp={config.tp}) does not divide {what} ({n}): "
                f"the dense layers' Megatron layout needs a whole "
                f"head/column count per tp shard")
    if config.capacity_factor is not None and prefix_cache is not None \
            and prefix_cache is not False:
        raise ValueError(
            "ep with a finite capacity_factor AND a prefix_cache: "
            "capacity-bounded routing couples tokens within a dispatch "
            "group, so chunked prefill K/V is no longer canonical with full "
            "prefill and the cache's warm==cold byte-identity contract "
            "cannot hold; serve with capacity_factor=None (drop-free) or "
            "drop the cache")
    _check_ranks(f"EPConfig(ep={config.ep}, tp={config.tp})",
                 config.devices, config.ep * config.tp)


def _fold_ep_stats(counts, dropped, seen):
    """The routed load since the last fold: ``(new per-expert counts,
    new dropped, totals)`` from the device accumulators and the totals
    ``seen`` (E + 1,) already folded."""
    now = np.concatenate([counts.cpu().numpy(),
                          dropped.reshape(1).cpu().numpy()])
    delta = now - seen
    return delta[:-1], int(delta[-1]), now


class EPExecutor(ShardedExec, _LocalExec):
    """The engine's expert-parallel executor: the ``(ep, tp)`` mesh, the
    expert + Megatron placement, the routed-load accounting and the
    ``serve.ep.*`` metrics."""

    kind = "ep"
    site = "serve.ep_dispatch"

    def __init__(self, eng, config):
        _LocalExec.__init__(self, eng)
        cfg = eng.cfg
        self.config = config
        self.ep, self.tp = int(config.ep), int(config.tp)
        self.n_expert = int(cfg.moe_experts)
        self._cap = (None if config.capacity_factor is None
                     else float(config.capacity_factor))
        dev = eng._params["wte"].device
        self._bind(config)
        self.mesh = create_ep_mesh(self.ep, self.tp, device=dev,
                                   group=self.group)
        tp_ax, ep_ax = self.mesh.axis(TP_AXIS), self.mesh.axis(EP_AXIS)
        self._tp_group = tp_ax.group
        self.kv_group, self.kv_world, self.kv_rank = (tp_ax.group, self.tp,
                                                      tp_ax.index)
        self.ctx = EPContext(ep_ax.group, self.ep, ep_ax.index, self._cap,
                             self.n_expert, dev)
        self.kv_bytes = 0
        reg, lbl = eng.stats.registry, eng.stats.engine_label
        m = self._register(reg, lbl, {
            "shards": "expert-parallel shard count (experts per shard = "
                      "moe_experts / ep)",
            "dense_tp": "orthogonal tensor-parallel width of the dense "
                        "layers inside the (ep, tp) mesh",
            "kv_bytes_per_shard": "persistent KV-cache bytes each tp shard "
                                  "holds (the arena shards over tp only, "
                                  "replicated over ep)"}, {
            "sharded_dispatches": "device-layer calls the controller sent "
                                  "to every rank of the (ep, tp) mesh",
            "dropped_tokens": "top-k expert assignments capacity bounded "
                              "away (the token rides the residual path; "
                              "only a finite capacity_factor can drop)"})
        self._c_expert = [
            reg.counter("serve.ep.expert_tokens",
                        help="tokens routed to (and kept by) each expert — "
                             "the router load-balance signal",
                        expert=str(e), engine=lbl)
            for e in range(self.n_expert)]
        self._registered += self._c_expert
        self._c_dispatch = m["sharded_dispatches"]
        self._c_dropped = m["dropped_tokens"]
        self._g_kv = m["kv_bytes_per_shard"]
        m["shards"].set(self.ep)
        m["dense_tp"].set(self.tp)
        self.expert_tokens = np.zeros(self.n_expert, np.int64)
        self.dropped_tokens = 0
        self._seen = np.zeros(self.n_expert + 1, np.int64)

    # -- placement --------------------------------------------------------
    def place_params(self, params):
        """Expert weights over ``ep``, the dense ones over ``tp``; every
        block carries the ``tp`` group and the MoE ones the EP context."""
        out = shard_decode_params(params, self.mesh, axis=TP_AXIS,
                                  ep_axis=EP_AXIS)
        for blk in out["blocks"]:
            blk["tp"] = self._tp_group
            if "moe_wg" in blk:
                blk["ep"] = self.ctx
        return out

    def kv_geometry(self, n_layer, n_kv_head):
        return n_layer, n_kv_head // self.tp

    # -- decode steps: dead lanes route but are not counted ---------------
    def _live(self, fn, inp, *a, **kw):
        self.ctx.live = inp["live"]
        try:
            return fn(*a, **kw)
        finally:
            self.ctx.live = None

    def pool_decode_step(self, params, kc, vc, inp):
        return self._live(_LocalExec.pool_decode_step, inp, self, params,
                          kc, vc, inp)

    def paged_decode_step(self, params, pool_k, pool_v, inp, block,
                          kernel="block", n_rb=None):
        return self._live(_LocalExec.paged_decode_step, inp, self, params,
                          pool_k, pool_v, inp, block, kernel=kernel,
                          n_rb=n_rb)

    def spec_step(self, inp, n_rb=None):
        return self._live(_LocalExec.spec_step, inp, self, inp, n_rb)

    # -- the routed load --------------------------------------------------
    def _fold(self):
        cnt, drp, self._seen = _fold_ep_stats(self.ctx.counts,
                                              self.ctx.dropped, self._seen)
        self.expert_tokens += cnt
        for e, c in enumerate(cnt):
            if c:
                self._c_expert[e].inc(int(c))
        if drp:
            self.dropped_tokens += drp
            self._c_dropped.inc(drp)

    def after_dispatch(self, name, args):
        if name == "decode":
            self._fold()

    def snapshot(self) -> dict:
        self._fold()
        toks = self.expert_tokens
        total = int(toks.sum())
        return {
            "shards": self.ep,
            "dense_tp": self.tp,
            "experts": self.n_expert,
            "experts_per_shard": self.n_expert // self.ep,
            "capacity_factor": self._cap,
            "devices": list(range(self.ep * self.tp)),
            "kv_bytes_per_shard": self.kv_bytes,
            "sharded_dispatches": self._c_dispatch.value,
            "expert_tokens": [int(t) for t in toks],
            "dropped_tokens": self.dropped_tokens,
            # max/mean routed load: 1.0 is a balanced router, E/top_k a
            # total collapse onto one expert
            "load_imbalance": (float(toks.max() / (toks.mean() or 1.0))
                               if total else None),
        }
