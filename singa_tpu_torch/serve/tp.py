"""Tensor-parallel serving (counterpart of ``singa_tpu/serve/tp.py``):
one engine's weights and KV memory partitioned over ``tp`` ranks.

* **layout** (``parallel.tensor_parallel.decode_param_specs``): each
  rank holds its column slices of q/k/v and MLP fc1 and its row slices
  of the attention out-projection and MLP fc2, and the block dicts carry
  the ``tp`` group, so the decode functions close each row-parallel
  product with one all-reduce (``gpt2_decode._row_linear``: two a layer
  a step); embeddings, LayerNorms, the head, sampling and a speculative
  draft are replicated, so every rank computes the same tokens from the
  same post-reduction activations;
* **sharded KV**: each rank's arenas, pools, prefix-cache pool and cache
  rows hold its ``H_kv / tp`` heads, always axis 2
  (``decode_cache_spec``); block ids are global, so the controller's
  free list, block tables, radix tree and swap bookkeeping see one
  logical engine (``serve/shard.py``: rank 0 runs the engine, the other
  ranks mirror its device calls);
* **swap**: a preempted request's image gathers the head axis from every
  rank, so it is byte-compatible with the single-device engine's, and
  resuming cuts each rank's heads back out;
* **ring-attention prefill** (``TPConfig(ring_prefill=True)``): a cold
  admission of at least ``ring_min_tokens`` tokens prefills sequence
  sharded over the same ranks with a replicated copy of the weights,
  ``parallel.ring_attention.ring_self_attention(causal=True)`` on the
  flash kernels on the card (their plain versions on the CPU); the
  chunks' K/V and hidden rows are then gathered and each rank keeps its
  heads.

Every dispatch checks the ``serve.tp_collective`` fault site on the
controller.  Metrics: ``serve.tp.{shards, collectives_per_step,
kv_bytes_per_shard, sharded_dispatches, ring_prefills}{engine=}``,
``EngineStats.snapshot()["tp"]`` and ``health_report()["serve"]["tp"]``.
Parity: the all-reduce reorders the row-parallel sums, so logits agree
with the single-device engine to float addition order and token streams
are identical away from exact ties.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models import gpt2_decode as G
from ..parallel.sharding import TP as TP_AXIS
from ..parallel.sharding import create_tp_mesh
from ..parallel.tensor_parallel import shard_decode_params
from .engine import _LocalExec
from ..parallel.communicator import group_all_gather
from .shard import ShardedExec

__all__ = ["TPConfig", "TPExecutor", "as_tp_config", "check_tp"]


def _check_ranks(what, ranks, n):
    if ranks is not None and tuple(ranks) != tuple(range(n)):
        raise ValueError(
            f"{what}: ranks {tuple(ranks)} must be the process group's "
            f"ranks 0..{n - 1} (one engine a group: a sharded engine's "
            f"mesh is the whole group)")


@dataclass(frozen=True)
class TPConfig:
    """Knobs of the tensor-parallel backend (``model.serve(tp=...)``; a
    bare int is ``TPConfig(tp=k)``).

    ``tp``: the shard count (1: off).  ``devices``: the ranks, which must
    be the process group's ``0..tp-1`` (the JAX package's device tuple;
    a rank's card is its local one).  ``ring_prefill``: cold admissions
    of at least ``ring_min_tokens`` tokens prefill by ring attention over
    the same ranks (module docstring)."""

    tp: int = 2
    devices: tuple | None = None
    ring_prefill: bool = False
    ring_min_tokens: int = 256

    def __post_init__(self):
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {self.tp}")
        if self.devices is not None and len(self.devices) < self.tp:
            raise ValueError(
                f"TPConfig(tp={self.tp}) with only "
                f"{len(self.devices)} explicit devices")
        if self.ring_min_tokens < 0:
            raise ValueError(f"ring_min_tokens must be >= 0, got "
                             f"{self.ring_min_tokens}")


def as_tp_config(tp):
    """The ``tp=`` knob (an int, a kwargs dict or a TPConfig) as a
    TPConfig."""
    if isinstance(tp, TPConfig):
        return tp
    if isinstance(tp, int) and not isinstance(tp, bool):
        return TPConfig(tp=tp)
    if isinstance(tp, dict):
        return TPConfig(**tp)
    raise ValueError(
        f"tp must be an int shard count, a TPConfig, or a kwargs dict, "
        f"got {type(tp)}")


def check_tp(config, cfg, model_plan=None):
    """The tensor-parallel refusals, typed, before anything registers."""
    if model_plan is not None:
        raise ValueError(
            "tp= on a plan-sharded model: the training ShardingPlan "
            "already owns the weight layout; build the serve model without "
            "a plan and let the TP backend place the decode weights")
    if getattr(cfg, "moe_every", None) is not None:
        raise NotImplementedError(
            "tp= on an MoE model: expert weights shard over the expert "
            "axis, not the tensor-parallel axis — serve this model with "
            "model.serve(ep=EPConfig(ep=, tp=)) (singa_tpu_torch/serve/"
            "ep.py: expert-parallel decode with the dense layers on an "
            "orthogonal tp axis); bare tp= covers dense/GQA models")
    tp = int(config.tp)
    _check_ranks(f"TPConfig(tp={tp})", config.devices, tp)
    for what, n in (("n_head", cfg.n_head),
                    ("n_kv_head (H_kv)", cfg.n_kv_head),
                    ("n_inner", cfg.n_inner)):
        if n % tp != 0:
            raise ValueError(
                f"tp={tp} does not divide {what} ({n}): every shard must "
                f"own a whole number of heads/columns (and the KV arena "
                f"slice is (..., H_kv/tp, ...))")


class TPExecutor(ShardedExec, _LocalExec):
    """The engine's tensor-parallel executor: the ``tp`` mesh, the
    Megatron placement, the ring prefill and the ``serve.tp.*`` metrics.
    Its dispatch surface is ``engine._LocalExec``'s: the rank's weights
    carry the group, so the same functions run the rank's shard."""

    kind = "tp"
    site = "serve.tp_collective"

    def __init__(self, eng, config):
        _LocalExec.__init__(self, eng)
        cfg = eng.cfg
        self.config = config
        self.tp = int(config.tp)
        self.n_layer = int(cfg.n_layer)
        self.mesh = create_tp_mesh(self.tp,
                                   device=eng._params["wte"].device)
        self.axis = self.mesh.axis(TP_AXIS)
        self.kv_group = self.axis.group
        self.kv_world = self.tp
        self.kv_rank = self.axis.index
        self.kv_bytes = 0
        self._ring_params = None
        ring = bool(config.ring_prefill)
        self.ring_min_tokens = int(config.ring_min_tokens) if ring else None
        counters = {"sharded_dispatches": "device-layer calls the "
                    "controller sent to every shard (decode/spec/prefill/"
                    "copy/swap)"}
        if ring:
            counters["ring_prefills"] = ("cold admissions prefilled via "
                                         "ring attention (sequence sharded "
                                         "over the tp ranks)")
        m = self._register(eng.stats.registry, eng.stats.engine_label, {
            "shards": "tensor-parallel shard count of this engine's mesh",
            "collectives_per_step": "all-reduces one decode step issues (2 "
                                    "per layer: attention out-proj + MLP "
                                    "fc2)",
            "kv_bytes_per_shard": "persistent KV-cache bytes each shard "
                                  "holds (its H_kv/tp slice of every "
                                  "arena/pool this engine placed)"},
            counters)
        self._c_dispatch = m["sharded_dispatches"]
        self._c_ring = m.get("ring_prefills")
        self._g_kv = m["kv_bytes_per_shard"]
        m["shards"].set(self.tp)
        m["collectives_per_step"].set(2 * self.n_layer)

    # -- placement --------------------------------------------------------
    def place_params(self, params):
        """This rank's Megatron slices of the decode weights, each block
        carrying the ``tp`` group; the ring prefill keeps the whole
        weights too."""
        if self.ring_min_tokens is not None:
            self._ring_params = params
        out = shard_decode_params(params, self.mesh, axis=TP_AXIS)
        for blk in out["blocks"]:
            blk["tp"] = self.kv_group
        return out

    def kv_geometry(self, n_layer, n_kv_head):
        return n_layer, n_kv_head // self.tp

    # -- the ring prefill -------------------------------------------------
    def ring_prefill(self, ids, plen):
        """(1, V) logits at ``plen - 1`` and this rank's (L, 1, H_kv/tp,
        W, D) K/V rows of ``ids`` (1, W), W a multiple of tp: each rank
        embeds its W/tp positions and every layer runs causal ring
        attention with the whole weights; the chunks' hidden and K/V are
        then gathered over the ranks."""
        from ..parallel.ring_attention import ring_self_attention

        st = self._e._statics
        n_head, eps = st["n_head"], st["eps"]
        params = self._ring_params
        tp, r = self.tp, self.kv_rank
        w = ids.shape[1]
        s = w // tp
        pos = torch.arange(r * s, (r + 1) * s, device=ids.device)
        x = (params["wte"][ids[:, r * s:(r + 1) * s]]
             + params["wpe"][pos][None])
        flash = x.is_cuda
        ks, vs = [], []
        for p in params["blocks"]:
            h = G._ln(x, p["ln1_s"], p["ln1_b"], eps)
            q = G._linear(h, p["wq"], p["bq"])
            k = G._linear(h, p["wk"], p["bk"])
            v = G._linear(h, p["wv"], p["bv"])
            b, _, e = x.shape
            d = e // n_head
            n_kv = k.shape[-1] // d
            qh = q.reshape(b, s, n_head, d).transpose(1, 2).contiguous()
            kh = k.reshape(b, s, n_kv, d).transpose(1, 2).contiguous()
            vh = v.reshape(b, s, n_kv, d).transpose(1, 2).contiguous()
            krep, vrep = kh, vh
            if n_kv != n_head:
                # the ring rotates query-width K/V; the cache keeps the
                # narrow GQA heads
                krep = kh.repeat_interleave(n_head // n_kv, dim=1)
                vrep = vh.repeat_interleave(n_head // n_kv, dim=1)
            a = ring_self_attention(qh, krep, vrep, self.axis, causal=True,
                                    remat=False, use_flash=flash)
            a = a.transpose(1, 2).reshape(b, s, e).to(x.dtype)
            x = x + G._linear(a, p["wo"], p["bo"])
            x = x + G._mlp(G._ln(x, p["ln2_s"], p["ln2_b"], eps), p)
            ks.append(kh)
            vs.append(vh)
        x = G._ln(x, params["lnf_s"], params["lnf_b"], eps)
        hidden = group_all_gather(x, self.kv_group, 1, op="ring_gather")
        rows = []
        for c in (torch.stack(ks), torch.stack(vs)):   # (L, 1, H, s, D)
            full = group_all_gather(c, self.kv_group, 3,
                                    op="ring_gather")
            n = full.shape[2] // tp
            rows.append(full[:, :, r * n:(r + 1) * n].contiguous())
        logit = G._logits(hidden[:, plen - 1], params).float()
        return logit, rows[0], rows[1]

    def after_dispatch(self, name, args):
        if name == "ring_prefill":
            self._c_ring.inc()

    # -- reporting --------------------------------------------------------
    def snapshot(self) -> dict:
        out = {
            "shards": self.tp,
            "devices": list(self.axis.ranks),
            "collectives_per_step": 2 * self.n_layer,
            "kv_bytes_per_shard": self.kv_bytes,
            "sharded_dispatches": self._c_dispatch.value,
        }
        if self._c_ring is not None:
            out["ring_prefills"] = self._c_ring.value
        return out
