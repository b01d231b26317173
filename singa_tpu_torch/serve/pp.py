"""Pipeline-parallel serving (counterpart of ``singa_tpu/serve/pp.py``):
one engine's layers partitioned into stages over ``pp`` ranks.

* **placement**: stage ``s`` holds layers ``[s*L/P, (s+1)*L/P)`` of the
  decode weights (embeddings, final norm and head replicated) and the
  same layer slice of the paged block pool, ``(L/P, N + 1, H_kv, B,
  D)``, with global block ids, so the controller's free list, block
  tables, radix tree, preemption and request ledger run unchanged
  (``serve/shard.py``);
* **microbatched decode** (GPipe over the continuous batch): a step's
  ``w`` lanes split into ``M = gcd(microbatches, w)`` microbatches; each
  stage runs its layers on one microbatch after the other (``paged_attn``
  a layer over its pool slice), receiving the activations of each from
  the stage before and sending them on, so the stages overlap on
  different microbatches over ``M + P - 1`` ticks; the last stage takes
  the final norm and the head, samples every lane and broadcasts the
  tokens to the other stages;
* **prefill and chunk passes**: one wave, stage to stage (a single row
  has no microbatches to overlap); every stage keeps its layers' K/V, so
  the cache rows come out layer-sharded like the pool, and the last
  stage broadcasts the logits (a batched prefill) or the chunk's hidden
  rows;
* **parity**: layers run in the same order with the same kernels and a
  hop moves bytes only, so streams equal the single-device paged
  engine's;
* **swap**: images gather the layer axis from every stage, so they are
  byte-compatible with the single-device engine's.

Refused at construction, typed (``check_pp``): no ``paged=`` or not the
block kernel, a speculative draft, a sliding window, MoE models, a
plan-sharded model, ``stages`` not dividing ``n_layer``.  Every dispatch
checks the ``serve.pp_boundary`` fault site.  Metrics:
``serve.pp.{stages, microbatches, kv_bytes_per_stage,
sharded_dispatches, boundary_hops}{engine=}`` (hops: a decode step's
``M + P - 1`` ticks, a wave's ``P - 1`` transfers), the ``pp`` section
of ``EngineStats.snapshot()`` and ``health_report()["serve"]["pp"]``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..models import gpt2_decode as G
from ..parallel import communicator as _comm
from ..parallel.sharding import PP as PP_AXIS
from ..parallel.sharding import create_pp_mesh
from .engine import _LocalExec
from .paged import _embed
from .shard import ShardedExec
from .tp import _check_ranks

__all__ = ["PPConfig", "PPExecutor", "as_pp_config", "check_pp"]


@dataclass(frozen=True)
class PPConfig:
    """Knobs of the pipeline-parallel backend (``model.serve(pp=...)``; a
    bare int is ``PPConfig(stages=k)``).

    ``stages``: the pipeline depth (must divide ``n_layer``; 1: off).
    ``microbatches``: the decode microbatch count (default ``stages``),
    clamped a step to gcd(microbatches, step width).  ``devices``: the
    ranks, ``0..stages-1``."""

    stages: int = 2
    microbatches: int | None = None
    devices: tuple | None = None

    def __post_init__(self):
        if self.stages < 1:
            raise ValueError(f"stages must be >= 1, got {self.stages}")
        if self.microbatches is not None and self.microbatches < 1:
            raise ValueError(
                f"microbatches must be >= 1 (or None for one per stage), "
                f"got {self.microbatches}")
        if self.devices is not None and len(self.devices) < self.stages:
            raise ValueError(
                f"PPConfig(stages={self.stages}) with only "
                f"{len(self.devices)} explicit devices")

    @property
    def mb(self):
        return (self.stages if self.microbatches is None
                else int(self.microbatches))


def as_pp_config(pp):
    """The ``pp=`` knob (an int, a kwargs dict or a PPConfig) as a
    PPConfig."""
    if isinstance(pp, PPConfig):
        return pp
    if isinstance(pp, int) and not isinstance(pp, bool):
        return PPConfig(stages=pp)
    if isinstance(pp, dict):
        return PPConfig(**pp)
    raise ValueError(
        f"pp must be an int stage count, a PPConfig, or a kwargs dict, "
        f"got {type(pp)}")


def check_pp(config, cfg, model_plan=None, paged=None, draft_model=None,
             window=None):
    """The pipeline-parallel refusals, typed, before anything registers
    (the JAX package's ``check_pp``)."""
    if model_plan is not None:
        raise ValueError(
            "pp= on a plan-sharded model: the training ShardingPlan already "
            "owns the weight layout; build the serve model without a plan "
            "and let the PP backend place the decode weights")
    if getattr(cfg, "moe_every", None) is not None:
        raise ValueError(
            f"pp={config.stages} on an MoE model: MoE and dense blocks "
            f"carry different weight sets, so the layer stack cannot stack "
            f"into the stage-sharded (L, ...) arrays — serve MoE models "
            f"with ep=EPConfig(ep=, tp=) (singa_tpu_torch/serve/ep.py)")
    _check_ranks(f"PPConfig(stages={config.stages})", config.devices,
                 config.stages)
    if cfg.n_layer % config.stages != 0:
        raise ValueError(
            f"stages={config.stages} does not divide n_layer "
            f"({cfg.n_layer}): every stage must own a whole number of "
            f"layers (and the paged pool's layer axis slices the same way)")
    if paged is None or paged is False:
        raise ValueError(
            "pp= requires paged=: the pipeline's memory model IS the "
            "per-stage slice of the paged block pool; the slot arena has no "
            "stage split")
    kern = (paged.kernel if hasattr(paged, "kernel")
            else paged.get("kernel", "block")
            if isinstance(paged, dict) else "block")
    if kern != "block":
        raise ValueError(
            f"pp= requires PagedConfig(kernel='block'), got {kern!r}: the "
            f"stage bodies run the per-layer block-native kernel directly "
            f"over their pool slice — the gather oracle materializes full "
            f"rows no stage owns")
    if draft_model is not None:
        raise ValueError(
            f"pp= with a speculative draft: the draft's spec_k sequential "
            f"proposal scan would serialize every pipeline tick, and a "
            f"draft of mismatched depth "
            f"({getattr(draft_model.cfg, 'n_layer', '?')} layers vs "
            f"{config.stages} stages) cannot take the stage split at all; "
            f"serve speculative traffic on tp=/ep= engines")
    if window is not None:
        raise NotImplementedError(
            "pp= on a sliding-window model is not implemented (the windowed "
            "block-drop bookkeeping is untested against stage-sliced "
            "pools); serve windowed models with tp= or single-device paged "
            "engines")


class PPExecutor(ShardedExec, _LocalExec):
    """The engine's pipeline-parallel executor: the ``pp`` mesh, the
    stage placement, the stage waves and the microbatched decode, and
    the ``serve.pp.*`` metrics."""

    kind = "pp"
    site = "serve.pp_boundary"
    kv_dim = 0

    def __init__(self, eng, config):
        _LocalExec.__init__(self, eng)
        cfg = eng.cfg
        self.config = config
        self.stages = int(config.stages)
        self.microbatches = int(config.mb)
        self.n_layer = int(cfg.n_layer)
        self.mesh = create_pp_mesh(self.stages,
                                   device=eng._params["wte"].device)
        self.axis = self.mesh.axis(PP_AXIS)
        self.stage = self.axis.index
        self.last = self.stage == self.stages - 1
        self.kv_group, self.kv_world, self.kv_rank = (self.axis.group,
                                                      self.stages,
                                                      self.stage)
        self.kv_bytes = 0
        m = self._register(eng.stats.registry, eng.stats.engine_label, {
            "stages": "pipeline stage count (layers per stage = n_layer / "
                      "stages)",
            "microbatches": "decode microbatch count the GPipe schedule "
                            "splits each pool step's slot lanes into",
            "kv_bytes_per_stage": "persistent KV-cache bytes each stage "
                                  "holds (its L/stages layer slice of every "
                                  "pool this engine placed)"}, {
            "sharded_dispatches": "device-layer calls the controller sent "
                                  "to every stage",
            "boundary_hops": "pipeline ticks of the decode steps and "
                             "stage-to-stage transfers of the prefill "
                             "waves"})
        self._c_dispatch = m["sharded_dispatches"]
        self._c_hops = m["boundary_hops"]
        self._g_kv = m["kv_bytes_per_stage"]
        m["stages"].set(self.stages)
        m["microbatches"].set(self.microbatches)

    # -- placement --------------------------------------------------------
    def place_params(self, params):
        """The stage's layers; embeddings, final norm and head whole."""
        n = self.n_layer // self.stages
        out = dict(params)
        out["blocks"] = params["blocks"][self.stage * n:
                                         (self.stage + 1) * n]
        return out

    def kv_geometry(self, n_layer, n_kv_head):
        return n_layer // self.stages, n_kv_head

    # -- hops -------------------------------------------------------------
    def _hop_in(self, shape, dtype, device, tag):
        """The activations stage - 1 sent, or None on the first stage."""
        if self.stage == 0:
            return None
        buf = torch.empty(shape, dtype=dtype, device=device)
        _comm.exchange([], [(buf, self.axis.peer(-1), tag)], self.kv_group,
                       op="pp_hop")
        return buf

    def _hop_out(self, x, tag):
        if not self.last:
            _comm.exchange([(x.contiguous(), self.axis.peer(1), tag)], [],
                           self.kv_group, op="pp_hop")

    def _from_last(self, t, shape, dtype, device):
        """The last stage's ``t`` on every stage."""
        if not self.last:
            t = torch.empty(shape, dtype=dtype, device=device)
        return _comm.group_broadcast(t, self.axis.ranks[-1], self.kv_group,
                                     op="pp_tokens")

    # -- prefill waves ----------------------------------------------------
    def prefill_batch(self, params, ids):
        """The admission prefill wave: (R, V) float32 last-position logits
        on every stage, and this stage's (L/P, R, H_kv, P, D) K/V rows."""
        st = self._e._statics
        n_head, eps = st["n_head"], st["eps"]
        r, s = ids.shape
        dt = params["wte"].dtype
        x = self._hop_in((r, s, params["wte"].shape[1]), dt, ids.device, 0)
        if x is None:
            pos = torch.arange(s, device=ids.device)
            x = params["wte"][ids.long()] + params["wpe"][pos][None]
        ks, vs = [], []
        for p in params["blocks"]:
            x, k, v = G._block_prefill(x, p, n_head, eps)
            d = x.shape[-1] // n_head
            n_kv = k.shape[-1] // d
            ks.append(k.reshape(r, s, n_kv, d).transpose(1, 2))
            vs.append(v.reshape(r, s, n_kv, d).transpose(1, 2))
        self._hop_out(x, 0)
        kc, vc = torch.stack(ks), torch.stack(vs)
        if self._e._quant:
            kc, vc = G._quantize_kv(kc), G._quantize_kv(vc)
        logits = None
        if self.last:
            h = G._ln(x[:, -1], params["lnf_s"], params["lnf_b"], eps)
            logits = G._logits(h, params).float().contiguous()
        logits = self._from_last(logits, (r, params["wte"].shape[0]),
                                 torch.float32, ids.device)
        return logits, kc, vc

    def chunk_row(self, params, ids, kc_row, vc_row, off, chunk):
        """One block-width chunk pass as a wave; every stage gets the
        last stage's (1, chunk, E) final-LN hidden."""
        st = self._e._statics
        n_head, eps = st["n_head"], st["eps"]
        dt = params["wte"].dtype
        e = params["wte"].shape[1]
        x = self._hop_in((1, chunk, e), dt, ids.device, 0)
        if x is None:
            pos = torch.arange(off, off + chunk, device=ids.device)
            x = (params["wte"][ids[off:off + chunk]] + params["wpe"][pos])[
                None]
        for li, p in enumerate(params["blocks"]):
            x = G._block_chunk(x, p, G._cache_layer(kc_row, li),
                               G._cache_layer(vc_row, li), off, n_head, eps)
        self._hop_out(x, 0)
        h = None
        if self.last:
            h = G._ln(x, params["lnf_s"], params["lnf_b"], eps).contiguous()
        return self._from_last(h, (1, chunk, e), dt, ids.device)

    # -- the microbatched decode step ------------------------------------
    def paged_decode_step(self, params, pool_k, pool_v, inp, block,
                          kernel="block", n_rb=None):
        """The GPipe decode step over the lanes ``inp``: (w, V) logits on
        the last stage, None on the others."""
        st = self._e._statics
        n_head, eps = st["n_head"], st["eps"]
        w = inp["toks"].shape[0]
        m = math.gcd(self.microbatches, w)
        c = w // m
        e = params["wte"].shape[1]
        dt = params["wte"].dtype
        dev = inp["toks"].device
        live = inp["live"] != 0
        toks = torch.where(live, inp["toks"], 0)
        pos = torch.where(live, inp["pos"], 0)
        tables = inp["tables"]
        one = torch.ones((1, 1), dtype=torch.bool, device=dev)
        outs = []
        for j in range(m):
            lo, hi = j * c, (j + 1) * c
            p_c = pos[lo:hi]
            x = self._hop_in((c, 1, e), dt, dev, j)
            if x is None:
                x = _embed(params, toks[lo:hi], p_c)
            qp = p_c.long()[:, None]
            tb = tables[lo:hi]
            write_at = (tb.long().gather(1, qp // block), qp % block, one)
            for li, p in enumerate(params["blocks"]):
                x = G._block_paged(x, p, G._cache_layer(pool_k, li),
                                   G._cache_layer(pool_v, li), tb, p_c,
                                   n_head, eps, write_at, None)
            self._hop_out(x, j)
            if self.last:
                h = G._ln(x, params["lnf_s"], params["lnf_b"], eps)
                outs.append(G._logits(h, params)[:, 0])
        return torch.cat(outs) if self.last else None

    def finish_step(self, logits, sample, w, with_lp):
        """The last stage samples; the tokens (and log-probabilities) go
        to every stage."""
        dev = self._e._inputs.buf.device
        out = sample(logits) if self.last else None
        if with_lp:
            toks, lps = out if self.last else (None, None)
            return (self._from_last(toks, (w,), torch.int64, dev),
                    self._from_last(lps, (w,), torch.float32, dev))
        return self._from_last(out, (w,), torch.int64, dev)

    def after_dispatch(self, name, args):
        """Count the call's boundary hops (a replayed step runs no
        Python, so they are counted here, from the call)."""
        p = self.stages - 1
        if name == "decode":
            key = args[0]
            w = key[0] if isinstance(key, tuple) else key
            n = math.gcd(self.microbatches, int(w)) + p
        elif name in ("prefill_rows", "pf_chunk"):
            n = p
        elif name == "canon_blocks":
            n = p * max(0, args[3] - args[2])
        else:
            n = 0
        if n:
            self._c_hops.inc(n)

    def snapshot(self) -> dict:
        return {
            "stages": self.stages,
            "layers_per_stage": self.n_layer // self.stages,
            "microbatches": self.microbatches,
            "devices": list(self.axis.ranks),
            "kv_bytes_per_stage": self.kv_bytes,
            "sharded_dispatches": self._c_dispatch.value,
            "boundary_hops": self._c_hops.value,
        }
